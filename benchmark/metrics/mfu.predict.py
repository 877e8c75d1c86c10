"""mfu.predict: the whole predict's share of the card's float32 peak over
the window (`benchmark/flops.py` over 67 TFLOP/s)."""
from benchmark.readers import mfu


def read(ctx):
    return mfu(ctx, "predict")
