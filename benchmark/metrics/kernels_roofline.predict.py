"""kernels_roofline.predict: the port kernels' least times
(`benchmark/bounds.py`) over their device times in the traced stretch."""
from benchmark.readers import kernels_roofline


def read(ctx):
    return kernels_roofline(ctx, "predict")
