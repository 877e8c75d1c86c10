"""nms_ms.predict: the NMS's median device span over the traced
predicts, between two CUDA events around it."""
from benchmark.readers import nms_ms


def read(ctx):
    return nms_ms(ctx)
