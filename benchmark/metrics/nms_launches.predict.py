"""nms_launches.predict: kernel launches a predict inside the
`mvsdet.nms` span."""
from benchmark.spans import LAUNCHES, calls_per_item


def read(ctx):
    return calls_per_item(ctx, "predict", LAUNCHES, ("mvsdet.nms",))
