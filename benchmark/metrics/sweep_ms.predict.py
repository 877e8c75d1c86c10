"""sweep_ms.predict: device ms a predict of the kernels launched inside the
`mvsdet.sweep` span (the plane sweep and CostRegNet)."""
from benchmark.spans import device_ms_per_item


def read(ctx):
    return device_ms_per_item(ctx, "predict", "mvsdet.sweep")
