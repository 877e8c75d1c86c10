"""data_wait_ms.train: ms a step that `fit` waits for its next scene, staged on
its thread (the `fit.data_wait` span), over the traced steps after the
first."""
from benchmark.spans import wait_ms


def read(ctx):
    return wait_ms(ctx, "train", "fit.data_wait")
