"""data_wait_ms.predict: ms a scene that `evaluate_scenes` waits for its
next scene, staged on its thread (the `evaluate.data_wait` span), over
the traced scenes after the first."""
from benchmark.spans import wait_ms


def read(ctx):
    return wait_ms(ctx, "predict", "evaluate.data_wait")
