"""host_syncs.predict: host calls a predict that wait for the card (stream,
device and event synchronises; each device-to-host read holds one) inside
the program's spans."""
from benchmark.spans import SYNCS, calls_per_item


def read(ctx):
    return calls_per_item(ctx, "predict", SYNCS)
