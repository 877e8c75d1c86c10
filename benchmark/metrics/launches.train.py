"""launches.train: kernel launches a step inside the program's spans, from the
traced stretch's runtime calls."""
from benchmark.spans import LAUNCHES, calls_per_item


def read(ctx):
    return calls_per_item(ctx, "train", LAUNCHES)
