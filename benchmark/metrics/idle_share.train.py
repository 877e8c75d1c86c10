"""idle_share.train: % of the traced stretch's wall time with no kernel on
the card."""
from benchmark.readers import idle_share


def read(ctx):
    return idle_share(ctx, "train")
