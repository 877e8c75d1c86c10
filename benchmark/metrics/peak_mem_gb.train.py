"""peak_mem_gb.train: the allocator's peak over the window, in GB."""
from benchmark.readers import peak_mem_gb


def read(ctx):
    return peak_mem_gb(ctx, "train")
