"""What the modes (`benchmark/modes/<mode>.py`) share: the record of one
run, progress lines, and the card's synchronise, peak and free.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, List

import torch


def log(what: str, **fields) -> None:
    """A progress line on standard error."""
    print(f"benchmark: {what} " + " ".join(f"{k}={v}" for k, v in
                                           fields.items()),
          file=sys.stderr, flush=True)


def views(cfg, traffic) -> tuple:
    """(source views, render targets) of the traffic's view set."""
    d = cfg.data
    if traffic["views"] == "train":
        return d.n_src_train, d.nerf_target_views_train
    return d.n_src_test, d.nerf_target_views_test


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if on_card(device):
        torch.cuda.synchronize()


def peak(device) -> int:
    return torch.cuda.max_memory_allocated() if on_card(device) else 0


def reset_peak(device) -> None:
    if on_card(device):
        torch.cuda.reset_peak_memory_stats()


def free(device) -> None:
    gc.collect()
    if on_card(device):
        torch.cuda.empty_cache()


class Run:
    """What one run measured, for the result line and the readers.

    `end_to_end` maps each end-to-end metric the mode reports (all but
    `setup_s`, which the harness takes) to (value, unit); `ctx` is what
    the per-layer readers get (`benchmark/readers.py`); `numbers` are the
    output check's numbers, `detail` where they come from."""

    def __init__(self):
        self.window_s = 0.0
        self.items = 0
        self.failed = 0
        self.latencies_s: List[float] = []
        self.peak_bytes = 0
        self.window_peak_bytes = 0
        self.end_to_end: Dict[str, tuple] = {}
        self.ctx: Dict = {}
        self.numbers: Dict[str, float] = {}
        self.detail: Dict = {}
