"""Shared fixtures of the benchmark's CPU tests: the cells' small sizes.

The tests run from the root of a checkout (`python -m pytest
benchmark/tests`).  The benchmark's cells run at published widths on the
card; here each runs at `tiny_test_config()`'s sizes, which keep every
code path (ARKit's with its head and near/far range), on the CPU.
"""

from __future__ import annotations

import dataclasses
import json

import pytest


def tiny_values(arkit: bool = False) -> dict:
    """`tiny_test_config()` as a configuration file's `config` object;
    with ``arkit`` the ARKit head and depth range on it."""
    from mvsdet_torch.config import tiny_test_config
    values = json.loads(json.dumps(dataclasses.asdict(tiny_test_config())))
    if arkit:
        values["model"]["head"].update(n_classes=17, n_reg_outs=7,
                                       with_yaw=True)
        values["model"]["near_far_range"] = [0.5, 5.5]
    return values


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    yield
    torch.set_num_threads(threads)
