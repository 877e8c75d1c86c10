"""Host-to-device input prefetching (port of mvsdet_tpu/data/prefetch.py).

The reference overlaps input preparation with device compute through
torch DataLoader worker processes (projects/NeRF-Det/configs/
mvsdet_res50_2x_low_res.py:83,107 ``num_workers``).  Here one background
thread prepares batch i+1 while the device runs step i: it pulls the host
batch (numpy), copies it into pinned memory and enqueues the copy to the
device without waiting, so a step's wall time approaches max(compute,
staging) rather than their sum.  One thread keeps the batch order and
the producer's random sequence deterministic.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


def stage_batch(batch: Dict[str, np.ndarray],
                device) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device``; to the card through pinned
    memory with non-blocking copies (the pinned buffers are held by the
    caching host allocator until their copies finish)."""
    device = torch.device(device)
    out = {}
    for key, value in batch.items():
        t = torch.as_tensor(value)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[key] = t
    return out


def prefetch_iterator(it: Iterable, device) -> Iterator:
    """Yields ``it``'s items in order, each staged on ``device`` by
    `stage_batch` one ahead on a background thread; stops at the end of
    ``it``."""
    pool = ThreadPoolExecutor(max_workers=1)
    src = iter(it)
    sentinel = object()

    def pull():
        item = next(src, sentinel)
        return item if item is sentinel else stage_batch(item, device)

    try:
        pending = pool.submit(pull)
        while True:
            item = pending.result()
            if item is sentinel:
                break
            pending = pool.submit(pull)
            yield item
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
