"""Multi-process set-up under torchrun (port of
mvsdet_tpu/parallel/multihost.py:19-67).

The JAX package reads `MVSDET_COORDINATOR` and calls
`jax.distributed.initialize`; here torchrun's environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`) says where each process stands, and
`torchrun --nnodes N --nproc_per_node P` takes the place of the
reference's `tools/dist_train.sh`:

    torchrun --standalone --nproc_per_node 2 -m mvsdet_torch.tools.train \\
        --synthetic 8 --data-parallel 2

The backend follows the layout, and is never a fallback taken on a
failure: NCCL where every local rank has a card of its own, gloo where
ranks share a card or run on the CPU (NCCL refuses two ranks on one
device).  Gloo takes CUDA tensors for `all_reduce`, `all_gather` and
`broadcast` by staging them through host memory.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from mvsdet_torch.parallel.mesh import Mesh, make_mesh

def backend_for(device, local_ranks: Optional[int] = None) -> str:
    """'nccl' when each of ``local_ranks`` (default: this host's
    processes, torchrun's `LOCAL_WORLD_SIZE`) has a card of its own, else
    'gloo' (ranks sharing a card, or the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    if local_ranks is None:
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def local_device(device="cuda") -> torch.device:
    """This process's device: `cuda:{LOCAL_RANK % cards}`, or the CPU
    where ``device`` asks for it.  Raises when CUDA is missing and the CPU
    was not asked for."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card; pass device='cpu' to run it on the CPU")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(device="cuda") -> Optional[str]:
    """Join the process group torchrun's environment describes, on the
    backend `backend_for` picks for ``device``, and return that backend.
    Returns None, doing nothing, in a process torchrun did not start (no
    `WORLD_SIZE`) or where the group exists already."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return None
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend_for(device)
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return backend


def make_global_mesh(data: int, view: int) -> Mesh:
    """The `(data, view)` mesh over every process of every host.
    torchrun numbers ranks host by host, and `make_mesh` puts a view
    group on consecutive ranks, so the view axis (the feature gather and
    the volume sum, once per step) stays within a host and the data axis
    (the gradient mean) spans hosts (multihost.py:42-55)."""
    return make_mesh(data, view)
