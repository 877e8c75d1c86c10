"""The `(data, view)` layout of ranks (port of mvsdet_tpu/parallel/mesh.py).

JAX lays devices out in a `('data', 'view')` mesh: scenes over `data`
(the reference's DDP over scenes, SURVEY §2c), each scene's source views
over `view`.  Here the devices are ranks of the default process group,
laid out as ``rank = d * view + v``: a view group (the ranks of one data
row, which share a scene) is a run of consecutive ranks, so under torchrun
it stays on one host, and the data axis spreads across hosts, as
`multihost.make_global_mesh` lays devices out
(mvsdet_tpu/parallel/multihost.py:42-55).
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``data x view`` layout and its groups.

    ``view_group`` holds the ranks of this rank's data row (the views of
    one scene), ``data_group`` those of its view column (one rank per
    scene), ``world_group`` every rank.
    """

    data: int
    view: int
    rank: int
    data_index: int
    view_index: int
    view_group: dist.ProcessGroup
    data_group: dist.ProcessGroup
    world_group: dist.ProcessGroup


def layout(data: int, view: int) -> List[List[int]]:
    """The ranks of each data row: ``layout(d, v)[i][j] = i * v + j``."""
    return [[d * view + v for v in range(view)] for d in range(data)]


def make_mesh(data: int = 1, view: int = 1) -> Mesh:
    """This rank's `Mesh` over the initialised default process group.

    Every rank must call it, with the same arguments and in the same
    order relative to its other `dist.new_group` calls: each group is
    created on every rank.  Raises ValueError when ``data * view`` is not
    the world size.
    """
    if data < 1 or view < 1:
        raise ValueError(f"data and view must be positive, not {data}, "
                         f"{view}")
    world = dist.get_world_size()
    if data * view != world:
        raise ValueError(f"a {data} x {view} mesh needs {data * view} "
                         f"ranks, the world has {world}")
    rank = dist.get_rank()
    rows = layout(data, view)
    view_groups = [dist.new_group(row) for row in rows]
    data_groups = [dist.new_group([row[v] for row in rows])
                   for v in range(view)]
    d, v = divmod(rank, view)
    return Mesh(data=data, view=view, rank=rank, data_index=d, view_index=v,
                view_group=view_groups[d], data_group=data_groups[v],
                world_group=dist.group.WORLD)
