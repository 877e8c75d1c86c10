# Frozen copy of mvsdet_torch/geometry/voxels.py at commit dafa6b3, for the benchmark's
# plain reference: it imports nothing of mvsdet_torch, and later changes
# to the program do not reach it.
"""Voxel-grid and depth-plane generation (port of
mvsdet_tpu/geometry/voxels.py; reference: mvsdet.py:222-226, 1316-1327)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def voxel_points(n_voxels: Sequence[int], voxel_size: Sequence[float],
                 origin: torch.Tensor) -> torch.Tensor:
    """Voxel-centre world coordinates, (3, nx, ny, nz) fp32.

    grid index * voxel_size + (origin - n_voxels/2 * voxel_size); the
    reference's centres sit at integer grid indices (corner-based).
    """
    device = origin.device
    nv = torch.tensor(n_voxels, dtype=torch.float32, device=device)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=device)
    origin = origin.to(torch.float32)
    grids = torch.meshgrid(
        *[torch.arange(n, dtype=torch.float32, device=device)
          for n in n_voxels], indexing="ij")
    pts = torch.stack(grids)
    new_origin = origin - nv / 2.0 * vs
    return pts * vs.reshape(3, 1, 1, 1) + new_origin.reshape(3, 1, 1, 1)


def multiscale_voxel_points(featmap_sizes: Sequence[Tuple[int, int, int]],
                            base_voxel_size: Sequence[float],
                            origin: torch.Tensor) -> List[torch.Tensor]:
    """Per-level head anchor points: level i uses voxel_size * 2**i
    (`NerfDetHead._get_points`, nerfdet_head.py:409-420).

    Returns:
      list of (Ni, 3) point arrays, one per level.
    """
    out = []
    for i, fs in enumerate(featmap_sizes):
        vs = [s * (2**i) for s in base_voxel_size]
        out.append(voxel_points(fs, vs, origin).reshape(3, -1).T)
    return out


def depth_plane_values(near: float, far: float, num_planes: int,
                       device=None) -> torch.Tensor:
    """D fronto-parallel sweep depths from ``near`` in steps of
    (far-near)/D, excluding ``far`` (mvsdet.py:222-226)."""
    interval = (far - near) / num_planes
    return near + interval * torch.arange(num_planes, dtype=torch.float32,
                                          device=device)
