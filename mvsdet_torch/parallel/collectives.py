"""Differentiable collectives: what `shard_map` gives the JAX step.

The JAX step runs its `shard_map` with ``check_vma=False``
(mvsdet_tpu/parallel/sharding.py:109), so the transposes of its
collectives are plain: `psum`'s is a psum of the cotangents and
`all_gather`'s a psum_scatter, each rank keeping the sum over ranks of
its own slice.  These `autograd.Function`s compute exactly those.  The
gather's backward is an `all_reduce` of the whole cotangent followed by
this rank's slice: that runs on gloo with CPU and CUDA tensors and on
NCCL alike, where gloo's `reduce_scatter` may not.

Every collective carries float32, as JAX's do
(mvsdet_tpu/models/mvsdet.py:294-296): a bf16 tensor is refused.
`torch.distributed.nn.functional` is not used: its gather's backward
and the averaging of DDP compute something other than the JAX step.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _float32(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"{what} carries float32, not {x.dtype}")
    return x.contiguous()


class _AllGatherViews(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.n = x.shape[0]
        size = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_gather_views(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated on axis 0 in rank order
    (`jax.lax.all_gather(x, axis, axis=0, tiled=True)`); backward sums the
    cotangents over the group and keeps this rank's slice."""
    return _AllGatherViews.apply(_float32(x, "all_gather_views"), group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (`jax.lax.psum`); backward sums the
    cotangents over the group."""
    return _Psum.apply(_float32(x, "psum"), group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group`` (`jax.lax.pmean`), for a tensor
    that takes no gradient."""
    y = _float32(x, "pmean").detach().clone()
    dist.all_reduce(y, group=group)
    return y.div_(dist.get_world_size(group))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each float32 tensor with its mean over ``group``, through
    one flattened all-reduce."""
    if not tensors:
        return
    flat = torch.cat([_float32(t, "all_reduce_mean_").reshape(-1)
                      for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
