"""The data x view sharded training step (port of
mvsdet_tpu/parallel/sharding.py:33-115).

Each rank holds a full replica of the model.  The ranks of a data row
share one scene: each stages only its slice of the view-indexed arrays
(`shard_batch`), and the model gathers features and sums the lifted
volume over the row's view group (`MVSDet.extract_feat`).  The data
groups' scenes differ, and the head loss averages their positive counts.
In the order of `per_device` (sharding.py:74-104), a step runs forward
and backward; the mean of the gradients over all ranks (the JAX step's
pmean over `data`, then over `view`), as one flattened all-reduce; the
mean of the trained BatchNorm running statistics over all ranks
(sharding.py:92-93: each shard's running statistics averaged, not a
BatchNorm over the combined batch as `SyncBatchNorm` would compute); the
loss and its terms averaged over the data group; then the update of
`training/optim.py` (`apply_gradients`), whose clip sees the averaged
gradients, as `tx.update` does.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from mvsdet_torch.models.layers import BatchNorm
from mvsdet_torch.models.mvsdet import DEPTH_SUPERVISION_SHARDED
from mvsdet_torch.parallel.collectives import all_reduce_mean_, pmean
from mvsdet_torch.parallel.mesh import Mesh
from mvsdet_torch.training.optim import apply_gradients

# arrays whose axis 0 is the view axis (sharding.py:33)
VIEW_SHARDED_KEYS = ("images", "denorm_images", "depth")


def shard_batch(scene: Dict, mesh: Mesh) -> Dict:
    """This rank's share of its data row's scene: its consecutive slice of
    each view-indexed array, every other array whole (the cameras, ARKit's
    (N, 4, 4) intrinsics included).  Host arrays stay on the host, so that
    the prefetch thread copies only the slice to the card."""
    if mesh.view == 1:
        return dict(scene)
    n = scene["images"].shape[0]
    if n % mesh.view:
        raise ValueError(f"{n} views do not split over {mesh.view} view "
                         f"ranks")
    k = n // mesh.view
    own = slice(mesh.view_index * k, (mesh.view_index + 1) * k)
    return {key: value[own] if key in VIEW_SHARDED_KEYS else value
            for key, value in scene.items()}


def trained_statistics(model: torch.nn.Module) -> List[torch.Tensor]:
    """The running statistics that training moves (the JAX module's
    `batch_stats`: the neck's BatchNorm, and CostRegNet's in BatchNorm
    mode); the frozen backbone's are left out."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def make_sharded_train_step(state, mesh: Mesh) -> Callable:
    """step(batch) -> metrics: one data x view sharded training step of
    ``state`` on this rank's staged share of its scene (`shard_batch`).
    Forward and backward; the gradients and the trained running
    statistics averaged over all ranks; the loss and its terms (`n_pos`
    included) averaged over the data group, returned as device tensors;
    then `apply_gradients`.  Every rank must call it with the same
    ``mesh`` layout.  Raises ValueError for `depth_supervision` with the
    views sharded (ROADMAP F3)."""
    model = state.model
    if mesh.view > 1 and model.cfg.depth_supervision:
        raise ValueError(DEPTH_SUPERVISION_SHARDED)
    view = mesh.view_group if mesh.view > 1 else None

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        total, aux = model.loss(batch, data_group=mesh.data_group, view=view)
        total.backward()
        all_reduce_mean_([p.grad for p in model.parameters()
                          if p.grad is not None], mesh.world_group)
        all_reduce_mean_(trained_statistics(model), mesh.world_group)
        values = pmean(torch.stack([total.detach().to(torch.float32)]
                                   + [v.detach().to(torch.float32)
                                      for v in aux.values()]),
                       mesh.data_group)
        apply_gradients(state)
        return dict(zip(["loss", *aux], values.unbind()))

    return step
