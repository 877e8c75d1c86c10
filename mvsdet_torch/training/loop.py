"""Train state, train step and the step loop (port of
mvsdet_tpu/training/loop.py).

`train_step` is the JAX `train_step` (mvsdet_tpu/training/loop.py:208-237)
for one scene on one card: the model's loss in train mode, backward, the
global-norm clip, AdamW, and the MultiStepLR step.  It reads nothing back
to the host; its metrics stay device tensors.  `fit` drives it over a
batch iterator staged one ahead on a thread (`data/prefetch.py`).
Checkpoints are `torch.save` files of the model, optimizer, scheduler and
step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional

import torch

from mvsdet_torch.config import Config
from mvsdet_torch.data.prefetch import prefetch_iterator, stage_batch
from mvsdet_torch.models.mvsdet import MVSDet, init_weights
from mvsdet_torch.training.optim import build_optimizer, clip_by_global_norm_


@dataclasses.dataclass
class TrainState:
    model: MVSDet
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    max_norm: float
    step: int = 0


def create_train_state(cfg: Config, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       steps_per_epoch: int = 1000, sweep_chunk: int = 8,
                       sweep_remat: bool = True,
                       dtype: torch.dtype = torch.float32) -> TrainState:
    """A model in train mode with random weights from ``generator``
    (default: seeded with ``cfg.seed``) on ``device``, its AdamW optimizer
    and MultiStepLR scheduler, at step 0.

    ``dtype`` is the model's compute dtype
    (mvsdet_tpu/training/loop.py:37-51): bfloat16 runs the networks in
    bf16, while the parameters, their gradients and the AdamW moments stay
    float32.

    Runs on the card unless the caller asks for the CPU; raises when CUDA
    is missing and ``device="cpu"`` was not asked for.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card; pass device='cpu' to run it on the CPU")
    model = MVSDet(cfg.model, sweep_chunk=sweep_chunk,
                   sweep_remat=sweep_remat, dtype=dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    model.to(device).train()
    optimizer, scheduler = build_optimizer(cfg.optim, model, steps_per_epoch)
    return TrainState(model, optimizer, scheduler,
                      max_norm=cfg.optim.grad_clip_norm)


def train_step(state: TrainState,
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One optimisation step on one scene whose tensors are on the model's
    device.  Updates ``state`` in place and returns the metrics (`loss`,
    every loss term, `n_pos`) as device tensors."""
    state.optimizer.zero_grad(set_to_none=True)
    total, aux = state.model.loss(batch)
    total.backward()
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            # a parameter the loss does not reach (FPN levels 1-3): a zero
            # gradient, so that AdamW still decays it as optax decays
            # every leaf
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_(params, state.max_norm)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return {"loss": total.detach(), **{k: v.detach() for k, v in aux.items()}}


def make_train_step(state: TrainState) -> Callable:
    """step(batch) -> metrics, for a batch of host arrays or tensors,
    staged on the model's device first."""
    device = next(state.model.parameters()).device

    def step(batch) -> Dict[str, torch.Tensor]:
        return train_step(state, stage_batch(batch, device))

    return step


def fit(state: TrainState, batches: Iterable[Dict], num_steps: int,
        log_every: int = 10,
        log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: Optional[int] = None) -> TrainState:
    """Step-driven training loop.  The next batch is staged on the device
    by a background thread while the card runs the current step; the host
    reads the metrics only on the steps it logs."""
    device = next(state.model.parameters()).device
    it = prefetch_iterator(batches, device)
    try:
        for i in range(num_steps):
            metrics = train_step(state, next(it))
            if log_fn is not None and (i % log_every == 0
                                       or i == num_steps - 1):
                log_fn(i, {k: float(v) for k, v in metrics.items()})
            if (checkpoint_path is not None and checkpoint_every
                    and (i + 1) % checkpoint_every == 0):
                save_checkpoint(checkpoint_path, state)
    finally:
        it.close()
    return state


def save_checkpoint(path: str, state: TrainState) -> None:
    """The whole train state (model, optimizer, scheduler, step) in one
    `torch.save` file."""
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(),
                "step": state.step}, path)


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore a `save_checkpoint` file into ``state`` (built for the same
    configuration) and return it."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    return state
