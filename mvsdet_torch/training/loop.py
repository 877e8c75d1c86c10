"""Train state, train step and the step loop (port of
mvsdet_tpu/training/loop.py).

`train_step` is the JAX `train_step` (mvsdet_tpu/training/loop.py:208-237)
for one scene on one card: the model's loss in train mode, backward, the
global-norm clip, AdamW, and the MultiStepLR step.  It reads nothing back
to the host; its metrics stay device tensors.  `fit` drives it, or
the data x view sharded step of `parallel/sharding.py`, over a batch
iterator staged one ahead on a thread (`data/prefetch.py`).
Checkpoints are `torch.save` files of the model, optimizer, scheduler and
step; `create_predict_state` builds an eval model from one (the test
launcher's), and `load_pretrained_backbone` swaps ImageNet weights into a
train state's ResNet.

`create_nerfdet_state` and `nerfdet_train_step` are the same for the
legacy NeRF-Det (mvsdet_tpu/training/loop.py:70-130): the step draws its
rays from a generator seeded with (seed, step), so that a resumed run
draws at step k what an unbroken run draws there, as JAX's
`fold_in(PRNGKey(seed), step)` makes it.  `fit`, the checkpoints and
`load_pretrained_backbone` take either state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, Optional, Union

import torch
from torch import nn

from mvsdet_torch.config import Config
from mvsdet_torch.data.prefetch import prefetch_iterator, stage_batch
from mvsdet_torch.models import flax_init
from mvsdet_torch.models.mvsdet import MVSDet, build_model, init_weights
from mvsdet_torch.models.nerfdet import NerfDetLegacy
from mvsdet_torch.models.resnet import (load_torchvision_checkpoint,
                                        port_torchvision_state_dict)
from mvsdet_torch.parallel.mesh import Mesh
from mvsdet_torch.parallel.sharding import make_sharded_train_step, shard_batch
from mvsdet_torch.training.optim import apply_gradients, build_optimizer


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and scheduler, the clip norm and the step
    count; ``ray_seed``, NeRF-Det's alone, seeds its rays' draws."""
    model: Union[MVSDet, NerfDetLegacy]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    max_norm: float
    step: int = 0
    ray_seed: Optional[int] = None


def _device_for(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the "
                           "card; pass device='cpu' to run it on the CPU")
    return device


def create_train_state(cfg: Config, device="cuda",
                       generator: Optional[torch.Generator] = None,
                       steps_per_epoch: int = 1000, sweep_chunk: int = 8,
                       sweep_remat: bool = True,
                       dtype: torch.dtype = torch.float32,
                       flax_seed: Optional[int] = None) -> TrainState:
    """A model in train mode with random weights from ``generator``
    (default: seeded with ``cfg.seed``) on ``device``, its AdamW optimizer
    and MultiStepLR scheduler, at step 0.  With ``flax_seed`` the weights
    are instead the ones the JAX package's `create_train_state` draws from
    `PRNGKey(flax_seed)` (`models/flax_init.py`).

    ``dtype`` is the model's compute dtype
    (mvsdet_tpu/training/loop.py:37-51): bfloat16 runs the networks in
    bf16, while the parameters, their gradients and the AdamW moments stay
    float32.

    Runs on the card unless the caller asks for the CPU; raises when CUDA
    is missing and ``device="cpu"`` was not asked for.
    """
    device = _device_for(device)
    model = MVSDet(cfg.model, sweep_chunk=sweep_chunk,
                   sweep_remat=sweep_remat, dtype=dtype)
    key = None if flax_seed is None else flax_init.prng_key(flax_seed)
    return _train_state(cfg, model, device, generator, steps_per_epoch,
                        flax_key=key)


def _train_state(cfg: Config, model: nn.Module, device: torch.device,
                 generator: Optional[torch.Generator], steps_per_epoch: int,
                 ray_seed: Optional[int] = None,
                 flax_key=None) -> TrainState:
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, generator)
    if flax_key is not None:
        flax_init.draw_flax_init(model, flax_key)
    model.to(device).train()
    optimizer, scheduler = build_optimizer(cfg.optim, model, steps_per_epoch)
    return TrainState(model, optimizer, scheduler,
                      max_norm=cfg.optim.grad_clip_norm, ray_seed=ray_seed)


def create_nerfdet_state(cfg: Config, device="cuda",
                         generator: Optional[torch.Generator] = None,
                         steps_per_epoch: int = 1000,
                         seed: Optional[int] = None,
                         dtype: torch.dtype = torch.float32,
                         flax_seed: Optional[int] = None,
                         **model_fields) -> TrainState:
    """A legacy NeRF-Det in train mode (mvsdet_tpu/training/loop.py:70-98)
    with random weights from ``generator`` (default: seeded with
    ``cfg.seed``) on ``device``, the AdamW, clip and MultiStepLR of
    `create_train_state`, at step 0.  ``seed`` (default ``cfg.seed``)
    seeds the step's ray draws; ``model_fields`` are `NerfDetLegacy`'s
    (``n_samples``, ``n_rand``, ...).  ``dtype`` is the model's compute
    dtype, as in `create_train_state`: with bfloat16 the networks compute
    in bf16, while the parameters, their gradients and the AdamW moments
    stay float32.  With ``flax_seed`` the weights are the ones the JAX
    package's `create_nerfdet_state` draws from `PRNGKey(flax_seed)`: its
    init takes the first key of that key's split.

    Runs on the card unless the caller asks for the CPU; raises when CUDA
    is missing and ``device="cpu"`` was not asked for.
    """
    device = _device_for(device)
    model = NerfDetLegacy(cfg.model, dtype=dtype, **model_fields)
    key = (None if flax_seed is None
           else flax_init.split(flax_init.prng_key(flax_seed))[0])
    return _train_state(cfg, model, device, generator, steps_per_epoch,
                        ray_seed=cfg.seed if seed is None else seed,
                        flax_key=key)


def ray_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of NeRF-Det's ray draws at ``step``: seeded with
    ``seed`` in the high bits and the step in the low 32, on ``device``
    (the counterpart of `fold_in(PRNGKey(seed), step)`,
    mvsdet_tpu/training/loop.py:109)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def train_step(state: TrainState,
               batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One optimisation step on one scene whose tensors are on the model's
    device.  Updates ``state`` in place and returns the metrics (`loss`,
    every loss term, `n_pos`) as device tensors."""
    state.optimizer.zero_grad(set_to_none=True)
    total, aux = state.model.loss(batch)
    total.backward()
    apply_gradients(state)
    return {"loss": total.detach(), **{k: v.detach() for k, v in aux.items()}}


def nerfdet_train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """One NeRF-Det optimisation step (mvsdet_tpu/training/loop.py:
    101-129): its loss with the rays drawn from `ray_generator` at this
    step, backward, then the update of `train_step`.  Updates ``state`` in
    place and returns the metrics as device tensors."""
    device = next(state.model.parameters()).device
    state.optimizer.zero_grad(set_to_none=True)
    total, aux = state.model.loss(
        batch, generator=ray_generator(state.ray_seed, state.step, device))
    total.backward()
    apply_gradients(state)
    return {"loss": total.detach(), **{k: v.detach() for k, v in aux.items()}}


def step_fn(state: TrainState) -> Callable:
    """The unsharded step of ``state``'s model: `nerfdet_train_step` for
    NeRF-Det, `train_step` for MVSDet."""
    step = nerfdet_train_step if state.ray_seed is not None else train_step
    return functools.partial(step, state)


def make_train_step(state: TrainState) -> Callable:
    """step(batch) -> metrics, for a batch of host arrays or tensors,
    staged on the model's device first."""
    device = next(state.model.parameters()).device
    step = step_fn(state)

    def staged_step(batch) -> Dict[str, torch.Tensor]:
        return step(stage_batch(batch, device))

    return staged_step


def fit(state: TrainState, batches: Iterable[Dict], num_steps: int,
        log_every: int = 10,
        log_fn: Optional[Callable[[int, Dict[str, float]], None]] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        mesh: Optional[Mesh] = None) -> TrainState:
    """Step-driven training loop over `step_fn`'s step (NeRF-Det's or
    MVSDet's).  The next batch is staged on the device by a background
    thread while the card runs the current step; the host reads the
    metrics only on the steps it logs.

    With ``mesh`` (MVSDet only), ``batches`` are this rank's data row's
    scenes, each step is the sharded step (`make_sharded_train_step`), the
    thread stages only this rank's view slice of each (`shard_batch`), and rank 0
    alone writes the checkpoints (every rank holds the same state).
    """
    device = next(state.model.parameters()).device
    if mesh is None:
        step = step_fn(state)
    elif state.ray_seed is not None:
        raise ValueError("NeRF-Det trains on one device only, as the JAX "
                         "launcher does (tools/train.py:137-141)")
    else:
        step = make_sharded_train_step(state, mesh)
        batches = (shard_batch(b, mesh) for b in batches)
    it = prefetch_iterator(batches, device)
    try:
        for i in range(num_steps):
            metrics = step(next(it))
            if log_fn is not None and (i % log_every == 0
                                       or i == num_steps - 1):
                log_fn(i, {k: float(v) for k, v in metrics.items()})
            if (checkpoint_path is not None and checkpoint_every
                    and (i + 1) % checkpoint_every == 0
                    and (mesh is None or mesh.rank == 0)):
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


def create_predict_state(cfg: Config, checkpoint: Optional[str] = None,
                         device="cuda", dtype: torch.dtype = torch.float32,
                         sweep_chunk: int = 8) -> MVSDet:
    """An eval-mode model for predict (mvsdet_tpu/training/loop.py:132-170):
    no optimizer.  With ``checkpoint`` (a `save_checkpoint` file) the
    weights are its model part, read on the host and copied to the model;
    without one they are random, seeded with ``cfg.seed``, as `build_model`
    draws them.

    Runs on the card unless the caller asks for the CPU; raises when CUDA
    is missing and ``device="cpu"`` was not asked for.
    """
    model = build_model(cfg, device=device, dtype=dtype,
                        sweep_chunk=sweep_chunk)
    if checkpoint is not None:
        ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
        model.load_state_dict(ckpt["model"])
    return model


def load_pretrained_backbone(state: TrainState, path: str) -> TrainState:
    """Load ImageNet-pretrained ResNet weights into ``state``'s backbone
    (mvsdet_tpu/training/loop.py:173-205).

    The reference initialises its backbone from ``torchvision://resnet50``
    (ref: projects/NeRF-Det/configs/mvsdet_res50_2x_low_res_depth.py:25);
    here the equivalent is an explicit checkpoint file (``.pth`` or
    ``.npz`` with torchvision names; names the ResNet does not have, such
    as the classifier's ``fc.*``, are not read).  The optimizer state is
    untouched: the shapes are the same and AdamW's moments start at zero
    either way.  Updates ``state`` in place and returns it.

    Raises ValueError when the file's names or shapes do not match the
    backbone exactly.
    """
    backbone = state.model.backbone
    ours = backbone.state_dict()
    try:
        ported = port_torchvision_state_dict(
            load_torchvision_checkpoint(path), state.model.cfg.backbone.depth)
    except KeyError as exc:
        raise ValueError(f"pretrained backbone {path} lacks {exc}") from exc
    want = {k: tuple(v.shape) for k, v in ours.items()}
    got = {k: tuple(v.shape) for k, v in ported.items()}
    if want != got:
        diff = sorted(k for k in want.keys() | got.keys()
                      if want.get(k) != got.get(k))
        raise ValueError(f"pretrained backbone {path} does not fit the "
                         f"model's ({len(diff)} names differ in presence or "
                         f"shape, first {diff[:5]})")
    backbone.load_state_dict(ported)
    return state
