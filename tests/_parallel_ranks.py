"""Rank processes for the port's data x view parallel tests.

`start` spawns the ranks of one process group on the CPU over gloo, each
joining through a file store under the test's own directory (no TCP
port, so test workers never collide), and runs one of the workers below
in each.  A worker writes what its test compares into
`<out>/rank<r>.npz`, read back in the pytest process.  This module
imports torch and the port only: the JAX side of each comparison runs in
the pytest process.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this for a peer raises, so that a
# rank that died cannot hang the test run
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=120)


class Ranks:
    """Spawned rank processes; `join` waits for them and raises if one
    failed or the deadline passed."""

    def __init__(self, context, timeout: float):
        self.context = context
        self.deadline = time.monotonic() + timeout

    def join(self) -> None:
        while not self.context.join(
                timeout=max(self.deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= self.deadline:
                for p in self.context.processes:
                    p.kill()
                raise TimeoutError("rank processes did not finish in time")


def start(worker, world: int, out, *args, timeout: float = 300) -> Ranks:
    """Spawn ``world`` ranks running ``worker(rank, out, *args)`` in one
    gloo process group; returns before they finish."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    store = out / "store"
    store.unlink(missing_ok=True)
    context = mp.start_processes(_entry, args=(worker, world, str(store),
                                               str(out), args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
    return Ranks(context, timeout)


def run(worker, world: int, out, *args, timeout: float = 300) -> list:
    """`start`, `join`, and every rank's npz as a dict."""
    start(worker, world, out, *args, timeout=timeout).join()
    return [load(out, r) for r in range(world)]


def load(out, rank: int) -> dict:
    with np.load(Path(out) / f"rank{rank}.npz") as f:
        return dict(f)


def _entry(rank, worker, world, store, out, args):
    # one thread a rank: the test workers already fill the machine, and
    # the sums' order stays that of a one-thread process
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        worker(rank, out, *args)
    finally:
        dist.destroy_process_group()


def _save(out, rank, **arrays):
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)


def params_digest(model) -> str:
    """A hash of every parameter's and buffer's bytes."""
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode() + t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


# -- workers ---------------------------------------------------------------

def mesh_layout(rank, out, data, view):
    """This rank's place in a ``data x view`` mesh and its groups' ranks."""
    from mvsdet_torch.parallel.mesh import make_mesh

    mesh = make_mesh(data, view)
    _save(out, rank, index=[mesh.data_index, mesh.view_index],
          view_ranks=dist.get_process_group_ranks(mesh.view_group),
          data_ranks=dist.get_process_group_ranks(mesh.data_group))


def collectives(rank, out, x, w, v):
    """loss = sum(w * sin(all_gather(x))) + sum(v * psum(x * x)^2) for this
    rank's rows of ``x``: the loss and the gradients of x, w and v."""
    from mvsdet_torch.parallel.collectives import all_gather_views, psum

    group = dist.group.WORLD
    n = x.shape[0] // dist.get_world_size()
    xl = torch.tensor(x[rank * n:(rank + 1) * n], requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    s = psum(xl * xl, group)
    loss = (wt * torch.sin(all_gather_views(xl, group))).sum() \
        + (vt * s * s).sum()
    loss.backward()
    _save(out, rank, loss=loss.detach().numpy(), gx=xl.grad.numpy(),
          gw=wt.grad.numpy(), gv=vt.grad.numpy())


def train(rank, out, data, view, cfg, weights, scenes):
    """One sharded step through `fit` of the state in ``weights`` on a
    ``data x view`` mesh, data row d on scene d of the npz ``scenes``,
    asked for a checkpoint after it.  Every rank saves its metrics, a
    digest of its parameters after the step and how many checkpoints it
    wrote; rank 0 also the state after the step and the gradients the
    update got (averaged, before the clip)."""
    from unittest import mock

    from mvsdet_torch.parallel import sharding
    from mvsdet_torch.parallel.mesh import make_mesh
    from mvsdet_torch.training import loop

    mesh = make_mesh(data, view)
    state = loop.create_train_state(cfg, device="cpu", sweep_chunk=2,
                                    steps_per_epoch=1)
    state.model.load_state_dict(torch.load(weights, weights_only=True))
    with np.load(scenes) as f:
        prefix = f"{mesh.data_index}/"
        scene = {k[len(prefix):]: f[k] for k in f.files
                 if k.startswith(prefix)}
    grads = {}
    apply_gradients = sharding.apply_gradients

    def recording(state):
        grads.update({f"grad/{k}": p.grad.numpy().copy()
                      for k, p in state.model.named_parameters()
                      if p.grad is not None})
        apply_gradients(state)

    logged, saves = [], []
    with mock.patch.object(sharding, "apply_gradients", recording), \
            mock.patch.object(loop, "save_checkpoint",
                              lambda path, state: saves.append(path)):
        loop.fit(state, [scene], 1, log_fn=lambda i, m: logged.append(m),
                 checkpoint_path=os.path.join(out, "checkpoint"),
                 checkpoint_every=1, mesh=mesh)
    arrays = {}
    if rank == 0:
        arrays.update(grads)
        arrays.update({f"state/{k}": v.numpy()
                       for k, v in state.model.state_dict().items()})
    _save(out, rank, digest=params_digest(state.model), saves=len(saves),
          **{f"metric/{k}": v for k, v in logged[0].items()}, **arrays)


def predict(rank, out, cfg, weights, scenes, group_size):
    """`evaluate_scenes` with `make_sharded_predict_fn` over a data group of
    every rank, ``group_size`` scenes a call, on the npz ``scenes``: the
    metrics and each scene's predictions."""
    from mvsdet_torch.evaluation.harness import (evaluate_scenes,
                                                 make_sharded_predict_fn)
    from mvsdet_torch.models.mvsdet import build_model
    from mvsdet_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dist.get_world_size(), 1)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(weights, weights_only=True))
    with np.load(scenes) as f:
        count = len({k.split("/")[0] for k in f.files})
        batches = [{k.split("/", 1)[1]: f[k] for k in f.files
                    if k.startswith(f"{i}/")} for i in range(count)]
    fn = make_sharded_predict_fn(model, mesh, "cpu")
    groups = []

    def recording(group):
        groups.append(fn(group))
        return groups[-1]

    recording.data_index = fn.data_index
    results = evaluate_scenes(recording, batches, cfg.model.head.n_classes,
                              device="cpu", group_size=group_size)
    preds = {f"pred/{g}/{k}": v for g, outs in enumerate(groups)
             for k, v in outs.items()}
    _save(out, rank, **{f"metric/{k}": v for k, v in results.items()},
          **preds)


if __name__ == "__main__":
    # one torchrun process of the train launcher:
    #   torchrun ... tests/_parallel_ranks.py OUT <train launcher args>
    # runs `mvsdet_torch.tools.train.main` with those arguments, then saves
    # this rank's parameter digest and step in OUT/rank<RANK>.npz
    import sys

    from mvsdet_torch.tools import train

    state = train.main(sys.argv[2:])
    _save(sys.argv[1], int(os.environ["RANK"]),
          digest=params_digest(state.model), step=state.step)
