"""How the PyTorch port's rotated bf16 learning check ends with the card's
default (nondeterministic) kernels against deterministic ones.

    python experiments/overfit_spread_torch.py --draws 10 --out DIR
    python experiments/overfit_spread_torch.py --modes cudnn steps --out DIR
    python experiments/overfit_spread_torch.py --modes --out DIR  # summary

Runs the rotated bf16 case of `chip_smoke.py`'s learning check
(`mvsdet_torch.tools.overfit_map.run`: the ARKit yaw head, 200 steps, an
evaluation every 50, 2 scenes, seeds 0-2, from JAX's initial weights for
each seed; JAX's gate: median final mAP_0.25 and mAR_0.25 above 0.6)
``--draws`` times per seed in each of ``--modes``:

- ``default``: the card's default kernels, as users train; a run is a draw
  of the nondeterministic kernels' summation orders, at every step.
- ``witness``: deterministic algorithms, from JAX's weights moved by one
  float32 ulp each (`torch.nextafter`): up at draw 0, else by a sign drawn
  from numpy's generator seeded with (draw, seed).  Perturbed once.
- ``cudnn``: cuDNN's deterministic algorithms only; torch's own
  nondeterministic kernels (the atomics of `index_add_`) left as they are.
- ``steps``: deterministic algorithms, every parameter moved one ulp by a
  sign drawn on the card from (draw, seed) after every step: rounding
  noise at every step, as in ``default``, with the deterministic
  algorithms' numerics.

Every run sweeps with the model's default, recorded as ``sweep`` (the
two-product shear warp, "mxu"; the runs before it was the default swept
with the gather).  One worker process per (mode, seed) shares the card;
each draws JAX's weights once and loads them into its later runs.  A
run's finals go to
``<out>/<mode>-<seed>.json``.  The summary reads every such file under
``--out``: per mode the finals by seed, the draws' medians and the gate's
misses, and per seed and pooled the two-sided Mann-Whitney rank test of
each mode's finals against the witness's and the default's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MODES = ("default", "witness", "cudnn", "steps")
SEEDS = (0, 1, 2)
STEPS, EVAL_EVERY, SCENES, LR, GATE = 200, 50, 2, 1e-3, 0.6


def nudge(params, up) -> None:
    """Move each element of ``params`` one float32 ulp, up where ``up``."""
    with torch.no_grad():
        for p, u in zip(params, up):
            p.copy_(torch.nextafter(p, torch.where(
                u, torch.full_like(p, float("inf")),
                torch.full_like(p, float("-inf")))))


def _worker(mode: str, seed: int, draws: int, out: str) -> None:
    from mvsdet_torch.tools import overfit_map

    if mode in ("witness", "steps"):
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = mode != "default"
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    weights, sweep = {}, []
    plain_state, plain_step = overfit_map.create_train_state, \
        overfit_map.step_fn
    draw_now = [0]

    def create(cfg, *, flax_seed=None, **kwargs):
        if not weights:
            state = plain_state(cfg, flax_seed=flax_seed, **kwargs)
            weights.update({k: v.clone()
                            for k, v in state.model.state_dict().items()})
        else:
            state = plain_state(cfg, **kwargs)
            state.model.load_state_dict(weights)
        sweep[:] = [state.model.sweep_method]
        if mode == "witness":
            params = list(state.model.parameters())
            rng = np.random.default_rng([draw_now[0], seed])
            nudge(params, [torch.ones_like(p, dtype=torch.bool)
                           if draw_now[0] == 0 else torch.from_numpy(
                               rng.random(tuple(p.shape)) < 0.5).to(p.device)
                           for p in params])
        return state

    def step_fn(state):
        step = plain_step(state)
        if mode != "steps":
            return step
        params = list(state.model.parameters())
        gen = torch.Generator(device="cuda").manual_seed(
            1000 * draw_now[0] + seed)

        def nudged(batch):
            metrics = step(batch)
            nudge(params, [torch.rand(p.shape, generator=gen,
                                      device="cuda") < 0.5 for p in params])
            return metrics
        return nudged

    results = []
    with mock.patch.object(overfit_map, "create_train_state", create), \
            mock.patch.object(overfit_map, "step_fn", step_fn):
        for draw in range(draws):
            draw_now[0] = draw
            t0 = time.perf_counter()
            history = overfit_map.run(
                steps=STEPS, eval_every=EVAL_EVERY, n_scenes=SCENES, lr=LR,
                seed=seed, log_fn=lambda line: None, arkit=True,
                device="cuda", dtype=torch.bfloat16)
            results.append(dict(mode=mode, sweep=sweep[0], seed=seed,
                                draw=draw, seconds=time.perf_counter() - t0,
                                final=history[-1], history=history))
            with open(Path(out) / f"{mode}-{seed}.json", "w") as f:
                json.dump(results, f)


def summarize(runs) -> dict:
    """Per mode: the finals by seed, the draws' medians and misses; per
    seed and pooled, each mode's rank test against the witness and the
    default."""
    from scipy.stats import mannwhitneyu

    finals = {}
    for r in sorted(runs, key=lambda r: r["draw"]):
        finals.setdefault(r["mode"], {}).setdefault(r["seed"], []).append(
            r["final"])
    summary = {}
    for mode, by_seed in finals.items():
        draws = min(len(v) for v in by_seed.values())
        medians = [(statistics.median(by_seed[s][d]["mAP_0.25"]
                                      for s in by_seed),
                    statistics.median(by_seed[s][d]["mAR_0.25"]
                                      for s in by_seed))
                   for d in range(draws)] if len(by_seed) == len(SEEDS) \
            else []
        summary[mode] = dict(
            finals_map_025={s: [f["mAP_0.25"] for f in v]
                            for s, v in sorted(by_seed.items())},
            seed_medians={s: statistics.median(f["mAP_0.25"] for f in v)
                          for s, v in sorted(by_seed.items())},
            draw_medians_map_025=[m for m, _ in medians],
            misses=sum(not (m > GATE and r > GATE) for m, r in medians),
            draws=len(medians))
    for mode in summary:
        for other in ("witness", "default"):
            if other == mode or other not in summary:
                continue
            a, b = summary[mode]["finals_map_025"], \
                summary[other]["finals_map_025"]
            tests = {str(s): mannwhitneyu(a[s], b[s]).pvalue
                     for s in a if s in b}
            pooled = [x for s in a if s in b for x in a[s]], \
                [x for s in a if s in b for x in b[s]]
            tests["pooled"] = mannwhitneyu(*pooled).pvalue
            summary[mode][f"rank_test_p_vs_{other}"] = {
                k: float(v) for k, v in tests.items()}
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modes", nargs="*", choices=MODES,
                   default=["default", "witness"])
    p.add_argument("--draws", type=int, default=10)
    p.add_argument("--out", default="build/overfit_spread")
    a = p.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    codes = []
    if a.modes:
        if not torch.cuda.is_available():
            raise SystemExit("the runs need the card")
        import torch.multiprocessing as mp

        spawn = mp.get_context("spawn")
        workers = [spawn.Process(target=_worker,
                                 args=(m, s, a.draws, str(out)))
                   for m in a.modes for s in SEEDS]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        codes = [w.exitcode for w in workers]
    runs = [r for path in sorted(out.glob("*-*.json"))
            for r in json.loads(path.read_text())]
    for r in runs:
        r.setdefault("sweep", "gather")      # runs from before the field
        print(json.dumps({k: r[k] for k in ("mode", "sweep", "seed", "draw",
                                            "seconds", "final")}))
    summary = dict(wall_s=time.perf_counter() - t0, exit_codes=codes,
                   **summarize(runs))
    print(json.dumps({"summary": summary}), flush=True)
    if any(codes):
        raise SystemExit(f"workers exited with {codes}")
    return summary


if __name__ == "__main__":
    main()
