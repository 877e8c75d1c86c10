"""Time the compositor and the lift's kernels of a checkout on the inputs a
training step and a predict gave them.

    python3 chip_smoke.py --save-kernel-inputs build/kernels.pt
    python3 mvsdet_torch/tools/time_kernels.py build/kernels.pt [--tree DIR]

Imports `mvsdet_torch` from the checkout at DIR (by default the one this
file is in), whose kernels build there, while the timing is always this
checkout's `chip_smoke.cuda_ms`: the kernels of two commits are timed one
way.  Prints one JSON line: the card (as nvidia-smi names it, with its
power limit), the tree, and, each queued behind a device wait (`ms`) and
host-paced (`host_paced_ms`): K1 on the training step's and the predict's
tables and K2 on the step's; K3 on the step's and the predict's inputs
(`K3`, `K3_predict`, where the file has them); K4 and K5 called alone
(each building its own row index, where the tree has one); the index
alone (`lift_rows`, where the tree has it); one backward of the lift's
autograd Function (`lift_backward`, whatever the tree runs there); and,
where the file and the tree have them, the bf16 variants of K3, K4 and
K5 on the bf16 step's inputs, one bf16 backward (`K3_bf16` ...
`lift_backward_bf16`) and the bf16 K3 on the bf16 predict's inputs
(`K3_bf16_predict`).  Run it as a script, not with `-m`, so that
`mvsdet_torch` comes from DIR.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("inputs", help="the file chip_smoke.py saved")
    parser.add_argument("--tree", default=str(ROOT),
                        help="root of the checkout whose kernels to time")
    opts = parser.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch = smoke.torch
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels measures the card; no CUDA device")
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    from mvsdet_torch.ops import lift_kernel
    from mvsdet_torch.ops.splat_kernel import (composite_tiles,
                                               composite_tiles_bwd)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    inputs = torch.load(opts.inputs, map_location="cuda")
    pix, weight, g, hw = inputs["k4"]
    feat = inputs["k5"][0]
    calls = {
        "K1": lambda: composite_tiles(*inputs["k1"]),
        "K1_predict": lambda: composite_tiles(*inputs["k1_predict"]),
        "K2": lambda: composite_tiles_bwd(*inputs["k2"]),
        "K4": lambda: lift_kernel.weighted_gather_sum_dfeat(*inputs["k4"]),
        "K5": lambda: lift_kernel.weighted_gather_sum_dweight(*inputs["k5"]),
        "lift_backward": smoke.lift_backward_fn(
            lift_kernel.weighted_gather_sum, feat, pix, weight, g)}
    for key, name in (("k3", "K3"), ("k3_predict", "K3_predict")):
        if key in inputs:
            calls[name] = functools.partial(lift_kernel.weighted_gather_sum,
                                            *inputs[key])
    if hasattr(lift_kernel, "lift_rows"):
        calls["lift_rows"] = lambda: lift_kernel.lift_rows(pix, hw)
    if "k5_bf16" in inputs and hasattr(lift_kernel, "FEATURE_DTYPES"):
        pix_b, weight_b, g_b = inputs["k4_bf16"][:3]
        calls.update({
            "K3_bf16": lambda: lift_kernel.weighted_gather_sum(
                *inputs["k3_bf16"]),
            "K4_bf16": lambda: lift_kernel.weighted_gather_sum_dfeat(
                *inputs["k4_bf16"]),
            "K5_bf16": lambda: lift_kernel.weighted_gather_sum_dweight(
                *inputs["k5_bf16"]),
            "lift_backward_bf16": smoke.lift_backward_fn(
                lift_kernel.weighted_gather_sum, inputs["k5_bf16"][0], pix_b,
                weight_b, g_b)})
        if "k3_bf16_predict" in inputs:
            calls["K3_bf16_predict"] = functools.partial(
                lift_kernel.weighted_gather_sum, *inputs["k3_bf16_predict"])
    reps = {"lift_backward": smoke.BACKWARD_REPS,
            "lift_backward_bf16": smoke.BACKWARD_REPS}
    times = {name: {"ms": smoke.cuda_ms(fn, reps=reps.get(name, 20)),
                    "host_paced_ms": smoke.cuda_ms(
                        fn, reps=reps.get(name, 20), queued=False)}
             for name, fn in calls.items()}
    print(json.dumps({"device": smi, "tree": str(tree), "times": times}),
          flush=True)


if __name__ == "__main__":
    main()
