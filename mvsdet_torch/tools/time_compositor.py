"""Time the tile compositor of a checkout on the inputs a step gave it.

    python3 chip_smoke.py --save-compositor-inputs build/compositor.pt
    python3 mvsdet_torch/tools/time_compositor.py build/compositor.pt \
        [--tree DIR]

Imports `mvsdet_torch` from the checkout at DIR (by default the one this
file is in), whose kernels build there, while the timing is always this
checkout's `chip_smoke.cuda_ms`: the compositors of two commits are timed
one way.  Prints one JSON line: the card (as nvidia-smi names it, with its
power limit), the tree, and K1 on the training step's and the predict's
tables and K2 on the step's, each queued behind a device wait (`ms`) and
host-paced (`host_paced_ms`).  Run it as a script, not with `-m`, so that
`mvsdet_torch` comes from DIR.
"""

from __future__ import annotations

import argparse
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
                        help="root of the checkout whose compositor to time")
    opts = parser.parse_args()
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch = smoke.torch
    if not torch.cuda.is_available():
        raise SystemExit("time_compositor measures the card; no CUDA device")
    tree = Path(opts.tree).resolve()
    sys.path.insert(0, str(tree))
    from mvsdet_torch.ops.splat_kernel import (composite_tiles,
                                               composite_tiles_bwd)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    inputs = torch.load(opts.inputs, map_location="cuda")
    times = {}
    for name, fn, args in (("K1", composite_tiles, inputs["k1"]),
                           ("K1_predict", composite_tiles,
                            inputs["k1_predict"]),
                           ("K2", composite_tiles_bwd, inputs["k2"])):
        times[name] = {
            "ms": smoke.cuda_ms(lambda: fn(*args)),
            "host_paced_ms": smoke.cuda_ms(lambda: fn(*args), queued=False)}
    print(json.dumps({"device": smi, "tree": str(tree), "times": times}),
          flush=True)


if __name__ == "__main__":
    main()
