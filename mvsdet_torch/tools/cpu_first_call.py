"""The first CPU call of an elementwise op in a fresh process, against a
second call on the same input (ROADMAP T23).

    python -m mvsdet_torch.tools.cpu_first_call --rounds 6 --per-arm 45 \\
        --parallel 12 exp:0 exp:1 tanh:0 tanh:1

Each arm `op:warm` runs `--per-arm` fresh processes per round, `--parallel`
at a time, each on torch's default thread count, so that the machine is
oversubscribed as a parallel test run makes it.  A process computes
`op` on a (6, 256, 64) float32 tensor twice and reports how many elements
differ between the two calls.  `warm` is 0 (nothing first) or 1 (one
`torch.exp` of one element first, as `mvsdet_torch/__init__.py` does).
torch computes float exp, log and tanh on the CPU with MKL's VML, and
sigmoid with its own code.  The arms
run interleaved, round by round; the script prints one JSON line per arm:
processes, processes whose two calls differed, and the largest
difference.  Each process imports torch and numpy alone, not the
package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

OPS = ("exp", "log", "tanh", "sigmoid")


def child(op: str, warm: int) -> None:
    import numpy as np
    import torch

    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -8, 3, (6, 256, 64)).astype(np.float32))
    if op == "log":
        x = x.abs() + 1e-3
    fn = {"exp": torch.exp, "log": torch.log, "tanh": torch.tanh,
          "sigmoid": torch.sigmoid}[op]
    if warm:
        torch.exp(torch.zeros(1))
    a, b = fn(x), fn(x)
    print(json.dumps({"differ": int((a != b).sum()),
                      "max_abs": float((a - b).abs().max())}))


def run_one(op: str, warm: int) -> dict:
    # the file itself, not `-m`: importing the package would run its own
    # warm-up exp in every process
    out = subprocess.run([sys.executable, __file__, "--child",
                          f"{op}:{warm}"], capture_output=True, text=True,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("arms", nargs="+", help="op:warm, op in " + ", ".join(OPS))
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--per-arm", type=int, default=45)
    p.add_argument("--parallel", type=int, default=12)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    arms = [(a.split(":")[0], int(a.split(":")[1])) for a in args.arms]
    if args.child:
        child(*arms[0])
        return
    tally = {arm: {"processes": 0, "differed": 0, "max_abs": 0.0}
             for arm in arms}
    with ThreadPoolExecutor(args.parallel) as pool:
        for _ in range(args.rounds):
            for arm in arms:
                for r in pool.map(lambda _: run_one(*arm),
                                  range(args.per_arm)):
                    t = tally[arm]
                    t["processes"] += 1
                    t["differed"] += r["differ"] > 0
                    t["max_abs"] = max(t["max_abs"], r["max_abs"])
    for (op, warm), t in tally.items():
        print(json.dumps({"op": op, "warm": warm, **t}))


if __name__ == "__main__":
    main()
