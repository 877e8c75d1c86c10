"""Readings of the output check, many seeds in one process: the program
as the cell runs it, the control, or the program with a fault planted.

    python -m benchmark.control --workload <cell> --what program
        --seeds 1 2 3 ... [--seconds 5]
    python -m benchmark.control --workload <cell> --what control --seeds ...
    python -m benchmark.control --workload <cell> --what <fault> --seeds ...

`program` runs the cell's set-up, a short window and the check, as a
benchmark run does.  `control` puts the reference in the program's place,
computed with TF32 on, the precision below the configuration's float32
with TF32 off, and holds it against the reference with TF32 off on the
same inputs (training: the first steps; predict: the sample's scenes).
A fault (`unchanged`, `half_batch`, `altered`; `benchmark/modes/`) is planted
under the timed path of a `program` run.  Each seed prints one JSON line
with its numbers and the cell's limits; the last line holds each number's
largest reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import cells, check, harness


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--what", required=True,
                        choices=["program", "control", "unchanged",
                                 "half_batch", "altered"])
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: the readings are taken on the card; no CUDA "
              "device", file=sys.stderr)
        return 3
    from mvsdet_torch import config as port_config
    cell = cells.find_cell(args.workload)
    mode = cells.load_mode(cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    for seed in args.seeds:
        t = time.perf_counter()
        if args.what == "control":
            out = mode.control(cell, seed)
        else:
            fault = None if args.what == "program" else args.what
            cfg = cells.build_config(port_config, cell.config["config"])
            run = mode.run(cell, cfg, cell.config["config"], seed,
                           args.seconds, False, "cuda",
                           mark_window=lambda: None, fault=fault)
            out = dict(numbers=run.numbers, detail=run.detail)
        numbers = {k: min(v, 1e30) for k, v in out["numbers"].items()}
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(json.dumps(dict(workload=args.workload, what=args.what,
                              seed=seed, numbers=numbers,
                              correct=check.verdict(numbers, cell.limits),
                              detail=out.get("detail", {}),
                              seconds=time.perf_counter() - t)),
              flush=True)
    found = harness.forbidden_modules()
    print(json.dumps(dict(workload=args.workload, what=args.what,
                          seeds=len(args.seeds), largest=worst,
                          limits=cell.limits, forbidden=found)), flush=True)
    return 0


if __name__ == "__main__":
    harness.set_caches()
    sys.exit(main())
