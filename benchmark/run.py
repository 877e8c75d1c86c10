"""Entry point: `python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout (see
`benchmark/harness.py`)."""

import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys

    from benchmark import harness
    harness.set_caches()
    sys.exit(harness.main(T_START))
