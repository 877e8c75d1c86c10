"""The benchmark of `mvsdet_torch` (the PyTorch and CUDA port) on NVIDIA
cards.  See `benchmark/README.md`; run a cell with
`python -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>` from the root of a checkout."""
