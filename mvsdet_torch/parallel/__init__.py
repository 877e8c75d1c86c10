"""Data x view parallelism over `torch.distributed` (port of
mvsdet_tpu/parallel/): a `(data, view)` layout of ranks (`mesh.py`), the
differentiable collectives that `shard_map` gives JAX
(`collectives.py`), the sharded training step and batch (`sharding.py`)
and torchrun's multi-process set-up (`multihost.py`)."""
