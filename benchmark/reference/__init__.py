"""The benchmark's plain reference: a frozen copy of the port's MVSDet
(its model, loss, AdamW update and predict) in plain PyTorch.

Copied from `mvsdet_torch` at commit dafa6b3, with every import renamed
to this package, and cut to what the benchmark's cells drive: float32,
one device, the mxu plane sweep, CostRegNet in GroupNorm, the tiled
renderer, the aligned head's loss, both heads' predict, no diagnostics.
The two kernel modules are replaced by their plain versions: the
compositor in `ops/splat_tiles.py`, differentiated by autograd, and the
lift's gather in `ops/voxel_lift.py`, with its plain d-feat and d-weight.
It imports nothing of
`mvsdet_torch`, so a later change to the program does not change what the
program is held against.  The benchmark runs it in float32 with TF32 off
(`benchmark/check.py`).
"""

import torch as _torch

# as in the port's package: the first MKL exp of a process on a loaded
# CPU has come back a few ulp off; one exp here takes that first call
_torch.exp(_torch.zeros(1))
