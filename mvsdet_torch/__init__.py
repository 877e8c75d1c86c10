"""mvsdet_torch: MVSDet's predict path and training step in PyTorch for
NVIDIA Hopper.

A port of `mvsdet_tpu` (the JAX/flax/Pallas package beside it, which
stays the reference).  Plain tensor code is PyTorch; the five Pallas
kernels are CUDA C++ kernels for sm_90a (`ops/csrc/`, built with nvcc at
first use, bound with ctypes):

  ops/splat_kernel.py  tile compositor, forward and backward
                       (mvsdet_tpu/ops/pallas/splat_kernel.py)
  ops/lift_kernel.py   voxel-lift gather, forward, d-feat and d-weight,
                       on float32 or bf16 feature rows
                       (mvsdet_tpu/ops/pallas/lift_kernel.py)

Each kernel's wrapper launches the kernel for CUDA tensors and runs its
plain PyTorch version (same module) for CPU tensors.  Entry points:
`models.mvsdet.build_model(cfg)` and `evaluation.harness.make_predict_fn`
to serve, `training.loop.create_train_state` and `fit` to train, and the
launchers `python -m mvsdet_torch.tools.train` and `...tools.test` over
real-format data (`data/`, `evaluation/`), which under torchrun shard
scenes and views over ranks (`parallel/`, the JAX package's `shard_map`
step), all on the card unless the caller asks for the CPU, and all
computing in float32
or, given `dtype=torch.bfloat16`, in bf16 as the JAX package's `dtype`
does (parameters and optimizer state float32).  The legacy NeRF-Det
(`models.nerfdet`, float32) trains through
`training.loop.create_nerfdet_state` and `fit` and the train launcher's
`--model nerfdet`; no kernel of `ops/csrc` is on its path.  The layout
mirrors the JAX package so each module's counterpart is found by path.  This package
imports nothing of JAX or of `mvsdet_tpu`.
"""

import torch as _torch

# On the CPU, torch hands float exp, log and tanh to MKL's VML
# (ATen/cpu/vml.h).  The first such call of a process, split over OpenMP
# threads on a loaded machine (6 test workers of 8 threads on 8 cores),
# has returned one thread's share up to 1,772 ulp (1.5e-4 relative) off,
# while every later call was exact; sigmoid, which VML does not compute,
# never did.  One exp here, of one element, which no
# thread splits, runs that first call on this thread, and the later first
# calls of exp, log and tanh are exact: measured with
# `python -m mvsdet_torch.tools.cpu_first_call` (ROADMAP T23).
_torch.exp(_torch.zeros(1))
