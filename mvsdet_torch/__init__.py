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
to serve, `training.loop.create_train_state` and `fit` to train, all on
the card unless the caller asks for the CPU, and all computing in float32
or, given `dtype=torch.bfloat16`, in bf16 as the JAX package's `dtype`
does (parameters and optimizer state float32).  The layout mirrors the JAX
package so each module's counterpart is found by path.  This package
imports nothing of JAX or of `mvsdet_tpu`.
"""
