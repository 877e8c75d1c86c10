"""The initial weights of the JAX package's models, drawn without JAX.

`draw_flax_init(model, key)` fills a port model's random kernels with
the values the JAX module's `init` draws for them from that params key
(`create_train_state` and `create_nerfdet_state` in
`mvsdet_tpu/training/loop.py:55-57, 85-88` derive it from
`PRNGKey(seed)`), so that a seed means the same starting weights in both
packages and on every machine (torch's own generator draws other values
from one seed under other torch versions, ROADMAP T26).  The draw is JAX's, step by step, in numpy:

  key of a kernel   flax folds the SHA-1 of its module path and its
                    parameter counter into the root key (`LazyRng`,
                    flax/core/scope.py), one `fold_in`
  fold_in, bits     threefry-2x32 (20 rounds) with JAX's partitionable
                    counters: the flat index's high and low words
  lecun_normal      truncated_normal(-2, 2) * sqrt(1 / fan_in) / 0.8796:
                    a uniform in (erf(-sqrt 2), erf(sqrt 2)), then
                    sqrt 2 * erfinv (XLA's single-precision polynomial)

The integer parts are exact.  The float parts follow XLA's CPU operations
in float32, its fused multiply-adds included; `log1p` is numpy's, which
rounds otherwise than XLA's about once in a hundred draws, and then the
kernel's value moves by an ulp or two (tests/test_torch_port_flax_init.py
holds every kernel against JAX's `init`).  Biases, norms, the head's scales and
its class prior are the constants `init_weights` already sets; only the
kernels of convolutions, transposed convolutions and dense layers are
random.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np
import torch
from torch import nn

from mvsdet_torch.interop import _MODULE_NAMES, _convert

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# erf(-2 / sqrt 2) and erf(2 / sqrt 2) as XLA computes them in float32
_ERF_LO = np.float32(-0.9544997215270996)
_ERF_HI = np.float32(0.9544997215270996)
# XLA's single-precision erfinv (Giles), for w = -log1p(-x^2) below 5
# and at or above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_TRUNC_STD = np.float32(0.87962566103423978)   # std of N(0,1) on [-2, 2]


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's threefry-2x32 hash of the counter words (x0, x1) under the
    key (k0, k1) (jax/_src/prng.py `_threefry2x32_lowering`)."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(k0), np.uint32(k1)
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for a seed below 2**32."""
    return 0, seed & 0xFFFFFFFF


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """`jax.random.fold_in(key, data)`."""
    a, b = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                        np.array([data & 0xFFFFFFFF], np.uint32))
    return int(a[0]), int(b[0])


def split(key: Tuple[int, int], num: int = 2):
    """`jax.random.split(key, num)` (`_threefry_split_foldlike`): the hash
    of the counters 0 .. num-1."""
    a, b = threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                        np.arange(num, dtype=np.uint32))
    return [(int(x), int(y)) for x, y in zip(a, b)]


def random_bits(key: Tuple[int, int], shape) -> np.ndarray:
    """32 random bits per element (`_threefry_random_bits_partitionable`):
    the hash of each element's flat index."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return (a ^ b).reshape(shape)


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c rounded once to float32, as XLA's CPU code fuses it: the
    float32 product is exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _erfinv(x: np.ndarray) -> np.ndarray:
    f = np.float32
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(f)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0))
    p = np.where(lt, f(_ERFINV_LT5[0]), f(_ERFINV_GE5[0]))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, f(c_lt), f(c_ge)))
    return (p * x).astype(f)


def truncated_normal(key: Tuple[int, int], shape) -> np.ndarray:
    """`jax.random.truncated_normal(key, -2, 2, shape)` in float32."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    u = np.maximum(_ERF_LO, _fma(floats, _ERF_HI - _ERF_LO, _ERF_LO))
    out = np.float32(np.sqrt(2)) * _erfinv(u)
    return np.clip(out, np.nextafter(np.float32(-2), np.float32(np.inf)),
                   np.nextafter(np.float32(2), np.float32(-np.inf)))


def param_key(root: Tuple[int, int], path, counter: int = 1
              ) -> Tuple[int, int]:
    """The key flax hands the ``counter``-th parameter of the module at
    ``path`` (flax's `_fold_in_static` of the path's names and the
    counter, without separators)."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def lecun_normal(key: Tuple[int, int], shape) -> np.ndarray:
    """flax's default kernel initialiser in float32: fan-in over every
    axis but the last two, times the next to last."""
    fan_in = int(np.prod(shape[:-1]))
    std = np.float32(np.sqrt(np.float32(1.0 / fan_in))) / _TRUNC_STD
    return truncated_normal(key, shape) * std


_KERNEL_MODULES = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d, nn.Linear)


def _flax_path(name: str, module: nn.Module):
    """The flax module path of a port layer named ``name``: the bridge's
    renamings (`interop._MODULE_NAMES`) undone."""
    parts = name.split(".")
    if parts[-1] == "conv":
        parts[-1] = ("ConvTranspose_0" if isinstance(module, nn.ConvTranspose3d)
                     else "Conv_0")
    return parts


def draw_flax_init(model: nn.Module, key: Tuple[int, int]) -> None:
    """Overwrite every convolution, transposed convolution and dense
    kernel of ``model`` with the value the JAX module's init draws from
    the params key ``key`` (`prng_key(seed)` for MVSDet, as JAX's
    `create_train_state` hands `PRNGKey(seed)` to init); everything else
    keeps its (constant) value."""
    assert set(_MODULE_NAMES.values()) == {"conv", "norm"}
    with torch.no_grad():
        for name, module in model.named_modules():
            if not isinstance(module, _KERNEL_MODULES):
                continue
            w = module.weight
            path = _flax_path(name, module)
            if isinstance(module, nn.Linear):
                shape = (w.shape[1], w.shape[0])
            elif isinstance(module, nn.ConvTranspose3d):
                shape = tuple(w.shape[2:]) + (w.shape[0], w.shape[1])
            else:
                shape = tuple(w.shape[2:]) + (w.shape[1], w.shape[0])
            flax_value = lecun_normal(param_key(key, path), shape)
            value = _convert(path, "kernel", flax_value)
            w.copy_(torch.from_numpy(np.ascontiguousarray(value)))
