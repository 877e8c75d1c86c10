"""Weight bridge: a JAX `MVSDet` or `NerfDetLegacy` variable tree into the
port's state_dict.

The port's submodules carry the JAX parameter tree's names, with flax's
auto-named layers inside a conv block renamed (`Conv_0` and
`ConvTranspose_0` to `conv`, `GroupNorm_0` and `BatchNorm_0` to `norm`),
so a leaf's path gives its key.  Values are converted as follows:

  conv kernel HWIO / DHWIO           -> OIHW / OIDHW
  ConvTranspose kernel DHWIO         -> spatially flipped, (I, O, D, H, W):
                                        flax does not flip its kernel and
                                        torch's transposed conv does
                                        (ROADMAP trap T7)
  Dense kernel (in, out)             -> (out, in)
  GroupNorm / BatchNorm scale, bias  -> weight, bias
  batch_stats mean, var              -> running_mean, running_var
  frozen scale, bias, mean, var      -> the FrozenBatchNorm buffers
  head scales                        -> parameter

Every key is filled once, with its shape checked, and nothing is left
over on either side.  BatchNorm's `num_batches_tracked` counter has no
JAX counterpart and is the one key left as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_MODULE_NAMES = {"Conv_0": "conv", "ConvTranspose_0": "conv",
                 "GroupNorm_0": "norm", "BatchNorm_0": "norm"}
_LEAF_NAMES = {
    "params": {"kernel": "weight", "bias": "bias", "scale": "weight",
               "scales": "scales"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
    "frozen": {"scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var"},
}
_TORCH_ONLY = ("num_batches_tracked",)


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert(modules, leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return value
    if value.ndim == 2:                                       # Dense
        return value.T
    spatial = value.ndim - 2
    if modules[-1] == "ConvTranspose_0":
        value = np.flip(value, axis=tuple(range(spatial)))
        return value.transpose((spatial, spatial + 1) + tuple(range(spatial)))
    return value.transpose((spatial + 1, spatial) + tuple(range(spatial)))


def flax_to_state_dict(variables: Mapping) -> Dict[str, np.ndarray]:
    """{params, batch_stats, frozen} numpy tree -> {torch key: array}."""
    out = {}
    for path, value in _flatten(variables):
        collection, *modules, leaf = path
        if collection not in _LEAF_NAMES or leaf not in _LEAF_NAMES[collection]:
            raise KeyError(f"no port counterpart for {'/'.join(path)}")
        key = ".".join([_MODULE_NAMES.get(m, m) for m in modules]
                       + [_LEAF_NAMES[collection][leaf]])
        if key in out:
            raise KeyError(f"{'/'.join(path)} maps onto {key} twice")
        out[key] = np.array(_convert(modules, leaf,
                                     np.asarray(value, np.float32)),
                            order="C")
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fill ``model``'s parameters and buffers from a JAX variable tree.

    Raises on a missing or extra key, or on a shape mismatch.
    """
    arrays = flax_to_state_dict(variables)
    state = model.state_dict()
    wanted = {k for k in state if not k.endswith(_TORCH_ONLY)}
    missing = sorted(wanted - arrays.keys())
    extra = sorted(arrays.keys() - wanted)
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: port keys without a JAX "
                       f"leaf {missing}; JAX leaves without a port key "
                       f"{extra}")
    for key, value in arrays.items():
        if tuple(state[key].shape) != value.shape:
            raise ValueError(f"{key}: port shape {tuple(state[key].shape)}, "
                             f"JAX shape {value.shape}")
    with torch.no_grad():
        for key, value in arrays.items():
            state[key].copy_(torch.from_numpy(value))
