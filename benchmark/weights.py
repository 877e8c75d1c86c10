"""Random weights from the seed, drawn on the card in a few calls.

The scheme is the one `mvsdet_torch.models.mvsdet.init_weights` (at
commit dafa6b3) copies from flax: every convolution and dense kernel
lecun-normal truncated at two standard deviations, zero biases; norms
keep their unit scales and zero shifts.  The detection head's class bias
is the traffic's: the prior -4.595 (probability 0.01) that training
starts from, or for predict a bias at which every valid point scores
well above the score threshold, as a trained model's top points do in a
furnished room, so that the NMS gets its full `nms_pre` candidates a
level on every seed.  With ``fixed_splat_scales`` the Gaussian head's
three scale logits are drawn at 0 (their rows of `to_gaussians` zeroed):
every seed's splats then take the same footprint at a given depth, so
that the renderer's backward, whose cost follows how full the 16x16
tiles are, does the same work on every seed.  Here all kernels come from one draw of a
truncated unit normal on the model's device, scaled per kernel by one
`_foreach_mul_`, so that set-up draws no weight on the host and launches
a handful of kernels, not one per leaf.  The program's model and the
reference's (the same module tree) get the same values from the same
seed and device.
"""

from __future__ import annotations

import torch
from torch import nn

TRUNC_STD = 0.87962566103423978    # std of a unit normal cut to [-2, 2]


def _kernels(model: nn.Module):
    """(weights, their stds, biases) of every conv and dense layer, in
    module order."""
    weights, stds, biases = [], [], []
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d,
                            nn.Linear)):
            w = mod.weight
            in_ch = w.shape[0] if isinstance(mod, nn.ConvTranspose3d) \
                else w.shape[1]
            weights.append(w)
            stds.append((in_ch * w[0, 0].numel()) ** -0.5 / TRUNC_STD)
            if mod.bias is not None:
                biases.append(mod.bias)
    return weights, stds, biases


def traffic_weights(traffic: dict) -> dict:
    """The keyword arguments of `draw_weights` that a traffic file sets."""
    return dict(class_bias=traffic["class_bias"],
                fixed_splat_scales=traffic["fixed_splat_scales"])


@torch.no_grad()
def draw_weights(model: nn.Module, seed: int, class_bias: float,
                 fixed_splat_scales: bool = False) -> None:
    """Overwrite ``model``'s conv and dense weights and biases in place
    with the draw of ``seed``, on the device the model lives on, the
    head's class bias set to ``class_bias``; with ``fixed_splat_scales``
    the Gaussian head's scale logits drawn at 0."""
    weights, stds, biases = _kernels(model)
    device = weights[0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(w.numel() for w in weights), device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    parts = list(flat.split([w.numel() for w in weights]))
    torch._foreach_mul_(parts, stds)
    torch._foreach_copy_(weights, [p.view_as(w) for p, w in
                                   zip(parts, weights)])
    torch._foreach_zero_(biases)
    head = getattr(model, "head", None)
    if head is not None and hasattr(head, "conv_cls"):
        head.conv_cls.bias.fill_(class_bias)
    if fixed_splat_scales:
        # raw = (offset x, y, 3 scale logits, ...) of each pixel's splat
        model.to_gaussians.proj.weight[2:5].zero_()
        model.to_gaussians.proj.bias[2:5].zero_()
