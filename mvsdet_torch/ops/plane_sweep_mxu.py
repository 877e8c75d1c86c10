"""Plane-sweep warp as two shear-resampling matrix products.

Port of mvsdet_tpu/ops/plane_sweep_mxu.py, the JAX package's default
sweep (`MVSDet(sweep_method="mxu")`).  The per-plane homography

  x_s = (m00 x' + m01 y' + m02) / D,   y_s = (m10 x' + m11 y' + m12) / D,
  D = m20 x' + m21 y' + m22

splits into two 1D resamplings (Catmull-Smith).  Pass 1 resamples each
source row y horizontally at Xp(x', y), which is affine in y:

  Xp(x', y) = (p y + q) / r,  A = m10 x' + m12, B = m20 x' + m22,
  C = m00 x' + m02,  r = m21 A - m11 B,  p = C m21 - m01 B,
  q = m01 A - C m11;

pass 2 resamples the intermediate image vertically at y_s, a Mobius
function of y' per output column.  Each pass is a linear interpolation
whose weights form (rows x out) matrices with two nonzeros per column,
so each warp is two batched matrix products (cuBLAS on the card).  The
result is a different discretisation of the same continuous warp than
the bilinear gather of `plane_sweep.py`: the two differ by
O(shear x feature gradient).

Zero padding: a sample position outside [0, size - 1] gets zero weight
for each tap that falls outside, as `bilinear_sample` does.  Degenerate
columns (|r| < 1e-9, the projective pole) are pushed to -1e6 and get
zero weights; a behind-camera row's sign-flipped denominator lands it
far out of range.

The geometry is float32 (TF32 off).  With a bfloat16 ``compute_dtype``
the interpolation weights, the source features and the intermediate
image are rounded to bf16, each product accumulates in float32 and is
rounded once to bf16, and the warped volume comes back in the features'
dtype, as the JAX module computes it.  On the CPU a bf16 product is the
float32 product of the bf16 operands rounded once (ROADMAP T17).  Only
the features are differentiable: the homographies come from the poses
and constant depths, so autograd of the two products is the whole
backward.  Layout is channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch

from mvsdet_torch.utils.precision import feinsum


def _interp_matrix(positions: torch.Tensor, size: int) -> torch.Tensor:
    """Linear-interpolation weights out[..., src, out_idx] =
    max(0, 1 - |positions[..., out_idx] - src|): two nonzeros per column,
    all-zero columns for positions beyond one pixel outside [0, size - 1].

    Args:
      positions: (..., n_out) fractional source positions.
      size: source length.

    Returns:
      (..., size, n_out).
    """
    src = torch.arange(size, dtype=positions.dtype, device=positions.device)
    d = positions[..., None, :] - src[:, None]
    # torch.maximum, not clamp: its gradient splits at a tie as JAX's
    # does (ROADMAP T20)
    return torch.maximum(torch.zeros((), dtype=d.dtype, device=d.device),
                         1.0 - d.abs())


def _product(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`feinsum` of two operands of one dtype, in that dtype; a bf16
    product on the CPU is the float32 product of the operands rounded
    once (T17)."""
    if a.device.type == "cpu" and a.dtype != torch.float32:
        return feinsum(equation, a.float(), b.float()).to(a.dtype)
    return feinsum(equation, a, b)


def _warp(src_feat: torch.Tensor, homographies: torch.Tensor,
          out_dtype: torch.dtype) -> torch.Tensor:
    """`homography_warp_mxu` for a batch of warps: (B, H, W, C) sources
    and (B, D, 3, 3) homographies -> (B, D, H, W, C)."""
    _, h, w, _ = src_feat.shape
    f32 = torch.float32
    dev = src_feat.device
    m = homographies.to(f32)

    def entry(i, j):                                         # (B, D, 1)
        return m[..., i, j, None]

    xs_out = torch.arange(w, dtype=f32, device=dev)
    ys_src = torch.arange(h, dtype=f32, device=dev)
    ys_out = torch.arange(h, dtype=f32, device=dev)

    # per (plane, x'): A, B, C
    a = entry(1, 0) * xs_out + entry(1, 2)                   # (B, D, W)
    b = entry(2, 0) * xs_out + entry(2, 2)
    cc = entry(0, 0) * xs_out + entry(0, 2)

    # pass 1, horizontal: Xp(x', y) = (p y + q) / r
    r = entry(2, 1) * a - entry(1, 1) * b                    # (B, D, W)
    p = cc * entry(2, 1) - entry(0, 1) * b
    q = entry(0, 1) * a - cc * entry(1, 1)
    pole = r.abs() < 1e-9
    r_safe = torch.where(pole, 1e-9, r)
    xp = (p[..., None, :] * ys_src[:, None] + q[..., None, :]) \
        / r_safe[..., None, :]                               # (B, D, H, W')
    xp = torch.where(pole[..., None, :], -1e6, xp)
    w1 = _interp_matrix(xp, w).to(out_dtype)            # (B, D, H, Ws, W')
    t = _product("bdysx,bysc->bdyxc", w1, src_feat.to(out_dtype))

    # pass 2, vertical: y_s(x', y') Mobius in y'
    denom = b[..., None] + entry(2, 1)[..., None] * ys_out  # (B, D, W', H')
    denom_safe = torch.where(denom.abs() < 1e-9, 1e-9, denom)
    ysamp = (a[..., None] + entry(1, 1)[..., None] * ys_out) / denom_safe
    w2 = _interp_matrix(ysamp, h).to(out_dtype)         # (B, D, W', Hs, H')
    out = _product("bdxsy,bdsxc->bdyxc", w2, t)
    return out.to(src_feat.dtype)


def homography_warp_mxu(src_feat: torch.Tensor, homographies: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Warp one source feature map onto D depth planes by two products.

    Args:
      src_feat: (H, W, C) source-view features.
      homographies: (D, 3, 3) per-plane maps M with
        [x_s, y_s, w]^T ~ M [x', y', 1]^T.
      out_dtype: dtype of the interpolation products' operands and
        results (they accumulate in float32).

    Returns:
      (D, H, W, C) warped volume in ``src_feat``'s dtype.
    """
    return _warp(src_feat[None], homographies[None], out_dtype)[0]


def plane_homographies(rel_proj: torch.Tensor,
                       depth_values: torch.Tensor) -> torch.Tensor:
    """Per-plane homographies M_d = d * R with the translation added to
    the last column (p = d * R [x, y, 1] + t, module.py:127-135).

    Args:
      rel_proj: (..., 4, 4) src_proj @ inv(ref_proj).
      depth_values: (D,).

    Returns:
      (..., D, 3, 3).
    """
    rot = rel_proj[..., None, :3, :3]
    trans = rel_proj[..., None, :3, 3]
    m = depth_values[:, None, None] * rot
    return torch.cat([m[..., :2], m[..., 2:] + trans[..., None]], dim=-1)


def plane_sweep_variance_mxu(features: torch.Tensor, proj: torch.Tensor,
                             ref_ids: torch.Tensor,
                             neighbor_ids: torch.Tensor,
                             depth_values: torch.Tensor,
                             compute_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """Variance cost volume through the two-product warp (the drop-in for
    `plane_sweep.plane_sweep_variance_for_refs`).  The chunk's M·k warps
    run as one batch, as the JAX function vmaps over them.

    Args:
      features: (N, H, W, C) all views' features (the neighbour pool);
      proj: (N, 4, 4) full projections at feature resolution;
      ref_ids: (M,); neighbor_ids: (M, k) into the full view set;
      depth_values: (D,); compute_dtype: the warp's `out_dtype`.

    Returns:
      (M, D, H, W, C) variance volumes in the features' dtype.
    """
    m, k = neighbor_ids.shape
    inv_ref = torch.linalg.inv_ex(proj[ref_ids]).inverse     # (M, 4, 4)
    rel = feinsum("mkij,mjl->mkil", proj[neighbor_ids], inv_ref)
    homos = plane_homographies(rel.reshape(m * k, 4, 4), depth_values)
    warped = _warp(features[neighbor_ids.reshape(-1)], homos, compute_dtype)
    warped = warped.reshape((m, k) + warped.shape[1:])  # (M, k, D, H, W, C)

    ref = features[ref_ids][:, None]
    s = ref + warped.sum(dim=1)
    sq = ref**2 + (warped**2).sum(dim=1)
    inv_m = 1.0 / (k + 1)
    mean = s * inv_m
    return sq * inv_m - mean**2
