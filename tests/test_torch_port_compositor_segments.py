"""The arithmetic of the compositor's CUDA kernels, held on the CPU.

The CUDA kernels (`mvsdet_torch/ops/csrc/composite_tiles*.cu`) split K into
segments, combine the segments' partials in order, start the backward of
every segment from a state derived from those partials, and skip pairs
outside a per-slot cull box.  Their plain rebuilds in
`mvsdet_torch/ops/splat_kernel.py` are held here against the plain
compositor, its autograd backward and the JAX Pallas kernel (interpret
mode), over 1, 3 and 8 segments and a ragged last segment; the cull boxes
are held against the plain compositor's active mask (on the box-edge tables
of `test_torch_port_cuda.py`, which holds the kernels' own boxes on the
card).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.ops.pallas.splat_kernel import \
    composite_tiles as jx_composite_tiles

from mvsdet_torch.ops import build
from mvsdet_torch.ops.splat_kernel import (
    PIXELS, SEGMENT, _pairs, combine_segments_reference,
    composite_tiles_bwd_reference, composite_tiles_bwd_segmented_reference,
    composite_tiles_reference, cull_boxes_reference,
    segment_partials_reference, segment_states_reference)

from test_torch_port_cuda import pairs_outside_box, stress_tables
from test_torch_port_kernels import random_tables

# (n_tiles, K, C, tiles_x, segment)
SEGMENT_CASES = [
    (6, 64, 3, 3, 64),          # one segment
    (6, 96, 3, 3, 32),          # three segments
    (4, 256, 1, 2, 32),         # eight segments, one channel
    (8, 100, 4, 4, 32),         # a ragged last segment of 4 slots
    (4, 300, 2, 2, SEGMENT),    # the kernels' segment, ragged (2 x 128 + 44)
]


def rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def inputs(n_tiles, k, c, tiles_x):
    """Random tables with an eighth of the slots clipped at alpha 0.99 and
    a cotangent whose transmittance row is not 0."""
    data, vals = random_tables(n_tiles, k, c, tiles_x, seed=k)
    rng = np.random.RandomState(c)
    data[:, 5, :k // 8] = rng.uniform(1.0, 1.5, (n_tiles, k // 8))
    g = rng.randn(n_tiles, c + 1, PIXELS).astype(np.float32)
    return data, vals, g


@pytest.mark.parametrize("n_tiles,k,c,tiles_x,segment", SEGMENT_CASES)
def test_segmented_forward_matches_plain_and_jax(n_tiles, k, c, tiles_x,
                                                 segment):
    data, vals, _ = inputs(n_tiles, k, c, tiles_x)
    partials = segment_partials_reference(torch.from_numpy(data),
                                          torch.from_numpy(vals), tiles_x,
                                          segment)
    assert partials.shape == (n_tiles, -(-k // segment), c + 1, PIXELS)
    got = combine_segments_reference(partials).numpy()
    want = composite_tiles_reference(torch.from_numpy(data),
                                     torch.from_numpy(vals), tiles_x).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    jx = np.asarray(jx_composite_tiles(jnp.asarray(data), jnp.asarray(vals),
                                       tiles_x, 16, 16, 32))
    np.testing.assert_allclose(got, jx, atol=1e-5, rtol=1e-5)
    assert want[:, :c].max() > 0.1 and want[:, c].min() < 0.5


@pytest.mark.parametrize("n_tiles,k,c,tiles_x,segment", SEGMENT_CASES)
def test_segment_start_states_match_the_whole_walk(n_tiles, k, c, tiles_x,
                                                   segment):
    """Start log-T = the exclusive log-T at the segment's first slot, and
    start suffix = sum of w_j u_j over every later segment + g_T T_final,
    both read off the unsegmented plain compositor."""
    data, vals, g = map(torch.from_numpy, inputs(n_tiles, k, c, tiles_x))
    pre, start = segment_states_reference(
        segment_partials_reference(data, vals, tiles_x, segment), g)
    alpha = _pairs(data, tiles_x)[-1].double()
    lt = torch.log1p(-alpha)
    cum = torch.cumsum(lt, dim=2)
    w = torch.exp(cum - lt) * alpha
    wu = w * torch.einsum("tck,tcp->tpk", vals.double(), g[:, :c].double())
    tail = g[:, c].double() * torch.exp(cum[..., -1])
    for s, b in enumerate(range(0, k, segment)):
        want_pre = (cum - lt)[..., b]
        want_start = wu[..., b + segment:].sum(dim=2) + tail
        assert (pre[:, s].double() - want_pre).abs().max() <= 1e-5 \
            * max(1.0, want_pre.abs().max().item())
        assert (start[:, s].double() - want_start).abs().max() <= 1e-5 \
            * want_start.abs().max()


@pytest.mark.parametrize("n_tiles,k,c,tiles_x,segment", SEGMENT_CASES)
def test_segmented_backward_matches_plain_and_jax(n_tiles, k, c, tiles_x,
                                                  segment):
    data, vals, g = inputs(n_tiles, k, c, tiles_x)
    got = composite_tiles_bwd_segmented_reference(
        *map(torch.from_numpy, (data, vals, g)), tiles_x, segment)
    want = composite_tiles_bwd_reference(
        *map(torch.from_numpy, (data, vals, g)), tiles_x)
    _, vjp = jax.vjp(lambda d, v: jx_composite_tiles(d, v, tiles_x, 16, 16,
                                                     32),
                     jnp.asarray(data), jnp.asarray(vals))
    jx = vjp(jnp.asarray(g))
    for name, a, b, j in zip(("ddata", "dvals"), got, want, jx):
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5, name
        assert rel_err(a.numpy(), j) <= 1e-5, name
    assert torch.all(got[0][:, 6:] == 0)
    assert got[0][:, :6].abs().max() > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_boxes_hold_every_active_pair(seed):
    data = torch.from_numpy(stress_tables(12, 512, 4, seed))
    outside, active, in_box = pairs_outside_box(data, 4)
    assert outside == 0
    assert active > 1000
    assert in_box < 0.5                     # the boxes do cull


def test_cull_boxes_on_random_and_clipped_tables():
    data, _, _ = inputs(8, 300, 3, 4)
    outside, active, in_box = pairs_outside_box(torch.from_numpy(data), 4)
    assert outside == 0 and active > 1000 and in_box < 0.2


def test_cull_box_is_unbounded_where_it_cannot_be_trusted():
    rows = np.array([
        # mx,  my,   a,     b,     c,    op
        [8.0, 8.0, 0.1, 0.0, 0.1, 0.5],       # a proper splat: bounded
        [8.0, 8.0, -0.1, 0.0, 0.1, 0.5],      # a < 0
        [8.0, 8.0, 0.1, 0.2, 0.1, 0.5],       # det < 0
        [8.0, 8.0, 0.1, 0.09999, 0.1, 0.5],   # cond = ac / det > 1e3
        [np.inf, 8.0, 0.1, 0.0, 0.1, 0.5],    # not finite
        [8.0, 8.0, 0.1, 0.0, np.nan, 0.5],
        [8.0, 8.0, 0.1, 0.0, 0.1, 0.003],     # below the cutoff: dropped
        [8.0, 8.0, 0.1, 0.0, 0.1, 0.0],       # an empty slot: dropped
    ], np.float32)
    data = np.zeros((1, 8, len(rows)), np.float32)
    data[0, :6] = rows.T
    keep, box = cull_boxes_reference(torch.from_numpy(data))
    assert keep[0].tolist() == [True] * 6 + [False] * 2
    assert torch.isfinite(box[0, :, 0]).all()
    # level 2.02 ln(0.5 * 255) + 1e-5 over a = c = 0.1, plus one pixel
    half = np.sqrt((2.02 * np.log(0.5 / np.float32(1 / 255)) + 1e-5) / 0.1) \
        + 1.0
    np.testing.assert_allclose(box[0, :, 0].numpy(),
                               [8 - half, 8 + half, 8 - half, 8 + half],
                               rtol=1e-6)
    for j in range(1, 6):
        assert box[0, :, j].tolist() == [-np.inf, np.inf, -np.inf, np.inf]


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """An edited header must not be served by a library built before."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "k.cuh").write_text("// two\n")
    assert build.library_path("k") != first
    assert first.name.startswith("k-") and first.suffix == ".so"
