"""The port's kernels and the modules around them against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, which is held
against the JAX Pallas kernel (interpret mode) and the JAX modules around
it.  The CUDA kernels themselves are held against their plain versions in
`test_torch_port_cuda.py`.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.ops import splat_tiles as jx_splat_tiles
from mvsdet_tpu.ops import voxel_lift as jx_lift
from mvsdet_tpu.ops.pallas.lift_kernel import \
    weighted_gather_sum as jx_weighted_gather_sum
from mvsdet_tpu.ops.pallas.splat_kernel import \
    composite_tiles as jx_composite_tiles

from mvsdet_torch.ops import splat_tiles, voxel_lift
from mvsdet_torch.ops.lift_kernel import (weighted_gather_sum,
                                          weighted_gather_sum_reference)
from mvsdet_torch.ops.splat_kernel import (composite_tiles,
                                           composite_tiles_reference)


def random_tables(n_tiles, k, c, tiles_x, seed=0, empty=0.3):
    """Tile tables in the compositor's layout over a canvas `tiles_x`
    tiles wide (stacked views are more tile rows), a share `empty` of
    slots with opacity 0."""
    rng = np.random.RandomState(seed)
    rows = n_tiles // tiles_x
    data = np.zeros((n_tiles, 8, k), np.float32)
    data[:, 0] = rng.uniform(-8, tiles_x * 16 + 8, (n_tiles, k))
    data[:, 1] = rng.uniform(-8, rows * 16 + 8, (n_tiles, k))
    data[:, 2] = rng.uniform(0.02, 0.5, (n_tiles, k))
    data[:, 3] = rng.uniform(-0.02, 0.02, (n_tiles, k))
    data[:, 4] = rng.uniform(0.02, 0.5, (n_tiles, k))
    data[:, 5] = rng.uniform(0.0, 0.95, (n_tiles, k)) \
        * (rng.rand(n_tiles, k) >= empty)
    vals = rng.rand(n_tiles, c, k).astype(np.float32)
    return data, vals


def lift_inputs(seed=3, n=3, h=6, w=8, c=8, kk=2, v=48):
    """Forward-facing cameras with rotation jitter, as the JAX lift tests
    build them."""
    rng = np.random.RandomState(seed)
    feats = rng.rand(n, h, w, c).astype(np.float32)
    proj = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        ang = rng.uniform(-0.3, 0.3)
        rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                        [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
        kmat = np.array([[6.0, 0, w / 2], [0, 6.0, h / 2], [0, 0, 1]],
                        np.float32)
        proj[i, :, :3] = kmat @ rot
        proj[i, :, 3] = kmat @ rng.uniform(-0.2, 0.2, 3)
    pts = (rng.rand(v, 3) * 2 - 1).astype(np.float32)
    pts[:, 2] += 1.5
    est_depth = (rng.rand(n, h, w, kk) * 3 + 0.3).astype(np.float32)
    est_prob = rng.rand(n, h, w, kk).astype(np.float32)
    return feats, proj, est_depth, est_prob, pts


class TestCompositor:
    @pytest.mark.parametrize("n_tiles,k,c,tiles_x", [
        (6, 128, 3, 3),         # one view, 3x2 tiles
        (12, 64, 3, 2),         # three 2x2-tile views stacked on one canvas
        (4, 96, 1, 4),          # one channel (a depth render)
    ])
    def test_reference_matches_jax_kernel(self, n_tiles, k, c, tiles_x):
        data, vals = random_tables(n_tiles, k, c, tiles_x)
        want = np.asarray(jx_composite_tiles(jnp.asarray(data),
                                             jnp.asarray(vals), tiles_x,
                                             16, 16, 32))
        got = composite_tiles_reference(torch.from_numpy(data),
                                        torch.from_numpy(vals), tiles_x)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        assert want[:, :c].max() > 0.1          # the tables are not empty

    def test_wrapper_takes_plain_version_on_cpu(self):
        data, vals = random_tables(4, 32, 3, 2)
        d, v = torch.from_numpy(data), torch.from_numpy(vals)
        launches = composite_tiles.launches
        assert torch.equal(composite_tiles(d, v, 2),
                           composite_tiles_reference(d, v, 2))
        assert composite_tiles.launches == launches

    @pytest.mark.parametrize("data_shape,vals_shape", [
        ((4, 6, 32), (4, 3, 32)),               # 6 data rows, not 8
        ((4, 8, 32), (4, 3, 16)),               # K disagrees
        ((4, 8, 32), (2, 3, 32)),               # tile counts disagree
    ])
    def test_wrapper_rejects_bad_shapes(self, data_shape, vals_shape):
        with pytest.raises(ValueError):
            composite_tiles(torch.zeros(data_shape), torch.zeros(vals_shape),
                            2)


def random_cloud(g=96, seed=0, spread=0.8):
    rng = np.random.RandomState(seed)
    means = np.zeros((g, 3), np.float32)
    means[:, 0] = rng.uniform(-spread, spread, g)
    means[:, 1] = rng.uniform(-spread, spread, g)
    means[:, 2] = rng.uniform(1.0, 4.0, g)
    a = rng.randn(g, 3, 3).astype(np.float32) * 0.05
    covs = np.einsum("gij,gkj->gik", a, a) + 1e-4 * np.eye(3, dtype=np.float32)
    harm = (rng.randn(g, 3, 4) * 0.3).astype(np.float32)
    op = rng.uniform(0.2, 0.95, g).astype(np.float32)
    return means, covs, harm, op


def cameras(n_views, seed=0):
    """(T, 4, 4) c2w looking at the cloud from around the origin, and
    (T, 3, 3) normalised intrinsics."""
    rng = np.random.RandomState(seed)
    c2ws, ks = [], []
    for _ in range(n_views):
        eye = rng.uniform(-0.2, 0.2, 3)
        fwd = np.array([0.0, 0.05, 2.5]) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, np.cross(fwd, right), fwd
        c2w[:3, 3] = eye
        c2ws.append(c2w)
        f = rng.uniform(0.9, 1.1)
        ks.append([[f, 0, 0.5], [0, f, 0.5], [0, 0, 1]])
    return np.asarray(c2ws, np.float32), np.asarray(ks, np.float32)


class TestTiledRenderer:
    @pytest.mark.parametrize("shape,n_views,g,capacity", [
        ((32, 48), 1, 96, 128),     # capacity above G: padded slots
        ((30, 41), 2, 96, 32),      # not a multiple of 16; stacked canvas
        ((20, 24), 3, 160, 64),     # three targets, tiles overflow
    ])
    def test_render_views_tiled_matches_jax(self, shape, n_views, g,
                                            capacity):
        cloud = random_cloud(g, seed=n_views)
        c2ws, ks = cameras(n_views, seed=g)
        bg = np.asarray([0.1, 0.2, 0.3], np.float32)
        want = np.asarray(jax.jit(
            lambda *a: jx_splat_tiles.render_views_tiled(
                *a, shape, background=jnp.asarray(bg), capacity=capacity))(
            *cloud, c2ws, ks))
        got = splat_tiles.render_views_tiled(
            *map(torch.from_numpy, cloud), torch.from_numpy(c2ws),
            torch.from_numpy(ks), shape, background=torch.from_numpy(bg),
            capacity=capacity)
        assert got.shape == (n_views,) + shape + (3,)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_tile_tables_match_jax(self):
        means, covs, harm, op = random_cloud(80, seed=7)
        c2ws, ks = cameras(1, seed=7)
        vals = np.random.RandomState(7).rand(80, 3).astype(np.float32)
        args = (means, covs, vals, op, c2ws[0], ks[0])
        want = jax.jit(lambda *a: jx_splat_tiles._tile_tables(
            *a, (30, 40), 48, 0.2))(*args)
        got = splat_tiles._tile_tables(*map(torch.from_numpy, args),
                                       (30, 40), 48, 0.2)
        for w, t in zip(want, got):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)


class TestLift:
    def test_reference_matches_jax_kernel(self):
        rng = np.random.RandomState(0)
        n, hw, c, v = 3, 20, 8, 300
        feat = rng.rand(n, hw, c).astype(np.float32)
        pix = rng.randint(0, hw, (n, v)).astype(np.int32)
        weight = (rng.rand(n, v) * (rng.rand(n, v) < 0.5)).astype(np.float32)
        want = np.asarray(jx_weighted_gather_sum(*map(jnp.asarray,
                                                      (feat, pix, weight))))
        got = weighted_gather_sum_reference(
            *map(torch.from_numpy, (feat, pix, weight)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    def test_wrapper_takes_plain_version_on_cpu(self):
        rng = np.random.RandomState(1)
        feat = torch.from_numpy(rng.rand(2, 6, 4).astype(np.float32))
        pix = torch.from_numpy(rng.randint(0, 6, (2, 5)).astype(np.int32))
        weight = torch.from_numpy(rng.rand(2, 5).astype(np.float32))
        launches = weighted_gather_sum.launches
        assert torch.equal(weighted_gather_sum(feat, pix, weight),
                           weighted_gather_sum_reference(feat, pix, weight))
        assert weighted_gather_sum.launches == launches

    def test_wrapper_rejects_int64_pix(self):
        with pytest.raises(TypeError):
            weighted_gather_sum(torch.zeros(2, 6, 4),
                                torch.zeros(2, 5, dtype=torch.int64),
                                torch.zeros(2, 5))

    @pytest.mark.parametrize("v", [48, 37])
    def test_pixel_weights_bit_equal_to_jax_scan(self, v):
        feats, proj, est_depth, est_prob, pts = lift_inputs(v=v)
        prob_norm = est_prob / (est_prob.sum(-1, keepdims=True) + 1e-12)

        def scan(proj, d, p, pts):
            def body(_, xs):
                return None, jx_lift._pixel_weights(*xs, pts, 0.4, 6, 8)
            return jax.lax.scan(body, None, (proj, d, p))[1]

        want = jax.jit(scan)(proj, est_depth, prob_norm, pts)
        got = voxel_lift._pixel_weights(
            *map(torch.from_numpy, (proj, est_depth, prob_norm, pts)), 0.4)
        for w, t in zip(want, got):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
        assert got[2].any() and not got[2].all()

    @pytest.mark.parametrize("jax_lift", ["xla", "pallas"])
    def test_lift_matches_jax(self, jax_lift):
        feats, proj, est_depth, est_prob, pts = lift_inputs()
        fn = (jx_lift.lift_features_to_voxels if jax_lift == "xla"
              else jx_lift.lift_features_to_voxels_pallas)
        vol_j, cnt_j = fn(*map(jnp.asarray, (feats, proj, est_depth,
                                             est_prob, pts)), 0.4)
        vol_t, cnt_t = voxel_lift.lift_features_to_voxels(
            *map(torch.from_numpy, (feats, proj, est_depth, est_prob, pts)),
            0.4)
        assert vol_t.dtype == torch.float32
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        np.testing.assert_allclose(vol_t.numpy(), np.asarray(vol_j),
                                   atol=1e-5, rtol=1e-5)
        assert np.abs(np.asarray(vol_j)).max() > 0
        want = np.asarray(jx_lift.finalize_volume(vol_j, cnt_j))
        np.testing.assert_allclose(
            voxel_lift.finalize_volume(vol_t, cnt_t).numpy(), want,
            atol=1e-5, rtol=1e-5)
