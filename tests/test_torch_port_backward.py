"""The port's backward kernels' plain versions, and the gradients of the
modules around them, against the JAX package.

On the CPU `composite_tiles` and `weighted_gather_sum` go through their
autograd Functions with the plain backward versions, which are held
against `jax.vjp` of the JAX kernels (their Pallas backward kernels run
in interpret mode).  The CUDA backward kernels are held against the plain
versions in `test_torch_port_cuda.py`.
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
from mvsdet_torch.ops.lift_kernel import (
    weighted_gather_sum, weighted_gather_sum_dfeat,
    weighted_gather_sum_dfeat_reference, weighted_gather_sum_dweight,
    weighted_gather_sum_dweight_reference)
from mvsdet_torch.ops.splat_kernel import (composite_tiles,
                                           composite_tiles_bwd,
                                           composite_tiles_bwd_reference)

from test_torch_port_kernels import cameras, lift_inputs, random_cloud, \
    random_tables


def rel_err(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


class TestCompositorBackward:
    @pytest.mark.parametrize("n_tiles,k,c,tiles_x,k_chunk", [
        (6, 64, 3, 3, 32),      # K = 2 chunks of the JAX kernel
        (8, 96, 1, 2, 32),      # one channel, four stacked 2x1-tile views
        (4, 128, 4, 4, 64),     # four channels
    ])
    def test_plain_backward_matches_jax_kernel(self, n_tiles, k, c, tiles_x,
                                               k_chunk):
        data, vals = random_tables(n_tiles, k, c, tiles_x, seed=k)
        rng = np.random.RandomState(c)
        data[:, 5, :k // 8] = rng.uniform(1.0, 1.5, (n_tiles, k // 8))
        g = rng.randn(n_tiles, c + 1, 256).astype(np.float32)   # g_T != 0
        _, vjp = jax.vjp(lambda d, v: jx_composite_tiles(
            d, v, tiles_x, 16, 16, k_chunk), jnp.asarray(data),
            jnp.asarray(vals))
        want = vjp(jnp.asarray(g))
        got = composite_tiles_bwd_reference(
            *map(torch.from_numpy, (data, vals, g)), tiles_x)
        for name, t, w in zip(("ddata", "dvals"), got, want):
            assert rel_err(t.numpy(), w) <= 1e-4, name
        assert np.all(np.asarray(want[0])[:, 6:] == 0)
        assert np.abs(np.asarray(want[0])[:, :6]).max() > 0

    def test_clipped_and_culled_slots(self):
        """Clipped slots (alpha_un >= 0.99) pass no gradient to the
        conic, mean or opacity but still to their values; culled slots
        (opacity 0) pass none at all."""
        data, vals = random_tables(2, 32, 3, 2, seed=9, empty=0.0)
        data[:, 0], data[:, 1] = 16.0, 8.0       # every splat on the tile
        data[:, 2], data[:, 3], data[:, 4] = 1e-4, 0.0, 1e-4    # flat
        data[:, 5, :8] = 2.0                     # clipped
        data[:, 5, 8:16] = 0.0                   # culled
        g = np.random.RandomState(9).randn(2, 4, 256).astype(np.float32)
        ddata, dvals = composite_tiles_bwd_reference(
            *map(torch.from_numpy, (data, vals, g)), 2)
        _, vjp = jax.vjp(lambda d, v: jx_composite_tiles(d, v, 2, 16, 16, 16),
                         jnp.asarray(data), jnp.asarray(vals))
        want_d, want_v = map(np.asarray, vjp(jnp.asarray(g)))
        assert rel_err(ddata.numpy(), want_d) <= 1e-4
        assert rel_err(dvals.numpy(), want_v) <= 1e-4
        assert np.all(want_d[:, :6, :8] == 0)
        assert np.all(want_d[:, :, 8:16] == 0)
        assert np.abs(want_v[:, :, :8]).min() > 0
        assert np.all(want_v[:, :, 8:16] == 0)

    def test_autograd_function_runs_plain_backward_on_cpu(self):
        data, vals = random_tables(4, 32, 3, 2)
        g = torch.from_numpy(np.random.RandomState(1).randn(4, 4, 256)
                             .astype(np.float32))
        d = torch.from_numpy(data).requires_grad_(True)
        v = torch.from_numpy(vals).requires_grad_(True)
        launches = (composite_tiles.launches, composite_tiles_bwd.launches)
        composite_tiles(d, v, 2).backward(g)
        want = composite_tiles_bwd(d.detach(), v.detach(), g, 2)
        assert torch.equal(d.grad, want[0]) and torch.equal(v.grad, want[1])
        assert (composite_tiles.launches, composite_tiles_bwd.launches) \
            == launches

    def test_backward_rejects_a_cotangent_of_the_wrong_shape(self):
        with pytest.raises(ValueError):
            composite_tiles_bwd(torch.zeros(2, 8, 16), torch.zeros(2, 3, 16),
                                torch.zeros(2, 3, 256), 2)


class TestLiftBackward:
    def _inputs(self, seed=0, n=3, hw=20, c=8, v=300):
        rng = np.random.RandomState(seed)
        feat = rng.rand(n, hw, c).astype(np.float32)
        pix = rng.randint(0, hw, (n, v)).astype(np.int32)
        weight = (rng.rand(n, v) * (rng.rand(n, v) < 0.5)).astype(np.float32)
        g = rng.randn(v, c).astype(np.float32)
        return feat, pix, weight, g

    def test_plain_backward_matches_jax_kernels(self):
        feat, pix, weight, g = self._inputs()
        _, vjp = jax.vjp(lambda f, w: jx_weighted_gather_sum(
            f, jnp.asarray(pix), w), jnp.asarray(feat), jnp.asarray(weight))
        want_f, want_w = vjp(jnp.asarray(g))
        t_pix, t_w, t_g = map(torch.from_numpy, (pix, weight, g))
        dfeat = weighted_gather_sum_dfeat_reference(t_pix, t_w, t_g, 20)
        dw = weighted_gather_sum_dweight_reference(torch.from_numpy(feat),
                                                   t_pix, t_g)
        assert rel_err(dfeat.numpy(), want_f) <= 1e-5
        assert rel_err(dw.numpy(), want_w) <= 1e-5
        # d-weight covers the zero-weight pairs too, as `_dweight_kernel`
        assert np.abs(dw.numpy()[weight == 0]).max() > 0

    def test_autograd_function_runs_plain_backward_on_cpu(self):
        feat, pix, weight, g = map(torch.from_numpy, self._inputs(seed=1))
        f = feat.clone().requires_grad_(True)
        w = weight.clone().requires_grad_(True)
        launches = (weighted_gather_sum.launches,
                    weighted_gather_sum_dfeat.launches,
                    weighted_gather_sum_dweight.launches)
        weighted_gather_sum(f, pix, w).backward(g)
        assert torch.equal(f.grad, weighted_gather_sum_dfeat(pix, weight, g,
                                                             20))
        assert torch.equal(w.grad, weighted_gather_sum_dweight(feat, pix, g))
        assert (weighted_gather_sum.launches,
                weighted_gather_sum_dfeat.launches,
                weighted_gather_sum_dweight.launches) == launches

    def test_lift_gradients_match_jax_with_tied_hypotheses(self):
        """Gradients reach the features and the probabilities, and where
        two in-window hypotheses tie, `amax` splits the gradient evenly,
        as JAX's `max` does."""
        feats, proj, est_depth, est_prob, pts = lift_inputs(c=8)
        est_prob[..., 1] = est_prob[..., 0]                 # ties everywhere
        est_depth[..., 1] = est_depth[..., 0] + 0.05        # both in-window
        target = np.random.RandomState(4).randn(pts.shape[0], 8) \
            .astype(np.float32)

        def jx_loss(f, p):
            vol, cnt = jx_lift.lift_features_to_voxels(
                f, jnp.asarray(proj), jnp.asarray(est_depth), p,
                jnp.asarray(pts), 0.4)
            return jnp.sum(jx_lift.finalize_volume(vol, cnt) * target)

        want = jax.grad(jx_loss, argnums=(0, 1))(jnp.asarray(feats),
                                                 jnp.asarray(est_prob))
        f = torch.from_numpy(feats).requires_grad_(True)
        p = torch.from_numpy(est_prob).requires_grad_(True)
        vol, cnt = voxel_lift.lift_features_to_voxels(
            f, torch.from_numpy(proj), torch.from_numpy(est_depth), p,
            torch.from_numpy(pts), 0.4)
        (voxel_lift.finalize_volume(vol, cnt)
         * torch.from_numpy(target)).sum().backward()
        assert rel_err(f.grad.numpy(), want[0]) <= 1e-5
        assert rel_err(p.grad.numpy(), want[1]) <= 1e-5
        assert np.abs(np.asarray(want[1])).max() > 0


class TestRendererBackward:
    def test_gradients_match_jax(self):
        means, covs, harm, op = random_cloud(64, seed=3)
        c2ws, ks = cameras(2, seed=3)
        target = np.random.RandomState(3).rand(2, 30, 41, 3) \
            .astype(np.float32)
        bg = np.asarray([0.1, 0.2, 0.3], np.float32)

        def jx_loss(*cloud):
            img = jx_splat_tiles.render_views_tiled(
                *cloud, c2ws, ks, (30, 41), background=jnp.asarray(bg),
                capacity=32)
            return jnp.mean((img - target) ** 2)

        want = jax.jit(jax.grad(jx_loss, argnums=(0, 1, 2, 3)))(
            means, covs, harm, op)
        cloud = [torch.from_numpy(a).requires_grad_(True)
                 for a in (means, covs, harm, op)]
        img = splat_tiles.render_views_tiled(
            *cloud, torch.from_numpy(c2ws), torch.from_numpy(ks), (30, 41),
            background=torch.from_numpy(bg), capacity=32)
        torch.mean((img - torch.from_numpy(target)) ** 2).backward()
        for name, t, w in zip(("means", "covariances", "harmonics",
                               "opacities"), cloud, want):
            assert rel_err(t.grad.numpy(), w) <= 1e-4, name

    @pytest.mark.parametrize("n_ch", [1, 2])
    def test_values_override_with_other_channel_counts(self, n_ch):
        """A C != 3 value (a depth, say) renders through the same path:
        the compositor output is reshaped by C + 1, not by a literal 4."""
        means, covs, harm, op = random_cloud(80, seed=n_ch)
        c2ws, ks = cameras(2, seed=n_ch)
        values = np.random.RandomState(n_ch).rand(2, 80, n_ch) \
            .astype(np.float32)
        want = np.asarray(jax.jit(
            lambda *a: jx_splat_tiles.render_views_tiled(
                *a, (30, 41), capacity=48, values_override=values))(
            means, covs, harm, op, c2ws, ks))
        got = splat_tiles.render_views_tiled(
            *map(torch.from_numpy, (means, covs, harm, op, c2ws, ks)),
            (30, 41), capacity=48, values_override=torch.from_numpy(values))
        assert got.shape == (2, 30, 41, n_ch)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        assert want.max() > 0.1
