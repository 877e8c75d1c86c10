"""The port's ops-level entry points and its last modules, against JAX.

At tiny sizes (a few hundred Gaussians, 32x32 to 32x48 images, one shape
not a multiple of 16):

- the dense exact renderer `ops/splat.py` `render_view` (colour,
  `value_override`, a background, chunked pixels) and `render_views`
  against JAX's, to 1e-5; its gradients against `jax.grad` of the same
  scalar, to 1e-4 of each leaf's largest;
- `ops/splat_tiles.py` `render_view_tiled` (the compositor's plain
  version on the CPU) against JAX's (Pallas in interpret mode), to 1e-5,
  and against the port's dense renderer to 1e-3, the tolerance JAX's own
  test holds (`tests/test_splat_tiled.py`);
- `ops/plane_sweep.py` `homography_warp` in both modes, and
  `torch_grid_sample_skew`, against JAX's, to 1e-5; the torch-compatible
  mode against `F.grid_sample` on the grid the reference's `homo_warping`
  builds (module.py:105-146); `plane_sweep_variance` against JAX's;
- `MVSDet` with `splat_impl="dense"` against the port's own tiled model
  (no JAX compile): predict with its diagnostics, and one loss and its
  gradients;
- `utils/profiling.py`'s `timed` and `hard_sync` on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mvsdet_tpu.ops import plane_sweep as jx_plane_sweep
from mvsdet_tpu.ops import sampling as jx_sampling
from mvsdet_tpu.ops import splat as jx_splat
from mvsdet_tpu.ops import splat_tiles as jx_splat_tiles

from mvsdet_torch.config import tiny_test_config
from mvsdet_torch.data.synthetic import make_synthetic_scene
from mvsdet_torch.models.mvsdet import build_model
from mvsdet_torch.ops import plane_sweep, sampling, splat, splat_tiles
from mvsdet_torch.utils import profiling

from test_splat import look_at_c2w, norm_k
from test_splat_tiled import random_cloud
from test_torch_port_interop import narrow

BG = np.asarray([0.1, 0.2, 0.3], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread while this module runs: the tiny networks here
    gain nothing from more, and beside the other test workers, which fill
    the machine's cores, each extra thread only waits at its barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.tensor(np.asarray(x))


def camera(eye=(0.0, 0.05, 2.5)):
    return look_at_c2w([0, 0, 0], list(eye)), norm_k()


RENDER_CASES = {
    # name: (image shape, Gaussians, seed, background, depth override)
    "colour": ((32, 32), 200, 0, False, False),
    "background": ((32, 48), 200, 1, True, False),
    "not_a_multiple_of_16": ((30, 41), 160, 3, True, False),
    "value_override": ((32, 32), 120, 4, False, True),
}


def render_both(name, chunk=256):
    shape, g, seed, bg, depth = RENDER_CASES[name]
    m, c, h, o = random_cloud(g, seed)
    c2w, k = camera()
    kw_j = dict(background=jnp.asarray(BG)) if bg else {}
    kw_t = dict(background=t(BG)) if bg else {}
    if depth:
        kw_j["value_override"] = m[:, 2:3]
        kw_t["value_override"] = t(m[:, 2:3])
    want = jx_splat.render_view(m, c, h, o, c2w, k, shape, pixel_chunk=chunk,
                                **kw_j)
    got = splat.render_view(t(m), t(c), t(h), t(o), t(c2w), t(k), shape,
                            pixel_chunk=chunk, **kw_t)
    return got, np.asarray(want), (m, c, h, o, c2w, k, shape, kw_t)


@pytest.mark.parametrize("name", sorted(RENDER_CASES))
def test_dense_render_view_matches_jax(name):
    got, want, (*_, shape, kw) = render_both(name)
    n_ch = 1 if "value_override" in kw else 3
    assert got.shape == shape + (n_ch,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert want.max() > 0.1             # something was splatted


def test_dense_render_views_matches_jax():
    m, c, h, o = random_cloud(150, 5)
    c2ws = jnp.stack([camera()[0], camera((0.3, -0.1, 2.2))[0]])
    ks = jnp.stack([norm_k(), norm_k(1.1, 0.9)])
    want = jx_splat.render_views(m, c, h, o, c2ws, ks, (32, 32),
                                 jnp.asarray(BG), pixel_chunk=512)
    got = splat.render_views(t(m), t(c), t(h), t(o), t(c2ws), t(ks),
                             (32, 32), t(BG), pixel_chunk=512)
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["background", "value_override"])
def test_dense_render_gradients_match_jax(name):
    shape, g, seed, bg, depth = RENDER_CASES[name]
    m, c, h, o = random_cloud(g, seed)
    c2w, k = camera()
    weights = np.random.RandomState(seed).randn(
        *shape, 1 if depth else 3).astype(np.float32)

    def jx_loss(m, c, h, o):
        kw = dict(background=jnp.asarray(BG)) if bg else {}
        if depth:
            kw["value_override"] = m[:, 2:3]
        img = jx_splat.render_view(m, c, h, o, c2w, k, shape,
                                   pixel_chunk=256, **kw)
        return jnp.sum(img * weights)

    want = jax.grad(jx_loss, argnums=(0, 1, 2, 3))(m, c, h, o)
    leaves = [t(a).requires_grad_() for a in (m, c, h, o)]
    kw = dict(background=t(BG)) if bg else {}
    if depth:
        kw["value_override"] = leaves[0][:, 2:3]
    img = splat.render_view(*leaves, t(c2w), t(k), shape, pixel_chunk=256,
                            **kw)
    (img * t(weights)).sum().backward()
    for leaf, w, field in zip(leaves, want, ("means", "covariances",
                                             "harmonics", "opacities")):
        w = np.asarray(w)
        if depth and field == "harmonics":
            assert not np.any(w) and leaf.grad is None
            continue
        scale = np.abs(w).max()
        assert scale > 0, field
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=field)


@pytest.mark.parametrize("name", ["background", "not_a_multiple_of_16",
                                  "value_override"])
def test_render_view_tiled_matches_jax_and_the_dense(name):
    dense, _, (m, c, h, o, c2w, k, shape, kw) = render_both(name)
    kw_j = {key: jnp.asarray(v.numpy()) for key, v in kw.items()}
    want = jx_splat_tiles.render_view_tiled(m, c, h, o, c2w, k, shape,
                                            capacity=256, **kw_j)
    got = splat_tiles.render_view_tiled(t(m), t(c), t(h), t(o), t(c2w),
                                        t(k), shape, capacity=256, **kw)
    assert got.shape == dense.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert (got - dense).abs().max() < 1e-3


def projection(rng, h, w):
    """A K @ w2c at feature resolution: a small rotation and shift."""
    k = np.array([[rng.uniform(0.8, 1.2) * w, 0, w / 2],
                  [0, rng.uniform(0.8, 1.2) * h, h / 2], [0, 0, 1.0]])
    a, b = rng.uniform(-0.2, 0.2, 2)
    r = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]]) @ np.array([[np.cos(b), 0, np.sin(b)],
                                          [0, 1, 0],
                                          [-np.sin(b), 0, np.cos(b)]])
    proj = np.eye(4)
    proj[:3, :3] = k @ r
    proj[:3, 3] = k @ rng.uniform(-0.3, 0.3, 3)
    return proj


def warp_inputs(seed=0, h=30, w=40, c=8, d=6):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((h, w, c)).astype(np.float32)
    ref, src = projection(rng, h, w), projection(rng, h, w)
    rel = (src @ np.linalg.inv(ref)).astype(np.float32)
    depths = np.linspace(0.5, 4.0, d).astype(np.float32)
    return feat, rel, depths, (ref, src)


@pytest.mark.parametrize("torch_compat", [False, True])
def test_homography_warp_matches_jax(torch_compat):
    feat, rel, depths, _ = warp_inputs()
    want = jx_plane_sweep.homography_warp(
        jnp.asarray(feat), jnp.asarray(rel), jnp.asarray(depths),
        torch_compat=torch_compat)
    got = plane_sweep.homography_warp(t(feat), t(rel), t(depths),
                                      torch_compat=torch_compat)
    assert got.shape == (6, 30, 40, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_torch_grid_sample_skew_matches_jax():
    coords = np.random.default_rng(1).uniform(-2, 45, (5, 7, 2)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        sampling.torch_grid_sample_skew(t(coords), 30, 41).numpy(),
        np.asarray(jx_sampling.torch_grid_sample_skew(jnp.asarray(coords),
                                                      30, 41)),
        rtol=1e-6, atol=1e-6)


def test_torch_compat_warp_is_the_references_grid_sample():
    """The reference's `homo_warping` (module.py:105-146) normalises the
    warped grid by (size - 1) / 2 and samples with align_corners=False."""
    feat, rel, depths, (ref, src) = warp_inputs(seed=2)
    h, w, c = feat.shape
    rel64 = src @ np.linalg.inv(ref)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xyz = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3).T
    rot = rel64[:3, :3] @ xyz                                # (3, HW)
    p = rot[None] * depths[:, None, None] + rel64[:3, 3:4][None]
    x = p[:, 0] / p[:, 2] / ((w - 1) / 2) - 1
    y = p[:, 1] / p[:, 2] / ((h - 1) / 2) - 1
    grid = torch.tensor(np.stack([x, y], -1).reshape(1, -1, h * w, 2),
                        dtype=torch.float32)
    golden = F.grid_sample(t(feat).permute(2, 0, 1)[None], grid,
                           mode="bilinear", padding_mode="zeros",
                           align_corners=False)[0]           # (C, D, HW)
    golden = golden.permute(1, 2, 0).reshape(len(depths), h, w, c)
    got = plane_sweep.homography_warp(t(feat), t(rel), t(depths),
                                      torch_compat=True)
    assert (got - golden).abs().max() <= 1e-4
    plain = plane_sweep.homography_warp(t(feat), t(rel), t(depths))
    assert (plain - golden).abs().max() > 1e-2   # the skew it corrects


def test_plane_sweep_variance_matches_jax():
    rng = np.random.default_rng(3)
    n, h, w, c, d = 4, 6, 8, 3, 5
    feats = rng.random((n, h, w, c)).astype(np.float32)
    proj = np.stack([projection(rng, h, w) for _ in range(n)]) \
        .astype(np.float32)
    nb = np.stack([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n], -1) \
        .astype(np.int32)
    depths = np.linspace(0.5, 4.0, d).astype(np.float32)
    want = jx_plane_sweep.plane_sweep_variance(
        *(jnp.asarray(a) for a in (feats, proj, nb, depths)))
    got = plane_sweep.plane_sweep_variance(t(feats), t(proj),
                                           t(nb.astype(np.int64)), t(depths))
    assert got.shape == (n, d, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- MVSDet with the dense renderer ------------------------------------------

def dense(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, gs=dataclasses.replace(cfg.model.gs, splat_impl="dense")))


@pytest.fixture(scope="module")
def models():
    cfg = narrow(tiny_test_config())
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)
    tiled = build_model(cfg, "cpu", torch.Generator().manual_seed(5))
    exact = build_model(dense(cfg), "cpu", torch.Generator().manual_seed(5))
    batch = {k: torch.from_numpy(v) for k, v in scene.items()}
    return cfg, tiled, exact, batch


def test_dense_model_predict_matches_the_tiled(models):
    cfg, tiled, exact, batch = models
    a = tiled.predict(batch, diagnostics=True)
    b = exact.predict(batch, diagnostics=True)
    assert b["rendered"].shape == (2,) + cfg.model.target_size + (3,)
    assert b["rendered_depth"].shape == (2,) + cfg.model.target_size
    for key in ("rendered", "rendered_depth"):
        assert (a[key] - b[key]).abs().max() < 1e-3, key
    assert b["rendered_depth"].max() > 0
    for key in ("mask", "labels", "boxes", "weight_gap", "src_rmse",
                "gs_means"):
        assert torch.equal(a[key], b[key]), key


def test_dense_model_loss_and_gradients_match_the_tiled(models):
    _, tiled, exact, batch = models
    grads = []
    for model in (tiled, exact):
        model.train()
        model.zero_grad()
        total, aux = model.loss(batch)
        total.backward()
        model.eval()
        grads.append(({k: v.item() for k, v in aux.items()},
                      {k: p.grad.clone() for k, p in model.named_parameters()
                       if p.grad is not None}))
    (la, ga), (lb, gb) = grads
    assert la.keys() == lb.keys() and "loss_nvs" in la
    for key in la:
        assert lb[key] == pytest.approx(la[key], rel=1e-5, abs=1e-7), key
    assert ga.keys() == gb.keys()
    for key in ga:
        scale = ga[key].abs().max().item()
        assert (ga[key] - gb[key]).abs().max().item() <= 1e-3 * scale \
            + 1e-9, key


# -- profiling ---------------------------------------------------------------

def test_timed_and_hard_sync_on_the_cpu():
    calls = []

    def work(x):
        calls.append(1)
        return {"y": [x @ x, x + 1]}

    x = torch.ones(64, 64)
    seconds = profiling.timed(work, x, iters=3, warmup=1)
    assert len(calls) == 4 and 0 < seconds < 10
    out = work(x)
    assert profiling.hard_sync(out) is out
    assert profiling.device_memory_stats() == {} or torch.cuda.is_available()
