"""The port's legacy NeRF-Det against the JAX package's `NerfDetLegacy`.

`narrow(tiny_test_config())` on a synthetic scene of 4 views and 2
targets, `n_rand=64` rays of `n_samples=16` samples: at 8 samples or fewer
the ray mask (`(view_count > 1).sum(axis=1) > 8`) keeps no ray and
`loss_nvs` is exactly 0 (ROADMAP T24), so 16.  One numpy-seeded JAX
variable tree is carried across by the weight bridge, and the port is
handed JAX's own ray draws (ROADMAP T25: the same `jax.random` calls on
the key the JAX module's `make_rng("rays")` gives), so that both draw the
same rays.  JAX compiles three functions: the loss's `value_and_grad`
(with the branch's outputs and the neck's statistics), the predict, and
nothing else at the module's size.

- the NeRF MLP (`sinusoidal_encode`, `VanillaNeRF`, `query_density`)
  and every `ray_render` function to 1e-6;
- `simple_backproject` and `mean_cov_volumes` bit-equal (exp(-var)
  within one ulp: torch's exp and XLA's differ by one now and then),
  points at z ~ 0 and behind the camera included; the geometry
  functions;
- the loss terms to 1e-5, the step's gradients to 1e-4 relative (the NeRF
  MLP's rgb layers and `mapping` among them, nonzero) or, on a leaf whose
  witness is above half that, to twice the witness: JAX's gradient with
  every parameter nudged by one ulp against JAX's own.  The density
  branch's alpha scales the neck's input, and the neck's BatchNorm in
  train mode turns that input's rounding (5e-7 relative) into up to 3e-4
  on its weights' gradients, where one ulp of the parameters moves JAX's
  own by 4e-4; handed JAX's alpha, the port's neck gradients are within
  5e-5.  The neck's running statistics after the step to 1e-5;
- predict: the kept boxes, labels and mask equal, scores to 1e-5; on JAX's
  own head outputs within a few ulps (ROADMAP T19).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.geometry import cameras as jx_cameras
from mvsdet_tpu.geometry import rays as jx_rays
from mvsdet_tpu.models import nerf_mlp as jx_nerf_mlp
from mvsdet_tpu.models.head import head_predict as jx_head_predict
from mvsdet_tpu.models.nerfdet import NerfDetLegacy as JxNerfDetLegacy
from mvsdet_tpu.models.nerfdet import mean_cov_volumes as jx_mean_cov
from mvsdet_tpu.models.nerfdet import simple_backproject as jx_backproject
from mvsdet_tpu.ops import ray_render as jx_render

from mvsdet_torch import config as port_config
from mvsdet_torch.evaluation.harness import make_predict_fn
from mvsdet_torch.geometry import cameras, rays
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.models import nerf_mlp
from mvsdet_torch.models.head import head_predict
from mvsdet_torch.models.nerfdet import (NerfDetLegacy, mean_cov_volumes,
                                         simple_backproject)
from mvsdet_torch.ops import ray_render
from mvsdet_torch.training.loop import (create_nerfdet_state,
                                        nerfdet_train_step, ray_generator)

from test_torch_port_interop import narrow, random_variables

N_RAND, N_SAMPLES = 64, 16
# the seed of the JAX module's 'rays' stream
RAYS_SEED = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One thread: beside the other test workers the CPU is oversubscribed
    (see tests/test_torch_port_launchers.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x):
    return torch.from_numpy(np.array(x))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def jax_ray_draws(key, ht, wt, t_cnt):
    """The draws of `NerfDetLegacy.nerf_branch` (mvsdet_tpu/models/
    nerfdet.py:184-198) from its rays key, as the port takes them."""
    k1, k2, k3 = jax.random.split(key, 3)
    draws = dict(
        ys=jax.random.randint(k1, (N_RAND,), 4, ht - 4),
        xs=jax.random.randint(k2, (N_RAND,), 4, wt - 4),
        ts=jax.random.randint(k3, (N_RAND,), 0, t_cnt),
        t=jax.random.uniform(jax.random.fold_in(key, 7),
                             (N_RAND, N_SAMPLES)))
    return {k: t(v).long() if k != "t" else t(v) for k, v in draws.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = narrow(tiny_test_config())
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx_model = JxNerfDetLegacy(cfg.model, n_samples=N_SAMPLES, n_rand=N_RAND)
    tree = random_variables(jx_model, batch, method=JxNerfDetLegacy.loss)
    key = jax.random.PRNGKey(RAYS_SEED)
    rays_key = jx_model.apply(tree, method=lambda m: m.make_rng("rays"),
                              rngs={"rays": key})
    t_cnt, ht, wt = scene["gt_images"].shape[:3]
    pcfg = narrow(port_config.tiny_test_config())
    model = NerfDetLegacy(pcfg.model, n_samples=N_SAMPLES, n_rand=N_RAND)
    load_flax_variables(model, tree)
    return dict(cfg=cfg, pcfg=pcfg, scene=scene, batch=batch,
                jx_model=jx_model, tree=tree, key=key, model=model,
                draws=jax_ray_draws(rays_key, ht, wt, t_cnt),
                tensors={k: t(v) for k, v in scene.items()})


@pytest.fixture(scope="module")
def jax_step(setup):
    """One compile: the loss's value and gradient, the branch's outputs
    and the neck's statistics after the forward; then the gradient again
    with every parameter nudged by one ulp (the witness)."""
    jx_model, tree, key = setup["jx_model"], setup["tree"], setup["key"]
    others = {k: v for k, v in tree.items() if k != "params"}

    def loss_fn(params, batch):
        (total, aux), mutated = jx_model.apply(
            {"params": params, **others}, batch,
            method=JxNerfDetLegacy.loss,
            mutable=["batch_stats", "intermediates"], rngs={"rays": key},
            capture_intermediates=lambda mdl, method: method == "nerf_branch")
        render = mutated["intermediates"]["nerf_branch"][0]
        return total, (aux, mutated["batch_stats"], render)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (total, (aux, stats, render)), grads = step(tree["params"],
                                                setup["batch"])
    nudged = jax.tree_util.tree_map(lambda x: jnp.nextafter(x, jnp.inf),
                                    tree["params"])
    _, witness = step(nudged, setup["batch"])
    host = lambda x: jax.tree_util.tree_map(np.asarray, x)
    return dict(metrics={"loss": float(total),
                         **{k: float(v) for k, v in aux.items()}},
                grads=flax_to_state_dict({"params": host(grads)}),
                witness=flax_to_state_dict({"params": host(witness)}),
                stats=flax_to_state_dict({"batch_stats": host(stats)}),
                render=host(render))


@pytest.fixture(scope="module")
def port_step(setup):
    """The port's step (`nerfdet_train_step`, its draws replaced by JAX's)
    from the same tree; the step's gradients from a copy of the model,
    since the step clips them in place; the branch's outputs from another
    copy."""
    state = create_nerfdet_state(setup["pcfg"], device="cpu",
                                 steps_per_epoch=1, n_samples=N_SAMPLES,
                                 n_rand=N_RAND)
    load_flax_variables(state.model, setup["tree"])
    batch, draws = setup["tensors"], setup["draws"]
    probe = copy.deepcopy(state.model)
    render = copy.deepcopy(state.model)(batch, train=True,
                                         rays=draws)["render"]
    probe.loss(batch, rays=draws)[0].backward()
    generators = []
    state.model.draw_rays = lambda b, g: generators.append(g) or draws
    metrics = nerfdet_train_step(state, batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={k: p.grad for k, p in probe.named_parameters()},
                state=state.model.state_dict(), render=render,
                generators=generators, step=state.step)


# -- the NeRF MLP -------------------------------------------------------------

@pytest.mark.parametrize("lo,hi,identity", [(0, 10, True), (0, 4, True),
                                            (2, 5, False), (3, 3, True)])
def test_sinusoidal_encode_matches_jax(lo, hi, identity):
    x = np.random.RandomState(lo + hi).uniform(-3, 3, (7, 5, 3)) \
        .astype(np.float32)
    want = np.asarray(jx_nerf_mlp.sinusoidal_encode(jnp.asarray(x), lo, hi,
                                                    identity))
    got = nerf_mlp.sinusoidal_encode(t(x), lo, hi, identity).numpy()
    assert got.shape == want.shape == (7, 5, nerf_mlp.encode_dim(
        3, lo, hi, identity))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_vanilla_nerf_matches_jax(setup):
    """rgb and sigma on (R, S) points with one view direction per ray (the
    broadcast) and the density query, with the bridged weights."""
    rng = np.random.RandomState(0)
    port = setup["model"].nerf_mlp
    dim = setup["model"].nerf_feature_dim + 6
    pts = rng.uniform(-2, 2, (6, 5, 3)).astype(np.float32)
    dirs = rng.randn(6, 3).astype(np.float32)
    feats = rng.uniform(0, 1, (6, 5, dim)).astype(np.float32)
    jx = jx_nerf_mlp.VanillaNeRF(net_depth=4, net_width=256, skip_layer=3,
                                 feature_dim=dim)
    params = {"params": setup["tree"]["params"]["nerf_mlp"]}
    rgb_j, sigma_j = jx.apply(params, pts, dirs, feats)
    dens_j = jx.apply(params, pts[:, 0], feats[:, 0],
                      method=jx_nerf_mlp.VanillaNeRF.query_density)
    with torch.no_grad():
        rgb, sigma = port(t(pts), t(dirs), t(feats))
        dens = port.query_density(t(pts[:, 0]), t(feats[:, 0]))
    # the base MLP appends its input after hidden layer 3 of 4
    assert port.base.out_dim == 256 + nerf_mlp.encode_dim(3, 0, 10) + dim
    assert float(np.abs(np.asarray(sigma_j)).max()) > 0
    for got, want in ((rgb, rgb_j), (sigma, sigma_j), (dens, dens_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# -- ray_render ---------------------------------------------------------------

def rays_case(seed=0, r=9, s=12):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-1, 1, (r, 3)).astype(np.float32)
    d = rng.randn(r, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d, jax.random.PRNGKey(seed), r, s


@pytest.mark.parametrize("inv_uniform,det", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_sample_along_rays_matches_jax(inv_uniform, det):
    o, d, key, r, s = rays_case()
    pts_j, z_j = jx_render.sample_along_rays(
        None if det else key, jnp.asarray(o), jnp.asarray(d), 0.2, 5.0, s,
        inv_uniform=inv_uniform, det=det)
    u = None if det else t(jax.random.uniform(key, (r, s)))
    pts, z = ray_render.sample_along_rays(u, t(o), t(d), 0.2, 5.0, s,
                                          inv_uniform=inv_uniform, det=det)
    for got, want in ((pts, pts_j), (z, z_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_matches_jax(det):
    rng = np.random.RandomState(1)
    bins = np.sort(rng.uniform(0.2, 5.0, (9, 12)), axis=-1).astype(np.float32)
    weights = (rng.rand(9, 12) ** 3).astype(np.float32)
    weights[0] = 0.0                  # a ray whose pdf is the epsilon alone
    key = jax.random.PRNGKey(2)
    want = jx_render.sample_pdf(None if det else key, jnp.asarray(bins),
                                jnp.asarray(weights), 20, det=det)
    u = None if det else t(jax.random.uniform(key, (9, 20)))
    got = ray_render.sample_pdf(u, t(bins), t(weights), 20, det=det)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_raw2outputs_matches_jax():
    """Values and the gradients of rgb and depth, the global depth clip
    active on some rays."""
    rng = np.random.RandomState(3)
    rgb = rng.rand(9, 12, 3).astype(np.float32)
    sigma = rng.uniform(0, 3, (9, 12)).astype(np.float32)
    sigma[0] = 0.0                    # empty ray: depth 0, clipped to near
    z = np.sort(rng.uniform(0.2, 5.0, (9, 12)), axis=-1).astype(np.float32)
    cot_rgb = rng.randn(9, 3).astype(np.float32)
    cot_depth = rng.randn(9).astype(np.float32)

    def jx_fn(rgb, sigma):
        out = jx_render.raw2outputs(rgb, sigma, jnp.asarray(z))
        return (jnp.sum(out["rgb"] * cot_rgb)
                + jnp.sum(out["depth"] * cot_depth)), out

    (_, want), grads_j = jax.value_and_grad(jx_fn, argnums=(0, 1),
                                            has_aux=True)(jnp.asarray(rgb),
                                                          jnp.asarray(sigma))
    rgb_t, sigma_t = t(rgb).requires_grad_(), t(sigma).requires_grad_()
    got = ray_render.raw2outputs(rgb_t, sigma_t, t(z))
    (torch.sum(got["rgb"] * t(cot_rgb))
     + torch.sum(got["depth"] * t(cot_depth))).backward()
    assert float(got["depth"][0].detach()) == float(z.min())
    for key in ("rgb", "depth", "weights"):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    for g, w in zip((rgb_t.grad, sigma_t.grad), grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_projection_and_view_sampling_match_jax(setup):
    """`project_to_views`, `sample_views_at_points` (images and a
    stride-4 feature map), `masked_mean_var` on the scene's cameras, with
    points in front of, beside and behind them."""
    scene = setup["scene"]
    rng = np.random.RandomState(4)
    pts = rng.uniform(-2.5, 2.5, (300, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.0, 2.0, 300)
    feats = rng.randn(4, 8, 12, 5).astype(np.float32)
    args = [scene["w2c"], scene["intrinsic"]]
    pix_j, front_j = jx_render.project_to_views(jnp.asarray(pts),
                                                *map(jnp.asarray, args))
    pix, front = ray_render.project_to_views(t(pts), *map(t, args))
    np.testing.assert_allclose(pix.numpy(), np.asarray(pix_j), rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_array_equal(front.numpy(), np.asarray(front_j))
    sampled_j, mask_j = jx_render.sample_views_at_points(
        jnp.asarray(pts), jnp.asarray(scene["denorm_images"]),
        jnp.asarray(feats), *map(jnp.asarray, args))
    sampled, mask = ray_render.sample_views_at_points(
        t(pts), t(scene["denorm_images"]), t(feats), *map(t, args))
    assert 0 < float(mask.mean()) < 1
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    # the pixels differ in their last bits (XLA adds the projection's four
    # products pairwise), which the images' slopes carry into the samples
    assert rel(sampled.numpy(), sampled_j) <= 1e-6
    mean_j, var_j = jx_render.masked_mean_var(sampled_j, mask_j)
    mean, var = ray_render.masked_mean_var(sampled, mask)
    for got, want in ((mean, mean_j), (var, var_j)):
        assert rel(got.numpy(), want) <= 1e-6


def test_volume_sample_trilinear_matches_jax():
    rng = np.random.RandomState(5)
    vol = rng.randn(5, 4, 3, 6).astype(np.float32)
    pts = rng.uniform(-0.5, 1.5, (40, 3)).astype(np.float32)
    out_j, inside_j = jx_render.volume_sample_trilinear(
        jnp.asarray(vol), jnp.asarray(pts), (0, 0, 0), (1, 1, 1))
    out, inside = ray_render.volume_sample_trilinear(t(vol), t(pts),
                                                     (0, 0, 0), (1, 1, 1))
    assert 0 < int(inside.sum()) < 40
    np.testing.assert_array_equal(inside.numpy(), np.asarray(inside_j))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-6,
                               atol=1e-6)


# -- geometry -----------------------------------------------------------------

def test_geometry_matches_jax(setup):
    """`pixel_ray_dirs` (one rotation, and one per pixel as the branch
    takes it), `compute_projection` (shared and per-view K) and
    `world_to_image` with depths at, near and either side of 0."""
    scene = setup["scene"]
    rng = np.random.RandomState(6)
    pix = rng.uniform(0, 24, (10, 2)).astype(np.float32)
    k, c2w = scene["tgt_intrinsic"], scene["tgt_c2w"]
    want = jx_rays.pixel_ray_dirs(jnp.asarray(pix), jnp.asarray(k),
                                  jnp.asarray(c2w[0, :3, :3]))
    got = rays.pixel_ray_dirs(t(pix), t(k), t(c2w[0, :3, :3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    ts = np.arange(10) % 2
    want = jax.vmap(lambda p, i: jx_rays.pixel_ray_dirs(
        p, jnp.asarray(k), jnp.asarray(c2w)[i][:3, :3]))(jnp.asarray(pix), ts)
    got = rays.pixel_ray_dirs(t(pix), t(k), t(c2w[ts, :3, :3]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

    w2c = scene["w2c"]
    per_view = np.stack([scene["intrinsic"] * (1 + 0.1 * i) for i in range(4)])
    for k_in in (scene["intrinsic"], per_view):
        want = jx_cameras.compute_projection(jnp.asarray(w2c),
                                             jnp.asarray(k_in), 4.0)
        got = cameras.compute_projection(t(w2c), t(k_in), 4.0)
        assert got.shape == (4, 3, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)

    proj = np.asarray(jx_cameras.compute_projection(
        jnp.asarray(w2c), jnp.asarray(scene["intrinsic"]), 1.0))[0]
    c2w0 = np.linalg.inv(w2c[0])
    cam = rng.uniform(-1, 1, (12, 3))
    cam[:, 2] = [2.0, -1.0, 0.0, 1e-9, -1e-9, 3e-9, 0.5, 1.5, -0.3, 0.0,
                 1e-7, 4.0]
    pts = (cam @ c2w0[:3, :3].T + c2w0[:3, 3]).astype(np.float32)
    xy_j, z_j = jx_cameras.world_to_image(jnp.asarray(pts), jnp.asarray(proj))
    xy, z = cameras.world_to_image(t(pts), t(proj))
    assert np.all(np.isfinite(xy.numpy()))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(xy.numpy(), np.asarray(xy_j), rtol=1e-5,
                               atol=1e-5)


def backproject_case(scene, stride):
    """Features at 1 / stride of the image and the scene's projections
    there; points: a voxel grid around the scene, then points on camera
    0's plane z = 0, within 1e-9 of it, and behind it."""
    rng = np.random.RandomState(7)
    h, w = (n // stride for n in scene["images"].shape[1:3])
    feats = rng.randn(4, h, w, 6).astype(np.float32)
    proj = cameras.compute_projection(t(scene["w2c"]), t(scene["intrinsic"]),
                                      float(stride)).numpy()
    grid = rng.uniform(-2, 2, (400, 3))
    c2w0 = np.linalg.inv(scene["w2c"][0])
    cam = rng.uniform(-1, 1, (30, 3))
    cam[:10, 2] = 0.0
    cam[10:20, 2] = rng.uniform(-1e-9, 1e-9, 10)
    cam[20:, 2] = rng.uniform(-2, -0.1, 10)
    special = cam @ c2w0[:3, :3].T + c2w0[:3, 3]
    return feats, proj, np.concatenate([grid, special]).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 4])
def test_simple_backproject_and_mean_cov_bit_equal_jax(setup, stride):
    feats, proj, pts = backproject_case(setup["scene"], stride)
    vol_j, valid_j = map(np.asarray, jx_backproject(
        jnp.asarray(feats), jnp.asarray(proj), jnp.asarray(pts)))
    vol, valid = simple_backproject(t(feats), t(proj), t(pts))
    assert 0 < valid_j.mean() < 1 and not valid_j[0, 400:].any()
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_array_equal(vol.numpy(), vol_j)
    want = map(np.asarray, jx_mean_cov(jnp.asarray(vol_j),
                                       jnp.asarray(valid_j)))
    mean, cov, count = mean_cov_volumes(vol, valid)
    mean_j, cov_j, count_j = want
    np.testing.assert_array_equal(mean.numpy(), mean_j)
    np.testing.assert_array_equal(count.numpy(), count_j)
    np.testing.assert_array_max_ulp(cov.numpy(), cov_j, maxulp=1)


def test_per_view_intrinsics_are_refused(setup):
    batch = dict(setup["tensors"])
    batch["intrinsic"] = batch["intrinsic"].expand(4, 4, 4)
    with pytest.raises(ValueError, match="one per view"):
        setup["model"].predict(batch)


# -- the loss and the step ----------------------------------------------------

def test_ray_mask_keeps_rays_on_both_sides(jax_step, port_step):
    want, got = jax_step["render"], port_step["render"]
    assert want["ray_mask"].sum() > 0
    np.testing.assert_array_equal(got["ray_mask"].numpy(), want["ray_mask"])
    for key in ("ray_ts", "ray_ys", "ray_xs"):
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    np.testing.assert_array_equal(got["gt_rgb"].numpy(), want["gt_rgb"])
    for key in ("rgb", "depth"):
        assert rel(got[key].detach().numpy(), want[key]) <= 1e-5, key
    assert jax_step["metrics"]["loss_nvs"] > 0
    assert port_step["metrics"]["loss_nvs"] > 0


def test_loss_terms_match_jax(jax_step, port_step):
    want, got = jax_step["metrics"], port_step["metrics"]
    assert set(got) == set(want) == {"loss", "center_loss", "bbox_loss",
                                     "cls_loss", "loss_nvs", "loss_depth",
                                     "n_pos"}
    assert got["n_pos"] == want["n_pos"] > 0
    for key, value in want.items():
        assert abs(got[key] - value) <= 1e-5 * abs(value), key


def test_step_gradients_match_jax(jax_step, port_step):
    """Every leaf's gradient to 1e-4 relative, or to twice its witness
    where that is larger; the NeRF branch's (the rgb MLP, reached by
    loss_nvs alone) and `mapping` nonzero."""
    want_all, got_all = jax_step["grads"], port_step["grads"]
    witness = {k: rel(jax_step["witness"][k], w) for k, w in want_all.items()}
    assert set(got_all) == set(want_all)
    for prefix in ("nerf_mlp.rgb.", "mapping.", "nerf_mlp.base.", "head."):
        names = [k for k in want_all if k.startswith(prefix)]
        assert names and all(np.any(want_all[k]) for k in names), prefix
    for name, want in want_all.items():
        got = got_all[name]
        if got is None:      # frozen (stem, layer1) or unused (FPN out1-3)
            assert not np.any(want), name
            continue
        err = rel(got.numpy(), want)
        assert err <= max(1e-4, 2 * witness[name]), (name, err,
                                                     witness[name])


def test_step_moves_the_neck_statistics_as_jax(jax_step, port_step):
    stats = jax_step["stats"]
    assert stats and all(k.startswith("neck3d.") for k in stats)
    for name, want in stats.items():
        np.testing.assert_allclose(port_step["state"][name].numpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_step_draws_from_the_seed_and_the_step(setup, port_step):
    """The step handed `draw_rays` the generator of (seed, step 0), and
    `draw_rays` keeps the ranges of the JAX draws."""
    (g,) = port_step["generators"]
    assert port_step["step"] == 1
    assert torch.equal(g.get_state(), ray_generator(0, 0, "cpu").get_state())
    assert not torch.equal(g.get_state(),
                           ray_generator(0, 1, "cpu").get_state())
    draws = setup["model"].draw_rays(setup["tensors"],
                                     ray_generator(0, 5, "cpu"))
    t_cnt, ht, wt = setup["scene"]["gt_images"].shape[:3]
    assert draws["t"].shape == (N_RAND, N_SAMPLES)
    for key, lo, hi in (("ys", 4, ht - 4), ("xs", 4, wt - 4),
                        ("ts", 0, t_cnt)):
        assert int(draws[key].min()) >= lo and int(draws[key].max()) < hi


# -- predict ------------------------------------------------------------------

@pytest.fixture(scope="module")
def predicts(setup):
    cfg, jx_model = setup["cfg"], setup["jx_model"]

    @jax.jit
    def jx_run(tree, batch):
        res = jx_model.apply(tree, batch)
        return res, jx_head_predict(res["head_outs"], res["points"],
                                    res["valids"], cfg.model.head)

    res_j, pred_j = jax.tree_util.tree_map(
        np.asarray, jx_run(setup["tree"], setup["batch"]))
    model = copy.deepcopy(setup["model"]).eval()
    pred_t = make_predict_fn(model, device="cpu")(setup["scene"])
    return dict(res_j=res_j, pred_j=pred_j, pred_t=pred_t)


def test_predict_matches_jax(setup, predicts):
    pred_j, pred_t = predicts["pred_j"], predicts["pred_t"]
    assert set(pred_t) == {"boxes", "scores", "labels", "mask"}
    mask = pred_j["mask"]
    assert mask.sum() > 0
    np.testing.assert_array_equal(pred_t["mask"], mask)
    np.testing.assert_array_equal(pred_t["labels"][mask],
                                  pred_j["labels"][mask])
    np.testing.assert_allclose(pred_t["boxes"][mask], pred_j["boxes"][mask],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pred_t["scores"][mask], pred_j["scores"][mask],
                               rtol=1e-5, atol=1e-6)


def test_head_predict_on_jax_outputs(setup, predicts):
    """JAX's own head outputs through the port's prediction: mask and
    labels equal, boxes and scores within a few ulps (ROADMAP T19)."""
    res_j, pred_j = predicts["res_j"], predicts["pred_j"]
    pred = head_predict(
        [tuple(torch.tensor(x) for x in lvl) for lvl in res_j["head_outs"]],
        [torch.tensor(p) for p in res_j["points"]],
        [torch.tensor(v) for v in res_j["valids"]], setup["pcfg"].model.head)
    mask = pred_j["mask"]
    np.testing.assert_array_equal(pred["mask"].numpy(), mask)
    np.testing.assert_array_equal(pred["labels"].numpy()[mask],
                                  pred_j["labels"][mask])
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(pred[key].numpy()[mask], pred_j[key][mask],
                                   rtol=5e-7, atol=5e-7, err_msg=key)
