"""The port's two-product plane sweep (`mvsdet_torch/ops/plane_sweep_mxu.py`)
and the default `MVSDet` that runs it, against the JAX package's default
sweep (`sweep_method="mxu"`), on the CPU at tiny shapes.

The warp and the variance on seeded numpy inputs: the identity, a pure
translation, a scale, a map with a column at the projective pole and
behind-camera columns, and random relative poses whose far planes lie
behind the neighbour camera.  Float32 values and the features' gradient
(against `jax.vjp`) to 1e-5 absolute.  In bf16 the two round in the same
places (the weights, the features, the intermediate image, the result),
so they differ only where a float32 sum of another order lands on the
other side of a bf16 rounding: held to `BF16_SHARE` of the witness,
JAX bf16 against JAX float32 on the same inputs (JAX compiled with XLA's
excess precision off, ROADMAP T18, else the intermediate image stays
float32 between the passes).

The whole model at its default sweep against JAX's default
`MVSDet(cfg.model)` from one variable tree: predict (boxes equal under
`mask`, rendered to 1e-4), one `loss` with its gradients (losses 1e-5,
gradients 1e-4) in float32, and the bf16 losses beside their witness.
One JAX compile for predict and one for the losses and gradients.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.models.head import head_predict as jx_head_predict
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.ops import plane_sweep_mxu as jx_mxu

from mvsdet_torch import config as port_config
from mvsdet_torch.evaluation.harness import make_predict_fn
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.models.mvsdet import MVSDet
from mvsdet_torch.ops import plane_sweep_mxu as mxu

from test_torch_port_interop import narrow, random_variables

EXACT_BF16 = {"xla_allow_excess_precision": False}
TOL = 1e-5
# bf16: the port's largest difference from JAX bf16 against the witness's
# largest (JAX bf16 from JAX float32)
BF16_SHARE = 0.5


def rotation(rng, max_angle):
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(-max_angle, max_angle)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def cameras(rng, n, h, w, max_angle):
    """(n, 4, 4) full projections K @ w2c of cameras around the origin,
    each turned by up to ``max_angle``."""
    proj = np.zeros((n, 4, 4))
    k = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]])
    for i in range(n):
        w2c = np.eye(4)
        w2c[:3, :3] = rotation(rng, max_angle)
        w2c[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        proj[i] = w2c
        proj[i, :3] = k @ w2c[:3]
    return proj.astype(np.float32)


def behind_share(homos, h=12, w=16) -> float:
    """The share of (plane, pixel) pairs that a (..., 3, 3) homography
    maps behind the source camera (a negative denominator)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    den = np.einsum("...j,jhw->...hw", np.asarray(homos)[..., 2, :],
                    np.stack([xs, ys, np.ones_like(xs)]))
    return float((den < 0).mean())


def homography_cases():
    """(name, (D, 3, 3) homographies) for an (H, W) = (12, 16) map."""
    rng = np.random.RandomState(0)
    ident = np.broadcast_to(np.eye(3), (3, 3, 3))
    shift = np.eye(3)
    shift[:2, 2] = (3.0, 2.0)
    scale = np.array([[0.8, 0.05, 2.0], [0.02, 0.9, 1.0],
                      [0.0005, 0.0002, 1.0]])
    # r = m21 A - m11 B = -(0.25 x' - 1): the pole at column x' = 4, and
    # B = 0.25 x' - 1 < 0 (behind the camera) left of it
    pole = np.array([[1.0, 0.1, 0.5], [0.05, 1.0, 0.25], [0.25, 0.0, -1.0]])
    rel = cameras(rng, 2, 12, 16, np.deg2rad(100))
    rel = rel[1] @ np.linalg.inv(rel[0])
    planes = np.asarray(jx_mxu.plane_homographies(
        jnp.asarray(rel, jnp.float32),
        jnp.asarray([0.5, 2.0, 8.0, 40.0], jnp.float32)))
    return {"identity": ident, "translation": shift[None],
            "scale": scale[None], "pole": pole[None], "random": planes}


CASES = homography_cases()


def jx_warp(homos, dtype):
    return lambda f: jx_mxu.homography_warp_mxu(f, homos, out_dtype=dtype)


def jx_value_and_vjp(fn, x, cot):
    """``fn(x)`` and its vjp with ``cot``, in one jit."""
    def both(x, cot):
        y, vjp = jax.vjp(fn, x)
        return y, vjp(cot)[0]
    return [np.asarray(a) for a in jax.jit(both)(x, cot)]


def jx_bf16(fn, x):
    return np.asarray(jax.jit(fn, compiler_options=EXACT_BF16)(x))


@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_and_its_gradient_match_jax(case):
    homos = np.array(CASES[case], np.float32)
    rng = np.random.RandomState(1)
    feat = rng.rand(12, 16, 5).astype(np.float32)
    cot = rng.randn(homos.shape[0], 12, 16, 5).astype(np.float32)
    want, want_grad = jx_value_and_vjp(
        jx_warp(jnp.asarray(homos), jnp.float32), feat, cot)
    ft = torch.from_numpy(feat).requires_grad_()
    got = mxu.homography_warp_mxu(ft, torch.from_numpy(homos))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(ft.grad.numpy(), want_grad, rtol=0, atol=TOL)
    if case in ("translation", "pole"):
        assert (np.asarray(want) == 0).any()      # zero padding reached
    if case in ("pole", "random"):
        assert 0 < behind_share(homos) < 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_in_bf16_beside_the_witness(case):
    homos = jnp.asarray(CASES[case], jnp.float32)
    feat = np.random.RandomState(2).rand(12, 16, 5).astype(np.float32)
    want = jx_bf16(jx_warp(homos, jnp.bfloat16), feat)
    witness = np.abs(want - jx_bf16(jx_warp(homos, jnp.float32), feat)).max()
    got = mxu.homography_warp_mxu(torch.from_numpy(feat),
                                  torch.from_numpy(np.array(homos)),
                                  out_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    assert witness > 1e-3                          # bf16 really rounded
    assert np.abs(got.numpy() - want).max() <= BF16_SHARE * witness


def test_interp_matrix_matches_jax():
    pos = np.array([[-1.5, -0.5, 0.0, 0.25, 3.0, 3.5, 4.0, 1e6]],
                   np.float32)
    np.testing.assert_array_equal(
        mxu._interp_matrix(torch.from_numpy(pos), 4).numpy(),
        np.asarray(jx_mxu._interp_matrix(jnp.asarray(pos), 4)))


@pytest.fixture(scope="module")
def sweep_inputs():
    """Five views at (12, 16), two references, two neighbours each; the
    cameras turn by up to 100 degrees, so some neighbours' far planes lie
    behind them."""
    rng = np.random.RandomState(3)
    proj = cameras(rng, 5, 12, 16, np.deg2rad(100))
    feats = rng.rand(5, 12, 16, 6).astype(np.float32)
    ref_ids = np.array([1, 3])
    nb = np.array([[0, 2], [4, 2]])
    depths = np.array([0.3, 1.0, 3.0, 12.0], np.float32)
    rel = np.einsum("mkij,mjl->mkil", proj[nb], np.linalg.inv(proj[ref_ids]))
    assert 0 < behind_share(jx_mxu.plane_homographies(
        jnp.asarray(rel[0, 1], jnp.float32), depths)) < 1
    return feats, proj, ref_ids, nb, depths


def jx_variance(proj, ref_ids, nb, depths, dtype):
    return lambda f: jx_mxu.plane_sweep_variance_mxu(
        f, proj, ref_ids, nb, depths, compute_dtype=dtype)


def test_variance_and_its_gradient_match_jax(sweep_inputs):
    feats, proj, ref_ids, nb, depths = sweep_inputs
    cot = np.random.RandomState(4).randn(2, 4, 12, 16, 6).astype(np.float32)
    want, want_grad = jx_value_and_vjp(
        jx_variance(proj, ref_ids, nb, depths, jnp.float32), feats, cot)
    ft = torch.from_numpy(feats).requires_grad_()
    got = mxu.plane_sweep_variance_mxu(
        ft, torch.from_numpy(proj), torch.from_numpy(ref_ids),
        torch.from_numpy(nb), torch.from_numpy(depths))
    got.backward(torch.from_numpy(cot))
    assert got.shape == (2, 4, 12, 16, 6)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(ft.grad.numpy(), want_grad, rtol=0, atol=TOL)


def test_variance_in_bf16_beside_the_witness(sweep_inputs):
    feats, proj, ref_ids, nb, depths = sweep_inputs
    want = jx_bf16(jx_variance(proj, ref_ids, nb, depths, jnp.bfloat16),
                   feats)
    witness = np.abs(want - jx_bf16(
        jx_variance(proj, ref_ids, nb, depths, jnp.float32), feats)).max()
    got = mxu.plane_sweep_variance_mxu(
        torch.from_numpy(feats), torch.from_numpy(proj),
        torch.from_numpy(ref_ids), torch.from_numpy(nb),
        torch.from_numpy(depths), compute_dtype=torch.bfloat16)
    assert witness > 1e-3
    assert np.abs(got.numpy() - want).max() <= BF16_SHARE * witness


# -- the whole model at its default sweep ------------------------------------

def model_config(cfg):
    """`narrow(tiny_test_config())` of either package, splat capacity
    256."""
    cfg = narrow(cfg)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, gs=dataclasses.replace(cfg.model.gs, splat_capacity=256)))


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.fixture(scope="module")
def model_runs():
    """JAX's default `MVSDet` on one tree: predict (one compile), and the
    float32 loss with its gradients beside the bf16 loss (one compile)."""
    cfg = model_config(tiny_test_config())
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx32 = JxMVSDet(cfg.model, sweep_chunk=2)
    jx16 = JxMVSDet(cfg.model, sweep_chunk=2, dtype=jnp.bfloat16)
    assert jx32.sweep_method == "mxu"
    tree = random_variables(jx32, batch, method=JxMVSDet.loss)

    def predict(t, b):
        res = jx32.apply(t, b)
        return res["rendered"], jx_head_predict(
            res["head_outs"], res["points"], res["valids"], cfg.model.head)

    def loss(model, params):
        (total, aux), _ = model.apply(
            {"params": params, "batch_stats": tree["batch_stats"],
             "frozen": tree["frozen"]}, batch, method=JxMVSDet.loss,
            mutable=["batch_stats"])
        return total, dict(aux, loss=total)

    def losses(params):
        (_, aux32), grads = jax.value_and_grad(
            lambda p: loss(jx32, p), has_aux=True)(params)
        return aux32, grads, loss(jx16, params)[1]

    rendered, pred = jax.tree_util.tree_map(
        np.asarray, jax.jit(predict)(tree, batch))
    aux32, grads, aux16 = jax.tree_util.tree_map(np.asarray, jax.jit(
        losses, compiler_options=EXACT_BF16)(tree["params"]))
    return dict(scene=scene, tree=tree, rendered=rendered, pred=pred,
                aux32=aux32, aux16=aux16,
                grads=flax_to_state_dict({"params": grads}))


def port_model(runs, dtype=torch.float32):
    model = MVSDet(model_config(port_config.tiny_test_config()).model,
                   sweep_chunk=2, dtype=dtype)
    assert model.sweep_method == "mxu"
    load_flax_variables(model, runs["tree"])
    return model


def test_predict_matches_jax_default(model_runs):
    pred = make_predict_fn(port_model(model_runs).eval(),
                           device="cpu")(model_runs["scene"])
    want = model_runs["pred"]
    np.testing.assert_allclose(pred["rendered"], model_runs["rendered"],
                               rtol=1e-4, atol=1e-4)
    mask = want["mask"]
    np.testing.assert_array_equal(pred["mask"], mask)
    assert mask.sum() > 0
    np.testing.assert_array_equal(pred["labels"][mask], want["labels"][mask])
    np.testing.assert_allclose(pred["boxes"][mask], want["boxes"][mask],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pred["scores"][mask], want["scores"][mask],
                               rtol=1e-5, atol=1e-6)


def test_loss_and_gradients_match_jax_default(model_runs):
    model = port_model(model_runs).train()
    total, aux = model.loss({k: torch.from_numpy(np.asarray(v))
                             for k, v in model_runs["scene"].items()})
    total.backward()
    got = {k: float(v.detach()) for k, v in aux.items()}
    got["loss"] = total.item()
    want = model_runs["aux32"]
    assert set(got) == set(want)
    assert got["n_pos"] == float(want["n_pos"]) > 0
    for key, value in got.items():
        assert abs(value - float(want[key])) <= 1e-5 * abs(
            float(want[key])), key
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(model_runs["grads"])
    for name, w in model_runs["grads"].items():
        if grads[name] is None:     # frozen (stem, layer1) or unused
            assert not np.any(w), name
            continue
        assert rel(grads[name].numpy(), w) <= 1e-4, name


def test_bf16_loss_beside_the_witness(model_runs):
    """The whole bf16 loss, free-running, within its witness (JAX bf16
    against JAX float32).  The bf16 loss is coarse: the focal loss sums in
    bf16 (a step of 1/n_pos in `cls_loss` at this size), and one bf16 ulp
    flipped early spreads through the networks, so only the total is held,
    as `test_torch_port_bf16.py` holds it."""
    model = port_model(model_runs, torch.bfloat16).train()
    with torch.no_grad():
        total, _ = model.loss({k: torch.from_numpy(np.asarray(v))
                               for k, v in model_runs["scene"].items()})
    want = float(model_runs["aux16"]["loss"])
    witness = abs(float(model_runs["aux32"]["loss"]) - want)
    assert witness >= 1e-3 * want                  # bf16 really rounded
    assert abs(total.item() - want) <= witness, (total.item(), want, witness)
