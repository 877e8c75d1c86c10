"""The port's legacy NeRF-Det computing in bf16 against the JAX package's
`NerfDetLegacy(dtype=jnp.bfloat16)`.

`narrow(tiny_test_config())` on a synthetic scene of 4 views and 2
targets, `n_rand=64` rays of `n_samples=16` samples (ROADMAP T24), one
numpy-seeded variable tree carried across by the weight bridge, and JAX's
own ray draws handed to the port (T25).  JAX runs the loss's
`value_and_grad` and the predict once in bf16 and once in float32, each
compiled once in a module fixture with XLA's excess precision off, as in
`tests/test_torch_port_bf16.py`.

Every quantity is held to its witness, computed here: the distance of
JAX's float32 run from JAX's bf16 run on the same inputs and weights
(relative, in norm).  The port in bf16 must be nearer to JAX bf16 than
JAX float32 is, and so a port that computed in float32 would fail:

- `extract_feat`'s alpha (the NeRF density at the voxel centres) and the
  density-scaled volume handed to the neck, recorded on both sides;
- the loss terms, each within its own witness, and the rendered colour
  and depth of the rays;
- the gradients of one step, leaf by leaf and all together;
- predict's head outputs at every level.  The boxes are then compared
  bit for bit with the port's `head_predict` on JAX's own bf16 head
  outputs (and points): the free-running bf16 scores are an ulp apart
  here and there (torch and XLA round the bf16 backbone's sums in
  different orders, and through ResNet-50's depth those flips spread to
  the scores), so which box holds which slot of the top-k may differ; on
  equal scores the ties break as JAX's do (T15), and the boxes, labels
  and scores are equal.

The gradients are held to twice their witness (`GRAD_WITNESSES`), the
rest to one.

The dtypes at the places where bf16 meets float32 are checked too: the
images enter the backbone in bf16, the features the lift and the branch
sample stay float32, alpha is bf16 and the volume float32 before its
cast to bf16 for the neck (mvsdet_tpu/models/nerfdet.py:135-169).
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.models.head import head_predict as jx_head_predict
from mvsdet_tpu.models.neck3d import IndoorImVoxelNeck as JxNeck
from mvsdet_tpu.models.nerfdet import NerfDetLegacy as JxNerfDetLegacy

from mvsdet_torch import config as port_config
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.models.head import head_predict
from mvsdet_torch.models.nerfdet import NerfDetLegacy
from mvsdet_torch.training.loop import create_nerfdet_state

from test_torch_port_interop import narrow, random_variables

N_RAND, N_SAMPLES = 64, 16
RAYS_SEED = 3
BF16 = torch.bfloat16
EXACT_BF16 = {"xla_allow_excess_precision": False}
# a bf16 step's gradients are mostly rounding at these widths (the
# witness is 0.2-0.5 on most leaves), and the port's roundings and JAX's
# fall independently: each is about a witness from float32, and so up to
# about sqrt(2) witnesses from the other (1.4-1.65 measured on the worst
# leaves).  The gradients are held to twice their witness
GRAD_WITNESSES = 2.0


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


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel(got, want) -> float:
    got, want = np.asarray(f32(got), np.float64), np.asarray(f32(want),
                                                             np.float64)
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


def jax_run(model, tree, batch, key):
    """JAX's loss, gradient, neck statistics, rendered rays, alpha and
    the neck's input volume, then predict's head outputs and boxes, in
    ``model``'s dtype (one compile each)."""
    others = {k: v for k, v in tree.items() if k != "params"}

    def loss_fn(params, batch):
        seen = {}

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.method_name == "voxel_density":
                seen["alpha"] = out
            elif (isinstance(context.module, JxNeck)
                  and context.method_name == "__call__"):
                seen["volume"] = args[0]
            return out

        with fnn.intercept_methods(record):
            (total, aux), mutated = model.apply(
                {"params": params, **others}, batch,
                method=JxNerfDetLegacy.loss,
                mutable=["batch_stats", "intermediates"], rngs={"rays": key},
                capture_intermediates=lambda mdl, m: m == "nerf_branch")
        render = mutated["intermediates"]["nerf_branch"][0]
        return total, (aux, mutated["batch_stats"], render, seen)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                   compiler_options=EXACT_BF16)
    (total, (aux, stats, render, seen)), grads = step(tree["params"], batch)

    @jax.jit
    def predict(tree, batch):
        res = model.apply(tree, batch)
        return res, jx_head_predict(
            res["head_outs"], res["points"], res["valids"], model.cfg.head)

    predict = jax.jit(predict.__wrapped__, compiler_options=EXACT_BF16)
    res, pred = predict(tree, batch)
    host = lambda x: jax.tree_util.tree_map(np.asarray, x)
    return dict(losses={"loss": float(total),
                        **{k: float(v) for k, v in aux.items()}},
                grads=flax_to_state_dict({"params": host(grads)}),
                stats=flax_to_state_dict({"batch_stats": host(stats)}),
                render=host(render), alpha=np.asarray(seen["alpha"]),
                volume=np.asarray(seen["volume"]),
                head_outs=host(res["head_outs"]),
                points=host(res["points"]), valids=host(res["valids"]),
                pred=host(pred))


@pytest.fixture(scope="module")
def setup():
    cfg = narrow(tiny_test_config())
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    models = {dt: JxNerfDetLegacy(cfg.model, n_samples=N_SAMPLES,
                                  n_rand=N_RAND, dtype=dt)
              for dt in (jnp.bfloat16, jnp.float32)}
    tree = random_variables(models[jnp.float32], batch,
                            method=JxNerfDetLegacy.loss)
    key = jax.random.PRNGKey(RAYS_SEED)
    rays_key = models[jnp.float32].apply(
        tree, method=lambda m: m.make_rng("rays"), rngs={"rays": key})
    t_cnt, ht, wt = scene["gt_images"].shape[:3]
    return dict(cfg=cfg, scene=scene, tree=tree,
                draws=jax_ray_draws(rays_key, ht, wt, t_cnt),
                tensors={k: t(v) for k, v in scene.items()},
                j16=jax_run(models[jnp.bfloat16], tree, batch, key),
                j32=jax_run(models[jnp.float32], tree, batch, key))


def port_model(setup):
    pcfg = narrow(port_config.tiny_test_config())
    model = NerfDetLegacy(pcfg.model, n_samples=N_SAMPLES, n_rand=N_RAND,
                          dtype=BF16)
    load_flax_variables(model, setup["tree"])
    return model


@pytest.fixture(scope="module")
def port(setup):
    """The port's bf16 loss and gradients with JAX's draws, its render,
    alpha and neck input recorded; then its predict's head outputs."""
    model = port_model(setup).train()
    seen = {}
    density = model.voxel_density
    model.voxel_density = lambda *a: seen.setdefault("alpha", density(*a))
    def record(name):
        def hook(mod, args):            # returns None: the inputs stand
            seen.setdefault(name, args[0])
        return hook

    model.neck3d.register_forward_pre_hook(record("volume"))
    branch = model.nerf_branch
    model.nerf_branch = lambda *a: seen.setdefault("render", branch(*a))
    images = model.backbone.register_forward_pre_hook(record("images"))
    total, aux = model.loss(setup["tensors"], rays=setup["draws"])
    total.backward()
    images.remove()
    grads = {k: p.grad for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    with torch.no_grad():               # the step's model moved its stats
        head_outs = port_model(setup).eval()(setup["tensors"],
                                             train=False)["head_outs"]
    return dict(losses={"loss": total.item(),
                        **{k: v.item() for k, v in aux.items()}},
                grads=grads, stats=stats, seen=seen, head_outs=head_outs)


def check(what, got, j16, j32, times=1.0):
    """got within ``times`` its witness of JAX bf16."""
    err, witness = rel(got, j16), rel(j32, j16)
    assert err <= times * witness, (what, err, witness)
    return err, witness


def test_dtypes_where_bf16_meets_float32(port):
    seen = port["seen"]
    assert seen["images"].dtype == BF16
    assert seen["alpha"].dtype == BF16
    # the density-scaled volume is float32 (alpha times the float32 mean)
    # until the neck's input is cast to the compute dtype
    assert seen["volume"].dtype == BF16
    assert seen["render"]["rgb"].dtype == BF16
    assert seen["render"]["depth"].dtype == torch.float32


def test_alpha_and_volume_within_witness(setup, port):
    j16, j32 = setup["j16"], setup["j32"]
    check("alpha", port["seen"]["alpha"], j16["alpha"], j32["alpha"])
    volume = port["seen"]["volume"][0].permute(1, 2, 3, 0)
    check("volume", volume, j16["volume"][0], j32["volume"][0])


def test_loss_terms_and_render_within_witness(setup, port):
    j16, j32 = setup["j16"], setup["j32"]
    got, want = port["losses"], j16["losses"]
    assert set(got) == set(want)
    assert got["n_pos"] == want["n_pos"] > 0 and got["loss_nvs"] > 0
    for key in want:
        if key != "n_pos":
            check(key, got[key], want[key], j32["losses"][key])
    render = port["seen"]["render"]
    np.testing.assert_array_equal(render["ray_mask"].numpy(),
                                  j16["render"]["ray_mask"])
    for key in ("rgb", "depth"):
        check(key, render[key], j16["render"][key], j32["render"][key])


def test_step_gradients_within_witness(setup, port):
    j16, j32 = setup["j16"]["grads"], setup["j32"]["grads"]
    got = port["grads"]
    assert set(got) == set(j16)
    reached = [k for k in j16 if got[k] is not None]
    for name in j16:
        if got[name] is None:       # frozen (stem, layer1), unused FPN outs
            assert not np.any(j16[name]), name
            continue
        check(name, got[name], j16[name], j32[name], GRAD_WITNESSES)
    assert any(k.startswith("nerf_mlp.rgb.") for k in reached)
    flat = lambda d: np.concatenate([f32(d[k]).ravel() for k in reached])
    check("all gradients", flat(got), flat(j16), flat(j32), GRAD_WITNESSES)


def test_neck_statistics_within_witness(setup, port):
    j16, j32 = setup["j16"]["stats"], setup["j32"]["stats"]
    assert j16
    for name in j16:
        check(name, port["stats"][name], j16[name], j32[name])


def to_port(x) -> torch.Tensor:
    """A JAX output as a torch tensor of its dtype (numpy holds bf16 as
    ml_dtypes' bfloat16, which torch does not read)."""
    arr = np.array(x)
    if arr.dtype == jnp.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(BF16)
    return torch.from_numpy(arr)


def test_predict_head_outputs_within_witness_and_boxes_as_jax(setup, port):
    j16, j32 = setup["j16"], setup["j32"]
    for level, outs in enumerate(port["head_outs"]):
        for part, got in zip(("center", "bbox", "cls"), outs):
            i = ("center", "bbox", "cls").index(part)
            check(f"{part} level {level}", got,
                  j16["head_outs"][level][i], j32["head_outs"][level][i])
    # on JAX's own bf16 head outputs, the port's head_predict keeps JAX's
    # boxes, with JAX's bf16 scores and labels in JAX's slots
    jx_outs = [tuple(to_port(x) for x in level)
               for level in j16["head_outs"]]
    assert [tuple(x.dtype for x in level) for level in jx_outs] \
        == [tuple(x.dtype for x in level) for level in port["head_outs"]]
    got = head_predict(jx_outs, [t(p) for p in j16["points"]],
                       [t(v) for v in j16["valids"]],
                       narrow(port_config.tiny_test_config()).model.head)
    want = j16["pred"]
    mask = want["mask"]
    assert mask.sum() > 0
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    for key in ("labels", "scores"):
        np.testing.assert_array_equal(f32(got[key])[mask],
                                      f32(want[key])[mask], err_msg=key)
    np.testing.assert_array_equal(f32(got["boxes"])[mask],
                                  f32(want["boxes"])[mask])


def test_train_state_computes_in_bf16_and_keeps_float32_state(setup):
    state = create_nerfdet_state(narrow(port_config.tiny_test_config()),
                                 device="cpu", dtype=BF16,
                                 n_samples=N_SAMPLES, n_rand=N_RAND)
    assert state.model.dtype == BF16
    assert state.model.head.conv_cls.dtype == BF16
    assert state.model.mapping.dtype == BF16
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        NerfDetLegacy(narrow(port_config.tiny_test_config()).model,
                      dtype=torch.float16)
