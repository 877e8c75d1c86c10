"""The port's bf16 compute dtype against the JAX package's.

The same numpy inputs and variable trees go through the JAX modules with
`dtype=jnp.bfloat16` and through the port's with `dtype=torch.bfloat16`,
at tiny shapes and narrow widths on the CPU.  Each comparison states its
tolerance beside its witness, JAX bf16 against JAX float32 on the same
inputs and weights, and asserts the witness, so that a port running in
float32 would fail it.

JAX's bf16 runs are compiled with XLA's excess precision off
(`EXACT_BF16`).  With it on, XLA's CPU compiler keeps some bf16 values in
float32 across a fusion (a convolution's output into GroupNorm), which
the flax model, and the port, round to bf16.

Two bf16 computations that sum in different orders differ by a bf16 ulp
now and then, and through many layers those flips spread: after
ResNet-50's layer4 or CostRegNet's eight layers, half the elements differ
by an ulp, which is as far as bf16 is from float32.  So the deep networks
are compared block by block, each block fed JAX's bf16 input of that
block, and the whole model is compared with JAX's own bf16 backbone
features and depth probabilities handed to the port's lift, neck, head,
losses and Gaussian branch.  Only the whole loss is compared free-running.
"""

import dataclasses

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import HeadConfig, tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.models import layers as jx_layers
from mvsdet_tpu.models.cost_reg import CostRegNet as JxCostRegNet
from mvsdet_tpu.models.fpn import FPN as JxFPN
from mvsdet_tpu.models.gaussian_head import ToGaussians as JxToGaussians
from mvsdet_tpu.models.head import DetectionHead as JxDetectionHead
from mvsdet_tpu.models.head import head_predict as jx_head_predict
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.models.neck3d import IndoorImVoxelNeck as JxNeck
from mvsdet_tpu.models.resnet import STAGE_BLOCKS
from mvsdet_tpu.models.resnet import Bottleneck as JxBottleneck
from mvsdet_tpu.models.resnet import ResNet50 as JxResNet50
from mvsdet_tpu.ops import voxel_lift as jx_lift

from mvsdet_torch import config as port_config
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.models import layers
from mvsdet_torch.models.cost_reg import CostRegNet
from mvsdet_torch.models.fpn import FPN
from mvsdet_torch.models.gaussian_head import ToGaussians
from mvsdet_torch.models.head import DetectionHead, head_predict
from mvsdet_torch.models.mvsdet import MVSDet
from mvsdet_torch.models.neck3d import IndoorImVoxelNeck
from mvsdet_torch.models.resnet import Bottleneck, ResNet50
from mvsdet_torch.ops import lift_kernel, voxel_lift
from mvsdet_torch.training.loop import create_train_state, train_step

from _lift_cases import lift_case
from test_torch_port_interop import random_variables
from test_torch_port_kernels import lift_inputs
from test_torch_port_training import train_config

BF16 = torch.bfloat16
EXACT_BF16 = {"xla_allow_excess_precision": False}
# a block's or a shallow module's output: rare one-ulp flips of the sums'
# order (at most 6e-5 measured), against witnesses of 2.1e-3 to 1.5e-2
BLOCK_TOL = 5e-4
# the whole loss, free-running (witness 4.9e-3: JAX bf16 8.785374 against
# float32 8.828728 on this tree; run this file as a script)
LOSS_TOL = 1e-3
# downstream of JAX's own features and depth probabilities: the lift,
# neck, head, losses, Gaussians and render (1e-7 measured; the loss's
# witness 4.8e-3, the render's 3.8e-3) ...
FORCED_TOL = 1e-4
# ... and the step-1 gradients of the neck, head and Gaussian head (3.4e-3
# measured, witness 0.198: bf16 gradients at these tiny widths are mostly
# rounding)
GRAD_TOL = 1e-2
# the witness is asserted at least this many times each tolerance
WELL_INSIDE = 4.0


def jit(fn):
    return jax.jit(fn, compiler_options=EXACT_BF16)


def f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def cf(x) -> torch.Tensor:
    """Channels-last numpy -> channels-first torch tensor (bf16 values
    stay exact in float32)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(f32(x), -1, 1)))


def cl(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().to(torch.float32).numpy(), 1, -1)


def check(got, want16, want32, tol, what):
    """got within tol of JAX bf16, and JAX float32 at least WELL_INSIDE
    tol from JAX bf16."""
    err, witness = rel(got, f32(want16)), rel(f32(want32), f32(want16))
    assert err <= tol, (what, err, witness)
    assert witness >= WELL_INSIDE * tol, (what, err, witness)


# -- modules, each block fed JAX's bf16 input ------------------------------

def block_pair(make_jax, variables, make_port, x, *args):
    """A block's JAX bf16 and float32 outputs on the bf16 input x, and the
    port's, computing in bf16, with the same variables."""
    j16 = jit(make_jax(jnp.bfloat16).apply)(variables, x, *args)
    j32 = jit(make_jax(jnp.float32).apply)(variables, x.astype(jnp.float32),
                                           *args)
    port = make_port(BF16)
    load_flax_variables(port, variables)
    with torch.no_grad():
        got = port(cf(x).to(BF16), *args)
    return j16, j32, got


def test_resnet_blocks_match_jax_bf16():
    """The stem and each of ResNet-50's 16 bottlenecks in bf16, each fed
    JAX's bf16 output of the one before."""
    images = np.random.RandomState(0).randn(2, 32, 48, 3).astype(np.float32)
    tree = random_variables(JxResNet50(), images, seed=1)
    params, frozen = tree["params"], tree["frozen"]

    def stem(dtype):
        conv = fnn.Conv(64, (7, 7), strides=(2, 2), padding=[(3, 3), (3, 3)],
                        use_bias=False, dtype=dtype)
        bn = jx_layers.FrozenBatchNorm(64, dtype=dtype)
        return lambda x: bn.apply({"frozen": frozen["stem_bn"]}, conv.apply(
            {"params": params["stem_conv"]}, x))

    j16 = jit(stem(jnp.bfloat16))(jnp.asarray(images))
    j32 = jit(stem(jnp.float32))(jnp.asarray(images))
    resnet = ResNet50(dtype=BF16)
    load_flax_variables(resnet, tree)
    with torch.no_grad():
        got = resnet.stem_bn(resnet.stem_conv(cf(images)))
    assert got.dtype == BF16 and j16.dtype == jnp.bfloat16
    check(cl(got), j16, j32, BLOCK_TOL, "stem")
    x = jax.lax.reduce_window(jnp.maximum(j16, 0), -jnp.inf, jax.lax.max,
                              (1, 3, 3, 1), (1, 2, 2, 1),
                              ((0, 0), (1, 1), (1, 1), (0, 0)))
    width = 64
    for stage, n_blocks in enumerate(STAGE_BLOCKS[50]):
        for b in range(n_blocks):
            name = f"layer{stage + 1}_block{b}"
            stride = 2 if (b == 0 and stage > 0) else 1
            j16, j32, got = block_pair(
                lambda d: JxBottleneck(width, stride, dtype=d),
                {"params": params[name], "frozen": frozen[name]},
                lambda d: getattr(ResNet50(dtype=d), name), x)
            assert got.dtype == BF16 and j16.dtype == jnp.bfloat16, name
            check(cl(got), j16, j32, BLOCK_TOL, name)
            x = j16
        width *= 2


def test_fpn_matches_jax_bf16():
    rng = np.random.RandomState(2)
    feats = [jnp.asarray(rng.randn(2, 8 // s, 12 // s, c)).astype(
        jnp.bfloat16) for s, c in ((1, 256), (2, 512), (4, 1024), (8, 2048))]
    tree = random_variables(JxFPN(out_channels=32), feats, seed=3)
    j16 = jit(JxFPN(out_channels=32, dtype=jnp.bfloat16).apply)(tree, feats)
    j32 = jit(JxFPN(out_channels=32).apply)(
        tree, [f.astype(jnp.float32) for f in feats])
    fpn = FPN(out_channels=32, dtype=BF16)
    load_flax_variables(fpn, tree)
    with torch.no_grad():
        got = fpn([cf(f).to(BF16) for f in feats])
    for level, (g, w16, w32) in enumerate(zip(got, j16, j32)):
        assert g.dtype == BF16 and w16.dtype == jnp.bfloat16
        check(cl(g), w16, w32, BLOCK_TOL, f"level {level}")


def test_cost_reg_blocks_match_jax_bf16():
    """CostRegNet's eight layers in bf16, each fed JAX's bf16 input (the
    skip sums in bf16, as the module adds them), its logits to float32
    and the softmax as the model takes them (mvsdet.py:152-154)."""
    vol = jnp.asarray(np.random.RandomState(3).rand(2, 4, 8, 12, 16)
                      .astype(np.float32)).astype(jnp.bfloat16)
    port = CostRegNet(in_channels=16, norm="group", dtype=BF16)
    full = random_variables(JxCostRegNet(in_channels=16, norm="group"), vol,
                            False, seed=4)["params"]
    load_flax_variables(port, {"params": full})
    specs = [("conv0", lambda d: jx_layers.ConvBnReLU(
                 64, dims=3, norm="group", dtype=d)),
             ("conv1", lambda d: jx_layers.ConvBnReLU(
                 128, strides=2, dims=3, norm="group", dtype=d)),
             ("conv2", lambda d: jx_layers.ConvBnReLU(
                 128, dims=3, norm="group", dtype=d)),
             ("conv3", lambda d: jx_layers.ConvBnReLU(
                 256, strides=2, dims=3, norm="group", dtype=d)),
             ("conv4", lambda d: jx_layers.ConvBnReLU(
                 256, dims=3, norm="group", dtype=d)),
             ("conv9", lambda d: jx_layers.DeconvBnReLU(
                 128, dims=3, norm="group", dtype=d)),
             ("conv11", lambda d: jx_layers.DeconvBnReLU(
                 64, dims=3, norm="group", dtype=d))]
    outs = {}
    x = vol
    for name, make in specs:
        if name == "conv9":
            x = outs["conv4"]
        elif name == "conv11":
            x = outs["conv2"] + outs["conv9"]
        j16 = jit(lambda v, x: make(jnp.bfloat16).apply(v, x, False))(
            {"params": full[name]}, x)
        j32 = jit(lambda v, x: make(jnp.float32).apply(v, x, False))(
            {"params": full[name]}, x.astype(jnp.float32))
        with torch.no_grad():
            got = getattr(port, name)(cf(x).to(BF16), False)
        assert got.dtype == BF16 and j16.dtype == jnp.bfloat16, name
        check(cl(got), j16, j32, BLOCK_TOL, name)
        outs[name] = j16
        x = j16
    x = outs["conv0"] + outs["conv11"]
    prob = jit(fnn.Conv(2, (3, 3, 3), padding="SAME",
                        dtype=jnp.bfloat16).apply)({"params": full["prob"]}, x)
    prob32 = jit(fnn.Conv(2, (3, 3, 3), padding="SAME").apply)(
        {"params": full["prob"]}, x.astype(jnp.float32))
    with torch.no_grad():
        got = port.prob(cf(x).to(BF16))
    assert got.dtype == BF16
    check(cl(got), prob, prob32, BLOCK_TOL, "prob")
    soft = jax.nn.softmax(prob[..., 0].astype(jnp.float32), axis=1)
    soft32 = jax.nn.softmax(prob32[..., 0], axis=1)
    check(torch.softmax(got[:, 0].to(torch.float32), dim=1).numpy(), soft,
          soft32, 1e-4, "softmax")


@pytest.mark.parametrize("train", [False, True])
def test_neck_matches_jax_bf16(train):
    """The whole neck, in eval and in train mode (batch statistics in
    float32 from bf16 input, running statistics float32 and equal)."""
    vol = jnp.asarray(np.random.RandomState(5).randn(1, 8, 8, 4, 16)
                      .astype(np.float32)).astype(jnp.bfloat16)
    tree = random_variables(JxNeck(in_channels=16, out_channels=8), vol,
                            False, seed=6)

    def run(dtype, x):
        return jit(lambda t, x: JxNeck(
            in_channels=16, out_channels=8, dtype=dtype).apply(
                t, x, train, mutable=["batch_stats"]))(tree, x)

    (j16, stats16), (j32, _) = run(jnp.bfloat16, vol), run(
        jnp.float32, vol.astype(jnp.float32))
    neck = IndoorImVoxelNeck(in_channels=16, out_channels=8, dtype=BF16)
    load_flax_variables(neck, tree)
    with torch.no_grad():
        got = neck(cf(vol).to(BF16), train)
    for level, (g, w16, w32) in enumerate(zip(got, j16, j32)):
        assert g.dtype == BF16 and w16.dtype == jnp.bfloat16
        check(cl(g), w16, w32, BLOCK_TOL, f"level {level}")
    if not train:
        return
    want = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, stats16["batch_stats"])})
    state = neck.state_dict()
    for name, value in want.items():
        assert state[name].dtype == torch.float32
        np.testing.assert_allclose(state[name].numpy(), value, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_head_matches_jax_bf16():
    """center and cls in bf16, bbox in float32: the float32 per-level
    scale promotes the product in JAX (ROADMAP trap T16)."""
    rng = np.random.RandomState(7)
    levels = [jnp.asarray(rng.randn(8 >> i, 8 >> i, 4 >> i, 8)).astype(
        jnp.bfloat16) for i in range(3)]
    cfg = HeadConfig(n_classes=5)
    tree = random_variables(JxDetectionHead(cfg),
                            [l.astype(jnp.float32) for l in levels], seed=8)
    j16 = jit(JxDetectionHead(cfg, dtype=jnp.bfloat16).apply)(tree, levels)
    j32 = jit(JxDetectionHead(cfg).apply)(
        tree, [l.astype(jnp.float32) for l in levels])
    head = DetectionHead(port_config.HeadConfig(n_classes=5), in_channels=8,
                         dtype=BF16)
    load_flax_variables(head, tree)
    with torch.no_grad():
        got = head([cf(l[None]).to(BF16) for l in levels])
    for lvl_t, lvl_16, lvl_32 in zip(got, j16, j32):
        for name, t, w16, w32 in zip(("center", "bbox", "cls"), lvl_t,
                                     lvl_16, lvl_32):
            assert str(t.dtype).replace("torch.", "") == str(w16.dtype), name
            # bbox is float32 (exp of the promoted product): its witness
            # is the bf16 rounding of the conv alone
            check(t.to(torch.float32).numpy(), w16, w32,
                  1e-5 if name == "bbox" else BLOCK_TOL, name)
    assert [o.dtype for o in got[0]] == [BF16, torch.float32, BF16]


def test_to_gaussians_matches_jax_bf16():
    x = np.random.RandomState(8).randn(3, 50, 36).astype(np.float32)
    tree = random_variables(JxToGaussians(out_features=20), x, seed=9)
    j16 = jit(JxToGaussians(out_features=20, dtype=jnp.bfloat16).apply)(
        tree, x)
    j32 = jit(JxToGaussians(out_features=20).apply)(tree, x)
    mod = ToGaussians(36, 20, dtype=BF16)
    load_flax_variables(mod, tree)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.dtype == BF16 and j16.dtype == jnp.bfloat16
    check(got.to(torch.float32).numpy(), j16, j32, BLOCK_TOL, "raw")


# JAX's autodiff casts GroupNorm's bf16 input to float32 twice (for the
# statistics and for the normalisation) and rounds each path's cotangent
# to bf16 before adding them; the port's `F.group_norm` on one float32 copy
# rounds their sum once.  That puts a GroupNorm block's gradients about an
# ulp apart (3.6e-3 measured, witnesses 3.0e-2 and more); every other block
# matches to 1e-8.
GN_GRAD_TOL = 7e-3
BLOCKS = {
    # name: (JAX block for a dtype, port block for a dtype, input shape,
    #        extra call arguments, tolerance)
    "bottleneck_stride2": (
        lambda d: JxBottleneck(16, 2, dtype=d),
        lambda d: Bottleneck(32, 16, 2, dtype=d), (2, 8, 12, 32), (),
        FORCED_TOL),
    "bottleneck_identity": (
        lambda d: JxBottleneck(16, 1, dtype=d),
        lambda d: Bottleneck(64, 16, 1, dtype=d), (2, 4, 6, 64), (),
        FORCED_TOL),
    "conv_group_stride2": (
        lambda d: jx_layers.ConvBnReLU(24, strides=2, dims=3, norm="group",
                                       dtype=d),
        lambda d: layers.ConvBnReLU(16, 24, stride=2, norm="group", dtype=d),
        (2, 4, 8, 12, 16), (False,), GN_GRAD_TOL),
    "deconv_group": (
        lambda d: jx_layers.DeconvBnReLU(16, dims=3, norm="group", dtype=d),
        lambda d: layers.DeconvBnReLU(24, 16, norm="group", dtype=d),
        (2, 2, 4, 6, 24), (False,), GN_GRAD_TOL),
    "conv_batch_train": (
        lambda d: jx_layers.ConvBnReLU(16, dims=3, dtype=d),
        lambda d: layers.ConvBnReLU(8, 16, dtype=d), (1, 8, 8, 4, 8),
        (True,), FORCED_TOL),
    "deconv_batch_train": (
        lambda d: jx_layers.DeconvBnReLU(8, kernel=2, dims=3, dtype=d),
        lambda d: layers.DeconvBnReLU(16, 8, kernel=2, dtype=d),
        (1, 4, 4, 2, 16), (True,), FORCED_TOL),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_gradients_match_jax_bf16(name):
    """One block's gradients in bf16 for a random cotangent of its output:
    every parameter's (float32) and the input's (bf16), against JAX
    bf16's through `jax.grad`; the step-1 gradients of the backbone's and
    CostRegNet's blocks, which the whole-model test does not reach."""
    make_jax, make_port, shape, args, tol = BLOCKS[name]
    rng = np.random.RandomState(len(name))
    x = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(
        jnp.bfloat16)
    variables = random_variables(make_jax(jnp.float32), x, *args, seed=1)
    out_shape = jax.eval_shape(
        lambda v, x: make_jax(jnp.float32).apply(
            v, x, *args, mutable=["batch_stats"])[0], variables, x).shape
    cot = rng.randn(*out_shape).astype(np.float32)
    rest = {k: v for k, v in variables.items() if k != "params"}

    def grads(dtype, x):
        def loss(params, x):
            out, _ = make_jax(dtype).apply({"params": params, **rest}, x,
                                           *args, mutable=["batch_stats"])
            return jnp.sum(out.astype(jnp.float32) * cot)
        g_params, g_x = jit(jax.grad(loss, argnums=(0, 1)))(
            variables["params"], x)
        return flax_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, g_params)}), g_x

    (p16, x16), (p32, x32) = grads(jnp.bfloat16, x), grads(
        jnp.float32, x.astype(jnp.float32))
    port = make_port(BF16)
    load_flax_variables(port, variables)
    xt = cf(x).to(BF16).requires_grad_(True)
    out = port(xt, *args)
    assert out.dtype == BF16
    (out.to(torch.float32) * torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(cot, -1, 1)))).sum().backward()
    assert xt.grad.dtype == BF16 and x16.dtype == jnp.bfloat16
    check(cl(xt.grad), x16, x32, tol, f"{name} input")
    named = dict(port.named_parameters())
    assert set(named) == set(p16)
    assert all(p.grad.dtype == torch.float32 for p in named.values())
    stacked = lambda g: np.concatenate([np.ravel(g[k]) for k in sorted(g)])
    check(np.concatenate([named[k].grad.numpy().ravel()
                          for k in sorted(p16)]),
          stacked(p16), stacked(p32), tol, f"{name} parameters")


def test_layers_keep_float32_parameters_and_refuse_other_dtypes():
    model = MVSDet(train_config(port_config.tiny_test_config()).model,
                   dtype=BF16)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    assert model.head.conv_cls.dtype == model.backbone.stem_bn.dtype == BF16
    with pytest.raises(ValueError, match="bfloat16"):
        MVSDet(train_config(port_config.tiny_test_config()).model,
               dtype=torch.float16)


def test_frozen_batch_norm_keeps_bf16():
    """Its constants are rounded to the compute dtype, as the JAX module
    rounds them (layers.py:41-44); float32 constants would lift a bf16
    input to float32 (ROADMAP trap T16)."""
    rng = np.random.RandomState(5)
    x = jnp.asarray(rng.randn(2, 4, 5, 8)).astype(jnp.bfloat16)
    tree = random_variables(jx_layers.FrozenBatchNorm(8), x)
    want = jit(jx_layers.FrozenBatchNorm(8, dtype=jnp.bfloat16).apply)(tree,
                                                                        x)
    mod = layers.FrozenBatchNorm(8, dtype=BF16)
    load_flax_variables(mod, tree)
    got = mod(cf(x).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(cl(got), f32(want))


# -- the lift ----------------------------------------------------------------

def lift_pair(seed=3):
    feats, proj, est_depth, est_prob, pts = lift_inputs(seed=seed, c=16,
                                                        v=96)
    feats16 = jnp.asarray(feats).astype(jnp.bfloat16)
    return feats16, proj, est_depth, est_prob, pts


def test_lift_matches_jax_on_bf16_features():
    """The port's lift of bf16 features (the plain versions on the CPU)
    against the JAX XLA lift: volume and d-weight (the gradient reaching
    est_prob through the weights) within 1e-5, since bf16 -> float32 is
    exact and only the order of the float32 sums differs; d-feat bf16,
    within one bf16 ulp of the exact sum of the pairs (and 1e-6 of the
    largest, for the float32 sum where it cancels)."""
    feats16, proj, est_depth, est_prob, pts = lift_pair()
    n, h, w, c = feats16.shape
    cot = np.random.RandomState(4).randn(pts.shape[0], c).astype(np.float32)

    def jx_fn(f, p):
        vol, _ = jx_lift.lift_features_to_voxels(
            f, jnp.asarray(proj), jnp.asarray(est_depth), p, jnp.asarray(pts),
            0.4)
        return vol

    vol_j, vjp = jax.vjp(jx_fn, feats16, jnp.asarray(est_prob))
    dfeat_j, dprob_j = vjp(jnp.asarray(cot))
    f = torch.from_numpy(f32(feats16)).to(BF16).requires_grad_(True)
    p = torch.from_numpy(est_prob).requires_grad_(True)
    vol_t, cnt_t = voxel_lift.lift_features_to_voxels(
        f, *map(torch.from_numpy, (proj, est_depth)), p,
        torch.from_numpy(pts), 0.4)
    assert vol_t.dtype == torch.float32 and vol_j.dtype == jnp.float32
    assert rel(vol_t.detach().numpy(), vol_j) <= 1e-5
    assert np.abs(np.asarray(vol_j)).max() > 0
    vol_t.backward(torch.from_numpy(cot))
    assert f.grad.dtype == BF16 and dfeat_j.dtype == jnp.bfloat16
    assert rel(p.grad.numpy(), dprob_j) <= 1e-5
    assert np.abs(np.asarray(dprob_j)).max() > 0
    # the exact d-feat from the port's (pix, weight), bit-equal to JAX's
    prob_norm = torch.from_numpy(est_prob) / (torch.from_numpy(est_prob)
                                              .sum(-1, keepdim=True) + 1e-12)
    pix, weight, _ = voxel_lift._pixel_weights(
        torch.from_numpy(proj), torch.from_numpy(est_depth), prob_norm,
        torch.from_numpy(pts), 0.4)
    exact = np.zeros((n, h * w, c))
    for i in range(n):
        np.add.at(exact[i], pix[i].numpy(), weight[i].numpy()[:, None]
                  .astype(np.float64) * cot.astype(np.float64))
    got = f.grad.to(torch.float32).numpy().reshape(n, h * w, c)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(exact), 1e-30))) - 7)
    assert np.all(np.abs(got - exact) <= ulp + 1e-6 * np.abs(exact).max())
    assert np.abs(exact).max() > 0


@pytest.mark.parametrize("kind", ["uniform", "clipped", "zero_weight"])
def test_bf16_plain_versions_are_the_float32_ones_on_widened_rows(kind):
    """K3's and K5's plain versions on bf16 rows equal theirs on the rows
    widened to float32; both d-feat plain versions in bf16 equal theirs in
    float32 rounded once."""
    feat, pix, weight, g = map(torch.from_numpy, lift_case(kind, 3, 40, 8,
                                                           50))
    feat16 = feat.to(BF16)
    wide = feat16.to(torch.float32)
    assert torch.equal(lift_kernel.weighted_gather_sum(feat16, pix, weight),
                       lift_kernel.weighted_gather_sum(wide, pix, weight))
    assert torch.equal(
        lift_kernel.weighted_gather_sum_dweight(feat16, pix, g),
        lift_kernel.weighted_gather_sum_dweight(wide, pix, g))
    rows = lift_kernel.lift_rows(pix, 40)
    for fn, args in ((lift_kernel.weighted_gather_sum_dfeat_reference,
                      (pix, weight, g, 40)),
                     (lift_kernel.weighted_gather_sum_dfeat_rows_reference,
                      (rows, weight, g, 40))):
        got = fn(*args, BF16)
        assert got.dtype == BF16
        assert torch.equal(got, fn(*args).to(BF16))
    got = lift_kernel.weighted_gather_sum_dfeat(pix, weight, g, 40, rows,
                                                BF16)
    assert got.dtype == BF16


def test_gather_takes_float32_or_bf16_rows_only():
    feat, pix, weight, g = map(torch.from_numpy, lift_case("uniform", 2, 10,
                                                           4, 6))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            lift_kernel.weighted_gather_sum(feat.to(dtype), pix, weight)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            lift_kernel.weighted_gather_sum_dweight(feat.to(dtype), pix, g)
        with pytest.raises(TypeError):
            lift_kernel.weighted_gather_sum_dfeat(pix, weight, g, 10,
                                                  dtype=dtype)
    with pytest.raises(TypeError, match="float32 g"):
        lift_kernel.weighted_gather_sum_dweight(feat.to(BF16), pix,
                                                g.to(BF16))
    with pytest.raises(TypeError, match="float32 weights"):
        lift_kernel.weighted_gather_sum(feat.to(BF16), pix, weight.to(BF16))


# -- head_predict on JAX's own bf16 head outputs -----------------------------

def test_head_predict_on_jax_bf16_outputs_keeps_ties_in_order():
    """bf16 scores tie often at nonzero values, and JAX's top_k takes the
    lower index first (ROADMAP trap T15): the same head outputs give the
    same boxes, scores and labels, in the same slots."""
    cfg = narrow_model_config()
    scene = make_synthetic_scene(cfg, seed=0, n_views=5, n_targets=1)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx_model = JxMVSDet(cfg.model, sweep_method="gather",
                        dtype=jnp.bfloat16)
    tree = random_variables(jx_model, batch, method=JxMVSDet.predict)
    res = jit(lambda t, b: jx_model.apply(t, b))(tree, batch)
    outs = [tuple(np.asarray(o) for o in lvl) for lvl in res["head_outs"]]
    pts = [np.asarray(p) for p in res["points"]]
    valids = [np.asarray(v) for v in res["valids"]]
    want = jx_head_predict(outs, pts, valids, cfg.model.head)
    assert outs[0][0].dtype == outs[0][2].dtype == jnp.bfloat16
    got = head_predict(
        [(torch.from_numpy(f32(c)).to(BF16), torch.from_numpy(r),
          torch.from_numpy(f32(s)).to(BF16)) for c, r, s in outs],
        [torch.from_numpy(p) for p in pts],
        [torch.from_numpy(v) for v in valids],
        port_config.tiny_test_config().model.head)
    assert got["scores"].dtype == BF16
    mask = np.asarray(want["mask"])
    assert mask.sum() > 0
    np.testing.assert_array_equal(got["mask"].numpy(), mask)
    for key in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(
            got[key].to(torch.float32).numpy()[mask],
            f32(want[key])[mask], err_msg=key)
    # nonzero scores that tie among the ones taken: the case top_k orders
    c, _, s = outs[0]
    score = f32(jax.nn.sigmoid(s) * jax.nn.sigmoid(c)
                * valids[0][:, None].astype(s.dtype)).max(1)
    k = min(cfg.model.head.nms_pre, score.shape[0])
    top = np.sort(score)[::-1][:k]
    top = top[top > 0]
    assert len(np.unique(top)) < len(top)


# -- the depth hypotheses on tied bf16 probabilities -------------------------

def test_sample_depth_breaks_ties_as_jax():
    """bf16 CostRegNet logits give equal depth probabilities often, and
    `jax.lax.top_k` takes the lower plane first among them (ROADMAP F1):
    on bf16-rounded probabilities with ties, and a pixel whose 12 planes
    are all equal, the port's `MVSDet.sample_depth` picks the planes JAX
    picks, in JAX's order."""
    cfg_j, cfg_t = tiny_test_config(), port_config.tiny_test_config()
    mc_j = dataclasses.replace(cfg_j.model, topk=3)
    mc_t = dataclasses.replace(cfg_t.model, topk=3)
    rng = np.random.RandomState(7)
    logits = rng.randint(0, 4, (2, 12, 6, 8)).astype(np.float32) * 0.5
    logits[0, :, 0, 0] = 1.5                            # 12 equal planes
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    prob = np.array(f32(jnp.asarray(prob).astype(jnp.bfloat16)))
    off = rng.rand(*prob.shape).astype(np.float32)
    model_j = JxMVSDet(mc_j, sweep_method="gather")
    model_t = MVSDet(mc_t, sweep_method="gather")
    near, interval = mc_t.near_far_range[0], mc_t.depth_interval
    planes = {}
    for name, o in (("zero offsets", np.zeros_like(off)), ("offsets", off)):
        want = [np.asarray(x) for x in model_j.apply(
            {}, jnp.asarray(prob), jnp.asarray(o),
            method=JxMVSDet.sample_depth)]
        got = [x.numpy() for x in model_t.sample_depth(
            torch.from_numpy(prob), torch.from_numpy(o))]
        np.testing.assert_array_equal(got[1], want[1], err_msg=name)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        planes[name] = [np.rint((x[0] - near) / interval).astype(int)
                        for x in (got, want)]
    got_planes, want_planes = planes["zero offsets"]
    np.testing.assert_array_equal(got_planes, want_planes)
    np.testing.assert_array_equal(want_planes[0, 0, 0], [0, 1, 2])
    # ties decide the planes taken or their order on many pixels
    top = np.sort(np.moveaxis(prob, 1, -1), -1)[..., ::-1][..., :4]
    assert (top[..., 1:] == top[..., :-1]).any(-1).mean() > 0.5


# -- the whole model ---------------------------------------------------------

def narrow_model_config():
    return train_config(tiny_test_config())


@pytest.fixture(scope="module")
def model_runs():
    """JAX's bf16 and float32 losses, step-1 gradients and predicts on one
    tree, with JAX bf16's FPN features and depth probabilities."""
    cfg = narrow_model_config()
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx16 = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=2,
                    dtype=jnp.bfloat16)
    jx32 = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=2)
    tree = random_variables(jx32, batch, method=JxMVSDet.loss)

    def loss_and_grads(model):
        def loss(params):
            (total, aux), _ = model.apply(
                {"params": params, "batch_stats": tree["batch_stats"],
                 "frozen": tree["frozen"]}, batch, method=JxMVSDet.loss,
                mutable=["batch_stats"])
            return total, aux
        (total, aux), grads = jit(jax.value_and_grad(loss, has_aux=True))(
            tree["params"])
        return ({k: float(v) for k, v in aux.items()} | {"loss": float(total)},
                flax_to_state_dict({"params": jax.tree_util.tree_map(
                    np.asarray, grads)}))

    def capture(train):
        """JAX bf16's own features and depth probabilities."""
        def run(t, b):
            out, inter = jx16.apply(
                t, b, train, mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, method: method in (
                    "image_features", "depth_probabilities"))
            return inter["intermediates"]
        inter = jit(run)(tree, batch)
        return (f32(inter["image_features"][0]),
                tuple(np.asarray(a) for a in inter["depth_probabilities"][0]))

    def predict(model):
        def run(t, b):
            res = model.apply(t, b)
            return res, jx_head_predict(res["head_outs"], res["points"],
                                        res["valids"], cfg.model.head)
        return jax.tree_util.tree_map(np.asarray, jit(run)(tree, batch))

    return dict(cfg=cfg, scene=scene, tree=tree,
                loss16=loss_and_grads(jx16), loss32=loss_and_grads(jx32),
                forced_train=capture(True), forced_eval=capture(False),
                predict16=predict(jx16), predict32=predict(jx32))


def port_model(runs, forced=None):
    model = MVSDet(train_config(port_config.tiny_test_config()).model,
                   sweep_chunk=2, sweep_method="gather", dtype=BF16)
    load_flax_variables(model, runs["tree"])
    if forced is not None:
        feats, (prob, off) = forced
        model.image_features = lambda images: torch.from_numpy(feats).to(
            BF16)
        model.depth_probabilities = lambda *args: (torch.from_numpy(prob),
                                                   torch.from_numpy(off))
    return model


def scene_tensors(runs):
    return {k: torch.from_numpy(np.asarray(v))
            for k, v in runs["scene"].items()}


def test_loss_matches_jax_bf16(model_runs):
    """The whole bf16 loss, free-running: within LOSS_TOL of JAX bf16,
    whose distance from JAX float32 is the witness."""
    model = port_model(model_runs).train()
    total, aux = model.loss(scene_tensors(model_runs))
    want, want32 = model_runs["loss16"][0], model_runs["loss32"][0]
    assert total.dtype == torch.float32
    assert float(aux["n_pos"]) == want["n_pos"] > 0
    err = abs(total.item() - want["loss"]) / want["loss"]
    witness = abs(want32["loss"] - want["loss"]) / want["loss"]
    assert err <= LOSS_TOL, (err, witness)
    assert witness >= WELL_INSIDE * LOSS_TOL, witness


def test_losses_and_gradients_downstream_match_jax_bf16(model_runs):
    """With JAX bf16's own FPN features and depth probabilities, every
    loss term within FORCED_TOL and the step-1 gradients of the lift's
    consumers (neck, head, Gaussian head) within GRAD_TOL of JAX bf16's.
    The networks before them are held block by block above."""
    model = port_model(model_runs, model_runs["forced_train"]).train()
    total, aux = model.loss(scene_tensors(model_runs))
    total.backward()
    want, grads16 = model_runs["loss16"]
    want32, grads32 = model_runs["loss32"]
    for key in ("loss", "center_loss", "bbox_loss", "cls_loss", "loss_nvs"):
        got = total.item() if key == "loss" else aux[key].item()
        err = abs(got - want[key]) / abs(want[key])
        witness = abs(want32[key] - want[key]) / abs(want[key])
        assert err <= FORCED_TOL, (key, err, witness)
    witness_total = abs(want32["loss"] - want["loss"]) / want["loss"]
    assert witness_total >= WELL_INSIDE * FORCED_TOL
    downstream = [n for n, p in model.named_parameters()
                  if n.startswith(("neck3d.", "head.", "to_gaussians."))]
    assert all(p.grad is None for n, p in model.named_parameters()
               if n.startswith(("backbone.", "fpn.", "cost_reg.")))

    def stacked(grads):
        return np.concatenate([np.ravel(grads[n]) for n in downstream])

    got = np.concatenate([p.grad.numpy().ravel()
                          for n, p in model.named_parameters()
                          if n in downstream])
    assert all(p.grad.dtype == torch.float32 for n, p in
               model.named_parameters() if n in downstream)
    check(got, stacked(grads16), stacked(grads32), GRAD_TOL,
          "downstream gradients")


def test_predict_downstream_matches_jax_bf16(model_runs):
    """With JAX bf16's own features and depth probabilities: the rendered
    targets within FORCED_TOL, and the kept boxes, scores and labels
    equal under the mask."""
    model = port_model(model_runs, model_runs["forced_eval"]).eval()
    with torch.no_grad():
        pred = model.predict(scene_tensors(model_runs))
    res16, pred16 = model_runs["predict16"]
    res32, _ = model_runs["predict32"]
    check(pred["rendered"].numpy(), res16["rendered"], res32["rendered"],
          FORCED_TOL, "rendered")
    mask = pred16["mask"]
    assert mask.sum() > 0
    np.testing.assert_array_equal(pred["mask"].numpy(), mask)
    np.testing.assert_array_equal(pred["labels"].numpy()[mask],
                                  pred16["labels"][mask])
    np.testing.assert_array_equal(
        pred["scores"].to(torch.float32).numpy()[mask],
        f32(pred16["scores"])[mask])
    np.testing.assert_allclose(pred["boxes"].numpy()[mask],
                               pred16["boxes"][mask], rtol=1e-5, atol=1e-5)


def test_train_step_keeps_float32_state(model_runs):
    """One bf16 train_step: the parameters, their gradients, the BN
    running statistics and the AdamW moments stay float32; the losses
    are JAX bf16's free-running loss within LOSS_TOL."""
    cfg = train_config(port_config.tiny_test_config())
    state = create_train_state(cfg, device="cpu", sweep_chunk=2,
                               steps_per_epoch=1, dtype=BF16,
                               sweep_method="gather")
    load_flax_variables(state.model, model_runs["tree"])
    metrics = train_step(state, scene_tensors(model_runs))
    assert state.model.dtype == BF16 and state.step == 1
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert {b.dtype for b in state.model.buffers()} == {torch.float32}
    assert {p.grad.dtype for p in state.model.parameters()
            if p.grad is not None} == {torch.float32}
    moments = [v for s in state.optimizer.state.values() for v in s.values()
               if torch.is_tensor(v) and v.ndim > 0]
    assert moments and {v.dtype for v in moments} == {torch.float32}
    want = model_runs["loss16"][0]["loss"]
    assert abs(float(metrics["loss"]) - want) / want <= LOSS_TOL


if __name__ == "__main__":
    # The witness of the loss tolerance and the Pallas lift's bf16
    # rounding, on the tree and scene of `model_runs`: JAX's loss in
    # float32 and in bf16, the bf16 one with the XLA lift (the port's) and
    # with the Pallas lift, which also rounds its weights and cotangent to
    # bf16 (mvsdet_tpu/ops/pallas/lift_kernel.py:125,153-155), compiled as
    # JAX compiles them by default:
    #   PYTHONPATH=. python tests/test_torch_port_bf16.py
    import dataclasses
    import json

    cfg = narrow_model_config()
    batch = {k: jnp.asarray(v) for k, v in make_synthetic_scene(
        cfg, seed=0, n_views=4, n_targets=2).items()}
    tree = random_variables(JxMVSDet(cfg.model, sweep_method="gather",
                                     sweep_chunk=2),
                            batch, method=JxMVSDet.loss)
    losses = {}
    for name, dtype, lift in (("float32", jnp.float32, "xla"),
                              ("bf16", jnp.bfloat16, "xla"),
                              ("bf16_pallas_lift", jnp.bfloat16, "pallas")):
        model = JxMVSDet(dataclasses.replace(cfg.model, lift_impl=lift),
                         sweep_method="gather", sweep_chunk=2, dtype=dtype)
        (total, aux), _ = jax.jit(lambda t, b: model.apply(
            t, b, method=JxMVSDet.loss, mutable=["batch_stats"]))(tree, batch)
        losses[name] = {"loss": float(total),
                        **{k: float(v) for k, v in aux.items()}}
    print(json.dumps({"losses": losses, "witness_rel": abs(
        losses["float32"]["loss"] - losses["bf16"]["loss"])
        / losses["bf16"]["loss"]}))
