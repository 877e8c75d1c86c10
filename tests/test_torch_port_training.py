"""The port's training step against the JAX package's.

The head's targets and losses, train-mode BatchNorm, the optimizer, and
three whole `train_step`s against JAX `train_step` with
`MVSDet(cfg.model, sweep_method="gather", sweep_chunk=2)` and
`build_optimizer`, both from one numpy-seeded variable tree carried across
by the weight bridge, at tiny shapes and narrow widths on the CPU.
"""

import copy
import dataclasses

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import OptimConfig as JxOptimConfig
from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.models import head as jx_head
from mvsdet_tpu.models import layers as jx_layers
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.training.loop import TrainState as JxTrainState
from mvsdet_tpu.training.loop import train_step as jx_train_step
from mvsdet_tpu.training.optim import build_optimizer as jx_build_optimizer

from mvsdet_torch import config as port_config
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.data.prefetch import prefetch_iterator
from mvsdet_torch.models import head, layers
from mvsdet_torch.models.resnet import ResNet50
from mvsdet_torch.training.loop import (create_train_state, fit,
                                        load_checkpoint, make_train_step,
                                        save_checkpoint, train_step)
from mvsdet_torch.training.optim import (build_optimizer,
                                         clip_by_global_norm_, param_label)

from test_torch_port_interop import narrow, random_variables

# The whole-step comparison runs at the JAX package's own learning-test lr
# (tests/test_training.py:65).  Adam turns a gradient that is rounding
# noise into a step of about +-lr, so the few parameters whose true
# gradient is ~0 differ by up to ~2 lr; at the default 2e-4 those steps
# feed the third step's losses at ~3e-4 relative, at 2e-5 at <= 3e-5.
# JAX against itself with another sweep chunk drifts as far (run this
# file as a script).
LR = 2e-5
STEPS = 3
# Leaves held to 3 lr after three steps instead of 1e-5.
# cost_reg.prob.bias[0] shifts the depth logits of every plane at once,
# which the softmax over D cancels: its true gradient is exactly 0.  The
# others are the 3D convolutions in which a few elements (89 of 29.4M)
# have a gradient below rounding noise and end up past 1e-5; the script
# run prints them.
NOISE_LEAVES = (
    "cost_reg.prob.bias",
    "cost_reg.conv1.conv.weight",
    "cost_reg.conv3.conv.weight",
    "cost_reg.conv4.conv.weight",
    "cost_reg.conv9.conv.weight",
    "cost_reg.conv11.conv.weight",
    "neck3d.down1_block0.conv1.conv.weight",
    "neck3d.down1_block0.conv2.conv.weight",
    "neck3d.down2_block0.conv1.conv.weight",
    "neck3d.down2_block0.conv2.conv.weight",
    "neck3d.down2_block0.downsample.conv.weight",
    "neck3d.up2_deconv.conv.weight",
)


def train_config(cfg):
    """`narrow(tiny_test_config())` at the test lr and splat capacity 256."""
    cfg = narrow(cfg)
    return dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, lr=LR),
        model=dataclasses.replace(cfg.model, gs=dataclasses.replace(
            cfg.model.gs, splat_capacity=256)))


def rel(got, want):
    want = np.asarray(want)
    return np.linalg.norm(np.asarray(got) - want) / max(
        np.linalg.norm(want), 1e-30)


# -- head targets and losses ------------------------------------------------

def head_inputs(seed=0):
    """Three levels of random points, head outputs and validity; five
    boxes (two of equal size, so the smallest-box rule meets a tie) and
    three padded ones."""
    rng = np.random.RandomState(seed)
    cfg = port_config.tiny_test_config().model.head
    sizes = (400, 150, 60)
    points = [rng.uniform(-1, 1, (n, 3)).astype(np.float32) for n in sizes]
    valids = [rng.rand(n) > 0.2 for n in sizes]
    outs = [(rng.randn(n, 1).astype(np.float32),
             (0.3 * np.exp(0.3 * rng.randn(n, 6))).astype(np.float32),
             (rng.randn(n, cfg.n_classes) - 2).astype(np.float32))
            for n in sizes]
    boxes = np.zeros((cfg.max_boxes, 6), np.float32)
    boxes[:5, :3] = rng.uniform(-0.6, 0.6, (5, 3))
    boxes[:5, 3:] = rng.uniform(0.4, 1.2, (5, 3))
    boxes[1] = boxes[0] + [0.05, 0.0, 0.0, 0.0, 0.0, 0.0]
    labels = rng.randint(0, cfg.n_classes, cfg.max_boxes).astype(np.int32)
    labels[:2] = 0, 1
    mask = np.arange(cfg.max_boxes) < 5
    return cfg, outs, points, valids, boxes, labels, mask


class TestHeadLoss:
    def test_assign_targets_equal(self):
        cfg, _, points, _, boxes, labels, mask = head_inputs()
        pts = np.concatenate(points)
        scales = np.concatenate([np.full(len(p), i, np.int32)
                                 for i, p in enumerate(points)])
        want = jx_head.assign_targets(pts, scales, boxes, labels, mask, cfg)
        got = head.assign_targets(*map(torch.from_numpy,
                                       (pts, scales.astype(np.int64), boxes,
                                        labels, mask)), cfg)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for t, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
        labels_t = np.asarray(want[2])
        assert (labels_t >= 0).sum() > 10
        assert len(np.unique(labels_t[labels_t >= 0])) >= 2
        # boxes 0 and 1 tie on volume; swapping them moves the tied points
        # to the other label, so the first-index rule is exercised
        order = [1, 0] + list(range(2, len(boxes)))
        swapped = jx_head.assign_targets(pts, scales, boxes[order],
                                         labels[order], mask[order], cfg)
        assert np.any(np.asarray(swapped[2]) != labels_t)

    def test_losses_and_gradients_match_jax(self):
        cfg, outs, points, valids, boxes, labels, mask = head_inputs()

        def jx_terms(outs):
            losses, aux = jx_head.head_loss(outs, points, valids, boxes,
                                            labels, mask, cfg)
            return sum(losses.values()), (losses, aux)

        (_, (want, aux)), want_grads = jax.value_and_grad(
            jx_terms, has_aux=True)(jax.tree_util.tree_map(jnp.asarray,
                                                           outs))
        t_outs = [tuple(torch.from_numpy(a).requires_grad_(True) for a in lvl)
                  for lvl in outs]
        got, got_aux = head.head_loss(
            t_outs, [torch.from_numpy(p) for p in points],
            [torch.from_numpy(v) for v in valids],
            *map(torch.from_numpy, (boxes, labels, mask)), cfg)
        assert float(got_aux["n_pos"]) == float(aux["n_pos"]) > 0
        for key, value in want.items():
            assert abs(got[key].item() - float(value)) <= 1e-5 * abs(
                float(value)), key
        sum(got.values()).backward()
        for lvl_t, lvl_w in zip(t_outs, want_grads):
            for t, w in zip(lvl_t, lvl_w):
                assert np.abs(t.grad.numpy() - np.asarray(w)).max() <= \
                    1e-5 * np.abs(np.asarray(w)).max()

    def test_focal_loss_background_label_gives_zero_one_hot(self):
        logits = np.random.RandomState(2).randn(6, 4).astype(np.float32) * 3
        labels = np.array([-1, 0, 3, -1, 2, 1], np.int32)
        want = jx_head.sigmoid_focal_loss(logits, labels, 2.0, 0.25)
        got = head.sigmoid_focal_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels), 2.0, 0.25)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    def test_softplus_has_no_threshold(self):
        x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 25.0, 40.0])
        want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
        np.testing.assert_allclose(head.softplus(x).numpy(), want,
                                   rtol=1e-7)


# -- train-mode BatchNorm --------------------------------------------------

def test_batch_norm_train_mode_matches_flax():
    """Output, gradients and running statistics of a train-mode conv block
    at the tiny neck's 8x8x4 grid, where torch's unbiased running variance
    would be 256/255 of flax's biased one (ROADMAP trap T4)."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 8, 4, 6).astype(np.float32) * 2 + 0.5
    target = rng.randn(1, 8, 8, 4, 10).astype(np.float32)
    jx = jx_layers.ConvBnReLU(10, dims=3, norm="batch")
    tree = random_variables(jx, x, False)

    def loss(params, x):
        out, upd = jx.apply({"params": params,
                             "batch_stats": tree["batch_stats"]}, x, True,
                            mutable=["batch_stats"])
        return jnp.sum(out * target), upd["batch_stats"]

    (_, stats), grads = jax.value_and_grad(loss, has_aux=True)(
        tree["params"], x)
    mod = layers.ConvBnReLU(6, 10, norm="batch")
    load_flax_variables(mod, tree)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    (mod(xt, True) * torch.from_numpy(target).permute(0, 4, 1, 2, 3)) \
        .sum().backward()
    got = dict(mod.named_parameters())
    want = flax_to_state_dict({"params": grads, "batch_stats": stats})
    for key in ("conv.weight", "norm.weight", "norm.bias"):
        assert rel(got[key].grad.numpy(), want[key]) <= 1e-5, key
    for key in ("norm.running_mean", "norm.running_var"):
        np.testing.assert_allclose(mod.state_dict()[key].numpy(), want[key],
                                   rtol=1e-6, atol=1e-7)
    # eval mode reads the running statistics and leaves them alone
    before = mod.norm.running_var.clone()
    mod(xt, False)
    assert torch.equal(mod.norm.running_var, before)


# -- optimizer --------------------------------------------------------------

OPT_TREE = {
    "backbone.stem_conv.weight": (4, 3),
    "backbone.layer1_block0.conv1.weight": (5,),
    "backbone.layer2_block0.conv1.weight": (3, 3),
    "backbone.layer3_block1.conv2.weight": (6,),
    "head.conv_cls.weight": (4, 2),
    "head.conv_cls.bias": (2,),
    "neck3d.out0.norm.weight": (7,),
}


def _frozen(name):
    """Stem and layer1, which `frozen_stages=1` freezes."""
    return name.startswith(("backbone.stem_", "backbone.layer1_"))


def _nested(flat):
    tree = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _module(flat):
    root = torch.nn.Module()
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = root
        for key in path:
            if not hasattr(node, key):
                node.add_module(key, torch.nn.Module())
            node = getattr(node, key)
        node.register_parameter(leaf, torch.nn.Parameter(
            torch.from_numpy(value.copy()),
            requires_grad=not _frozen(name)))
    return root


def test_optimizer_matches_optax_chain():
    """Five updates, the clip active on some and a milestone crossed, the
    frozen leaves left as they were."""
    rng = np.random.RandomState(0)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in OPT_TREE.items()}
    cfg = port_config.OptimConfig(milestones=(2, 4))
    tx = jx_build_optimizer(JxOptimConfig(milestones=(2, 4)),
                            _nested(params), steps_per_epoch=1)
    jx_params = jax.tree_util.tree_map(jnp.asarray, _nested(params))
    opt_state = tx.init(jx_params)
    model = _module(params)
    optimizer, scheduler = build_optimizer(cfg, model, steps_per_epoch=1)
    assert [g["lr"] for g in optimizer.param_groups] == [2e-4, 2e-5]
    named = dict(model.named_parameters())
    clipped = 0
    for step in range(5):
        scale = 30.0 if step % 2 == 0 else 0.5
        # frozen leaves get the zero gradient the model gives them (the
        # stop after layer1), which also keeps them out of the norm
        grads = {k: (scale * rng.randn(*s)
                     * (not _frozen(k))).astype(np.float32)
                 for k, s in OPT_TREE.items()}
        updates, opt_state = tx.update(_nested(grads), opt_state, jx_params)
        jx_params = optax.apply_updates(jx_params, updates)
        for name, p in named.items():
            p.grad = (torch.from_numpy(grads[name]) if p.requires_grad
                      else None)
        g_norm = clip_by_global_norm_(model.parameters(), 35.0)
        clipped += float(g_norm) >= 35.0
        optimizer.step()
        scheduler.step()
        flax_like = jax.tree_util.tree_map(np.asarray, jx_params)
        for name, p in named.items():
            node = flax_like
            for key in name.split("."):
                node = node[key]
            np.testing.assert_allclose(p.detach().numpy(), node, rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {step}")
            if not p.requires_grad:
                np.testing.assert_array_equal(p.detach().numpy(),
                                              params[name])
    assert 0 < clipped < 5
    assert scheduler.get_last_lr() == pytest.approx([2e-6, 2e-7])


@pytest.mark.parametrize("frozen_stages", [0, 1, 2])
def test_optimizer_leaves_out_the_stages_the_backbone_freezes(frozen_stages):
    """The frozen group follows `frozen_stages` as `ResNet50` applies it;
    the other backbone parameters take the backbone lr."""
    model = torch.nn.Module()
    model.backbone = ResNet50(frozen_stages=frozen_stages)
    model.head = torch.nn.Linear(2, 2)
    optimizer, _ = build_optimizer(port_config.OptimConfig(), model)
    default, backbone = ({id(p) for p in g["params"]}
                         for g in optimizer.param_groups)
    frozen = (("backbone.stem_",) + tuple(
        f"backbone.layer{i + 1}_" for i in range(frozen_stages))
        if frozen_stages else ())
    for name, p in model.named_parameters():
        assert param_label(name, p) == (
            "frozen" if name.startswith(frozen) else
            "backbone" if name.startswith("backbone.") else "default"), name
        assert (id(p) in backbone) == (param_label(name, p) == "backbone")
        assert (id(p) in default) == name.startswith("head.")


def test_prefetch_stages_in_order_and_stops():
    batches = [{"x": np.full(3, i, np.float32)} for i in range(5)]
    got = list(prefetch_iterator(iter(batches), "cpu"))
    assert [b["x"].tolist() for b in got] == [[float(i)] * 3
                                              for i in range(5)]
    assert all(isinstance(b["x"], torch.Tensor) for b in got)
    assert list(prefetch_iterator([], "cpu")) == []


def test_schedule_steps_down_at_the_milestone_epochs():
    """MultiStepLR counted in steps: x0.1 from step 80 and from step 110
    at 10 steps per epoch, both groups (optim.py:36-39)."""
    model = _module({"head.w": np.zeros(2, np.float32),
                     "backbone.layer2_block0.w": np.zeros(2, np.float32)})
    optimizer, scheduler = build_optimizer(port_config.OptimConfig(), model,
                                           steps_per_epoch=10)
    lrs = {}
    for step in range(111):
        lrs[step] = [g["lr"] for g in optimizer.param_groups]
        optimizer.step()
        scheduler.step()
    assert lrs[79] == pytest.approx([2e-4, 2e-5])
    assert lrs[80] == pytest.approx([2e-5, 2e-6])
    assert lrs[110] == pytest.approx([2e-6, 2e-7])


# -- three whole steps ------------------------------------------------------

def jax_steps(cfg, batch, tree, sweep_chunk: int = 2):
    """`STEPS` JAX train steps from ``tree``: each step's metrics and the
    final variables as a state dict."""
    jx_model = JxMVSDet(cfg.model, sweep_method="gather",
                        sweep_chunk=sweep_chunk)
    tx = jx_build_optimizer(cfg.optim, tree["params"], steps_per_epoch=1)
    state = JxTrainState(step=jnp.zeros((), jnp.int32), params=tree["params"],
                         batch_stats=tree["batch_stats"],
                         frozen=tree["frozen"],
                         opt_state=tx.init(tree["params"]))
    jx_step = jax.jit(lambda s, b: jx_train_step(jx_model, tx, s, b))
    metrics = []
    for _ in range(STEPS):
        state, m = jx_step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    final = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats,
        "frozen": state.frozen}))
    return metrics, final


def compare_steps(lr: float = LR) -> dict:
    """JAX and the port, `STEPS` train steps each from one variable tree at
    learning rate ``lr``; plus each side's step-1 gradients (the port's
    from a copy of its model, since `train_step` clips in place)."""
    cfg = train_config(tiny_test_config())
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                             lr=lr))
    scene = make_synthetic_scene(cfg, seed=0, n_views=4, n_targets=2)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx_model = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=2)
    tree = random_variables(jx_model, batch, method=JxMVSDet.loss)

    def loss_fn(params):
        (total, _), _ = jx_model.apply(
            {"params": params, "batch_stats": tree["batch_stats"],
             "frozen": tree["frozen"]}, batch, method=JxMVSDet.loss,
            mutable=["batch_stats"])
        return total

    jx_grads = jax.jit(jax.grad(loss_fn))(tree["params"])
    jx_metrics, jx_final = jax_steps(cfg, batch, tree)

    pt = create_train_state(cfg_port(lr), device="cpu", sweep_chunk=2,
                            steps_per_epoch=1)
    load_flax_variables(pt.model, tree)
    initial = {k: v.clone() for k, v in pt.model.state_dict().items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in scene.items()}
    probe = copy.deepcopy(pt.model)
    probe.loss(tb)[0].backward()
    pt_metrics = [{k: float(v) for k, v in train_step(pt, tb).items()}
                  for _ in range(STEPS)]
    return dict(
        jx_grads=flax_to_state_dict({"params": jax.tree_util.tree_map(
            np.asarray, jx_grads)}),
        pt_grads={k: p.grad for k, p in probe.named_parameters()},
        jx_metrics=jx_metrics, pt_metrics=pt_metrics, jx_final=jx_final,
        state=pt, initial=initial, scene=scene, cfg=cfg, batch=batch,
        tree=tree)


def cfg_port(lr: float = LR):
    cfg = train_config(port_config.tiny_test_config())
    return dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim,
                                                              lr=lr))


@pytest.fixture(scope="module")
def steps():
    return compare_steps(LR)


def test_losses_match_jax_each_step(steps):
    for i, (t, j) in enumerate(zip(steps["pt_metrics"], steps["jx_metrics"])):
        assert set(t) == set(j) == {"loss", "center_loss", "bbox_loss",
                                    "cls_loss", "loss_nvs", "n_pos"}
        assert t["n_pos"] == j["n_pos"] > 0
        for key, value in j.items():
            assert abs(t[key] - value) <= 1e-4 * abs(value), (i, key)


def test_first_step_gradients_match_jax(steps):
    jx_grads, pt_grads = steps["jx_grads"], steps["pt_grads"]
    assert set(pt_grads) == set(jx_grads)
    for name, want in jx_grads.items():
        got = pt_grads[name]
        if got is None:      # frozen (stem, layer1) or unused (FPN out1-3)
            assert not np.any(want), name
            continue
        assert rel(got.numpy(), want) <= 1e-4, name
    assert all(pt_grads[n] is None for n in jx_grads
               if n.startswith(("backbone.stem_", "backbone.layer1_")))
    assert pt_grads["fpn.lateral0.weight"] is not None   # C2 lateral trains


def test_parameters_and_statistics_match_jax_after_three_steps(steps):
    """Every parameter and BN running statistic within 1e-5 of JAX's,
    the named noise leaves within 3 lr."""
    state = steps["state"].model.state_dict()
    lr = steps["cfg"].optim.lr
    assert any("running_var" in name for name in steps["jx_final"])
    for name, want in steps["jx_final"].items():
        diff = np.abs(state[name].numpy() - want).max()
        assert diff <= (3 * lr if name in NOISE_LEAVES else 1e-5), name
    # stem and layer1 did not move; the neck's running statistics did
    initial = steps["initial"]
    for name, value in state.items():
        if name.startswith(("backbone.stem_", "backbone.layer1_")):
            assert torch.equal(value, initial[name]), name
    assert not torch.equal(state["neck3d.out0.norm.running_var"],
                           initial["neck3d.out0.norm.running_var"])


def test_checkpoint_round_trip(steps, tmp_path):
    """Save after three steps, restore into a fresh state: the same
    weights, optimizer moments, schedule and step, so the next step is
    the same step."""
    state = steps["state"]
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state)
    fresh = create_train_state(cfg_port(), device="cpu", sweep_chunk=2,
                               steps_per_epoch=1,
                               generator=torch.Generator().manual_seed(7))
    load_checkpoint(path, fresh)
    assert fresh.step == state.step == STEPS
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert fresh.scheduler.last_epoch == STEPS
    tb = {k: torch.from_numpy(v) for k, v in steps["scene"].items()}
    a = train_step(copy.deepcopy(state), tb)
    b = make_train_step(fresh)(steps["scene"])       # host arrays, staged
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_fit_stages_batches_and_logs(steps):
    state = copy.deepcopy(steps["state"])
    logged = []
    scenes = (steps["scene"] for _ in range(2))
    fit(state, scenes, num_steps=2, log_every=1,
        log_fn=lambda i, m: logged.append((i, m)))
    assert [i for i, _ in logged] == [0, 1] and state.step == STEPS + 2
    assert all(isinstance(v, float) and np.isfinite(v)
               for _, m in logged for v in m.values())


def test_train_state_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = train_config(port_config.tiny_test_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(cfg)
    state = create_train_state(cfg, device="cpu")
    assert state.model.training
    frozen = [n for n, p in state.model.named_parameters()
              if not p.requires_grad]
    assert frozen and all(n.startswith(("backbone.stem_", "backbone.layer1_"))
                          for n in frozen)


def test_loss_with_depth_supervision_matches_jax():
    """One train-mode loss with `depth_supervision` on: every term, the
    depth L1 included, within 1e-5 of JAX's."""
    cfg = train_config(tiny_test_config())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, depth_supervision=True))
    scene = make_synthetic_scene(cfg, seed=1, n_views=3, n_targets=1)
    batch = {k: jnp.asarray(v) for k, v in scene.items()}
    jx_model = JxMVSDet(cfg.model, sweep_method="gather", sweep_chunk=3)
    tree = random_variables(jx_model, batch, method=JxMVSDet.loss, seed=1)
    (_, want), _ = jax.jit(lambda t, b: jx_model.apply(
        t, b, method=JxMVSDet.loss, mutable=["batch_stats"]))(tree, batch)
    pcfg = cfg_port()
    pcfg = dataclasses.replace(pcfg, model=dataclasses.replace(
        pcfg.model, depth_supervision=True))
    state = create_train_state(pcfg, device="cpu", sweep_chunk=3)
    load_flax_variables(state.model, tree)
    _, got = state.model.loss({k: torch.from_numpy(v)
                               for k, v in scene.items()})
    assert "loss_depth" in got and set(got) == set(want)
    for key, value in want.items():
        assert abs(got[key].item() - float(value)) <= 1e-5 * abs(
            float(value)), key


def test_batch_norm_cost_regulariser_refuses_training():
    cfg = train_config(port_config.tiny_test_config())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, cost_reg_norm="batch"))
    state = create_train_state(cfg, device="cpu", sweep_chunk=2)
    scene = make_synthetic_scene(cfg, seed=0, n_views=3, n_targets=1)
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        state.model.loss({k: torch.from_numpy(v) for k, v in scene.items()})


def drift(metrics, final, ref_metrics, ref_final) -> dict:
    """How far one run's losses and variables are from a reference run's:
    the largest relative loss gap per step, the elements past 1e-5 in all
    and by leaf, and the largest difference."""
    diffs = {k: np.abs(final[k] - v) for k, v in ref_final.items()}
    return {
        "loss_rel_per_step": [
            max(abs(t[k] - j[k]) / max(abs(j[k]), 1e-30) for k in j)
            for t, j in zip(metrics, ref_metrics)],
        "elements": int(sum(d.size for d in diffs.values())),
        "elements_over_1e-5": int(sum((d > 1e-5).sum()
                                      for d in diffs.values())),
        "leaves_over_1e-5": {k: int((d > 1e-5).sum())
                             for k, d in diffs.items() if d.max() > 1e-5},
        "max_abs_diff": float(max(d.max() for d in diffs.values()))}


if __name__ == "__main__":
    # How far the port and JAX drift apart over the three steps at each
    # learning rate given (default: the test's, and the config's 2e-4),
    # and, as a witness that the drift is rounding that Adam amplifies,
    # how far JAX drifts from itself when only the sweep chunk (so the
    # order of the convolutions' batch sums) changes from 2 to 4 views:
    #   python tests/test_torch_port_training.py [lr ...]
    import json
    import sys

    for lr in [float(a) for a in sys.argv[1:]] or [LR, 2e-4]:
        r = compare_steps(lr)
        model = {k: v.numpy() for k, v in r["state"].model.state_dict()
                 .items()}
        grads = [rel(r["pt_grads"][k].numpy(), v)
                 for k, v in r["jx_grads"].items()
                 if r["pt_grads"][k] is not None]
        print(json.dumps({
            "lr": lr, "step1_grad_max_rel": float(max(grads)),
            "port_vs_jax": drift(r["pt_metrics"], model, r["jx_metrics"],
                                 r["jx_final"]),
            "jax_chunk4_vs_jax_chunk2": drift(
                *jax_steps(r["cfg"], r["batch"], r["tree"], sweep_chunk=4),
                r["jx_metrics"], r["jx_final"])}))
