"""The port's ARKit pieces against the JAX package's, function by function.

Per-view intrinsics (`depth_scale_map`, `scale_intrinsics`,
`full_projection` on (N, 4, 4) Ks), the yaw-box geometry and targets of
the head (`rotate_z`, `decode_bbox_rotated`, `box7_corners`,
`assign_targets_rotated`), the rotated IoUs (exact, sampled, and the soft
one the loss trains through, with its gradients), the rotated NMS, the yaw
head's convolutions in float32 and bf16, and `head_loss_rotated` in both
box-loss modes with its gradients.  Inputs come from numpy seeds; the
tolerance stands beside each comparison.

`cos` and `sin` of XLA and torch may differ in the last bit (ROADMAP
T19), so values that pass through them are held to a few ulps, never bit
for bit; labels, targets, masks and kept indices decided from them are
equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import HeadConfig as JxHeadConfig
from mvsdet_tpu.geometry import cameras as jx_cameras
from mvsdet_tpu.geometry import rays as jx_rays
from mvsdet_tpu.models import head as jx_head
from mvsdet_tpu.ops import nms as jx_nms

from mvsdet_torch import config as port_config
from mvsdet_torch.geometry import cameras, rays
from mvsdet_torch.interop import load_flax_variables
from mvsdet_torch.models import head
from mvsdet_torch.ops import nms

from test_torch_port_interop import random_variables

T = torch.from_numpy


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def yaw_head_config(**kw):
    """The tiny test head with the ARKit yaw channel, in either package."""
    cfg = port_config.tiny_test_config().model.head
    return dataclasses.replace(cfg, n_reg_outs=7, with_yaw=True, **kw)


def jx_yaw_head_config(**kw):
    return JxHeadConfig(**dataclasses.asdict(yaw_head_config(**kw)))


def random_boxes7(rng, m, spread=1.0):
    """(m, 7) yaw boxes: centres within +-spread, sizes 0.2-1.0, yaw in
    (-pi, pi)."""
    return np.concatenate([
        rng.uniform(-spread, spread, (m, 3)), rng.uniform(0.2, 1.0, (m, 3)),
        rng.uniform(-np.pi, np.pi, (m, 1))], 1).astype(np.float32)


# -- per-view intrinsics ----------------------------------------------------

def per_view_ks(n, seed=0):
    """(n, 4, 4) Ks at a 32x48 image, focal and centre jittered per view."""
    rng = np.random.RandomState(seed)
    k = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    k[:, 0, 0] = 43.2 * (1 + 0.05 * rng.randn(n))
    k[:, 1, 1] = 43.2 * (1 + 0.05 * rng.randn(n))
    k[:, 0, 2] = 24 + rng.uniform(-2, 2, n)
    k[:, 1, 2] = 16 + rng.uniform(-2, 2, n)
    return k


@pytest.mark.parametrize("size", [3, 4])
def test_per_view_depth_scale_map_matches_jax(size):
    """(N, 3|4, 3|4) Ks give (N, H*W, 1), each view's own map: 1e-7."""
    k = per_view_ks(5)[:, :size, :size]
    want = np.asarray(jx_rays.depth_scale_map(8, 12, jnp.asarray(k)))
    got = rays.depth_scale_map(8, 12, T(k)).numpy()
    assert got.shape == want.shape == (5, 96, 1)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    # view 2's map is the single-K map of its own K
    np.testing.assert_allclose(got[2], rays.depth_scale_map(
        8, 12, T(k[2])).numpy(), rtol=1e-7, atol=1e-7)


def test_per_view_intrinsics_scale_and_project_as_jax():
    rng = np.random.RandomState(1)
    k = per_view_ks(4, seed=1)
    w2c = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    w2c[:, :3, :3] = np.linalg.qr(rng.randn(4, 3, 3))[0]
    w2c[:, :3, 3] = rng.randn(4, 3)
    kf_j = jx_cameras.scale_intrinsics(jnp.asarray(k), 4.0)
    kf_t = cameras.scale_intrinsics(T(k), 4.0)
    np.testing.assert_allclose(kf_t.numpy(), np.asarray(kf_j), rtol=1e-7)
    proj_j = jx_cameras.full_projection(jnp.asarray(w2c), kf_j)
    proj_t = cameras.full_projection(T(w2c), kf_t)
    assert proj_t.shape == (4, 4, 4)
    np.testing.assert_allclose(proj_t.numpy(), np.asarray(proj_j),
                               rtol=1e-6, atol=1e-6)


# -- yaw-box geometry and targets -------------------------------------------

def test_yaw_box_geometry_matches_jax():
    """rotate_z, decode_bbox_rotated and box7_corners on random inputs:
    1e-6 relative."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    ang = rng.uniform(-4, 4, 200).astype(np.float32)
    pred = np.concatenate([rng.uniform(0.05, 0.8, (200, 6)),
                           rng.uniform(-4, 4, (200, 1))], 1) \
        .astype(np.float32)
    boxes = random_boxes7(rng, 50)
    for got, want in (
            (head.rotate_z(T(pts), T(ang)), jx_head.rotate_z(pts, ang)),
            (head.decode_bbox_rotated(T(pts), T(pred)),
             jx_head.decode_bbox_rotated(pts, pred)),
            (head.box7_corners(T(boxes)), jx_head.box7_corners(boxes))):
        assert got.shape == np.shape(want)
        assert rel(got.numpy(), want) <= 1e-6


def head_inputs(seed=0, cfg=None):
    """Three levels of random points, yaw-head outputs (six positive
    distances and a yaw) and validity; five yaw boxes (two of equal size,
    so the smallest-box rule meets a tie) and three padded ones."""
    rng = np.random.RandomState(seed)
    cfg = cfg or yaw_head_config()
    sizes = (400, 150, 60)
    points = [rng.uniform(-1, 1, (n, 3)).astype(np.float32) for n in sizes]
    valids = [rng.rand(n) > 0.2 for n in sizes]
    outs = [(rng.randn(n, 1).astype(np.float32),
             np.concatenate([0.3 * np.exp(0.3 * rng.randn(n, 6)),
                             rng.uniform(-3, 3, (n, 1))], 1)
             .astype(np.float32),
             (rng.randn(n, cfg.n_classes) - 2).astype(np.float32))
            for n in sizes]
    boxes = np.zeros((cfg.max_boxes, 7), np.float32)
    boxes[:5] = random_boxes7(rng, 5, spread=0.6)
    boxes[:5, 3:6] += 0.3
    boxes[1] = boxes[0] + [0.05, 0, 0, 0, 0, 0, 0.4]
    labels = rng.randint(0, cfg.n_classes, cfg.max_boxes).astype(np.int32)
    labels[:2] = 0, 1
    mask = np.arange(cfg.max_boxes) < 5
    return cfg, outs, points, valids, boxes, labels, mask


def test_assign_targets_rotated_matches_jax():
    """Labels and box targets equal, centerness to 1e-6; the volume tie
    between boxes 0 and 1 decides some points (swapping them changes the
    labels)."""
    cfg, _, points, _, boxes, labels, mask = head_inputs()
    pts = np.concatenate(points)
    scales = np.concatenate([np.full(len(p), i, np.int32)
                             for i, p in enumerate(points)])
    jcfg = jx_yaw_head_config()
    want = [np.asarray(a) for a in jx_head.assign_targets_rotated(
        pts, scales, boxes, labels, mask, jcfg)]
    got = head.assign_targets_rotated(
        T(pts), T(scales.astype(np.int64)), T(boxes), T(labels), T(mask), cfg)
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=1e-6, atol=1e-7)
    labels_t = want[2]
    assert (labels_t >= 0).sum() > 10
    assert len(np.unique(labels_t[labels_t >= 0])) >= 2
    order = [1, 0] + list(range(2, len(boxes)))
    swapped = jx_head.assign_targets_rotated(pts, scales, boxes[order],
                                             labels[order], mask[order], jcfg)
    assert np.any(np.asarray(swapped[2]) != want[2])


# -- rotated IoUs -------------------------------------------------------------

def iou_case(kind):
    """(boxes1, boxes2) for the IoU comparisons: random boxes, or a
    hand-made pair (identical, a 90 degree turn of a 2x1 box, disjoint, a
    shared edge, a shared corner) beside a random one."""
    rng = np.random.RandomState(3)
    if kind == "random":
        return random_boxes7(rng, 40), random_boxes7(rng, 30)
    a = np.array([0.1, -0.2, 0.3, 2.0, 1.0, 0.8, 0.4], np.float32)
    b = {"identical": a.copy(),
         "quarter_turn": a + [0, 0, 0, 0, 0, 0, np.pi / 2],
         "disjoint": a + [5.0, 0, 0, 0, 0, 0, 0.3],
         "shared_edge": np.array([2.0, 0, 0, 2.0, 1.0, 0.8, 0.0], np.float32),
         "point_contact": np.array([2.0, 1.0, 0, 2.0, 1.0, 0.8, 0.0],
                                   np.float32)}[kind]
    if kind in ("shared_edge", "point_contact"):
        a = np.array([0.0, 0.0, 0.0, 2.0, 1.0, 0.8, 0.0], np.float32)
    other = random_boxes7(rng, 1)[0]
    return (np.stack([a, other]).astype(np.float32),
            np.stack([b, other]).astype(np.float32))


@pytest.mark.parametrize("kind", ["random", "identical", "quarter_turn",
                                  "disjoint", "shared_edge", "point_contact"])
def test_rotated_ious_match_jax(kind):
    """The exact (polygon clip) and the sampled rotated IoU: 1e-6
    absolute."""
    b1, b2 = iou_case(kind)
    exact = np.asarray(jx_nms.rotated_iou_bev_exact(b1, b2))
    np.testing.assert_allclose(nms.rotated_iou_bev_exact(T(b1), T(b2)).numpy(),
                               exact, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        nms.rotated_iou_bev_sampled(T(b1), T(b2)).numpy(),
        np.asarray(jx_nms.rotated_iou_bev_sampled(b1, b2)), rtol=0, atol=1e-6)
    if kind == "random":
        assert 0.05 < (exact > 0).mean() < 0.95
    else:
        want = {"identical": 1.0, "quarter_turn": 1 / 3, "disjoint": 0.0,
                "shared_edge": 0.0, "point_contact": 0.0}[kind]
        assert abs(exact[0, 0] - want) <= 1e-6


def test_rotated_iou_exact_chunks_the_pair_grid(monkeypatch):
    """Chunked by rows (here 7 pairs a chunk over 9 columns, so a chunk is
    one row) the IoUs are the unchunked ones, bit for bit."""
    rng = np.random.RandomState(4)
    b1, b2 = T(random_boxes7(rng, 11)), T(random_boxes7(rng, 9))
    whole = nms.rotated_iou_bev_exact(b1, b2)
    monkeypatch.setattr(nms, "_PAIRS_PER_CHUNK", 7)
    assert torch.equal(nms.rotated_iou_bev_exact(b1, b2), whole)


def soft_pairs(seed=5):
    """Matched (pred, target) pairs: random ones near each other, an
    identical pair (the z overlap's minimum and maximum tie) and a pred of
    zero width (IoU exactly 0, at the clip's lower bound)."""
    rng = np.random.RandomState(seed)
    target = random_boxes7(rng, 30, spread=0.5)
    pred = target + np.concatenate([
        rng.uniform(-0.3, 0.3, (30, 3)), rng.uniform(-0.15, 0.15, (30, 3)),
        rng.uniform(-0.8, 0.8, (30, 1))], 1).astype(np.float32)
    pred[0] = target[0]
    pred[1, 3] = 0.0
    return pred, target


def test_soft_rotated_iou_and_its_gradients_match_jax():
    """Values and the gradient of their sum with respect to both boxes:
    1e-5 relative; the clip's bound and the z overlap's ties take half the
    gradient, as in JAX (`torch.clamp` would pass all of it)."""
    pred, target = soft_pairs()
    w = np.random.RandomState(6).rand(30).astype(np.float32)
    want, (gp_want, gt_want) = jax.value_and_grad(
        lambda p, t: jnp.sum(jx_nms.rotated_iou_3d_soft_pairs(p, t) * w),
        argnums=(0, 1))(pred, target)
    p, t = T(pred).requires_grad_(True), T(target).requires_grad_(True)
    iou = nms.rotated_iou_3d_soft_pairs(p, t)
    np.testing.assert_allclose(
        iou.detach().numpy(),
        np.asarray(jx_nms.rotated_iou_3d_soft_pairs(pred, target)),
        rtol=1e-5, atol=1e-7)
    assert iou[1].item() == 0.0 and iou[0].item() > 0.5
    (iou * T(w)).sum().backward()
    assert abs((iou * T(w)).sum().item() - float(want)) <= 1e-5 * abs(
        float(want))
    assert rel(p.grad.numpy(), gp_want) <= 1e-5
    assert rel(t.grad.numpy(), gt_want) <= 1e-5
    assert np.abs(np.asarray(gp_want)[1, 3]) > 0      # the clip's bound


@pytest.mark.parametrize("seed", [0, 1])
def test_rotated_nms_matches_jax(seed):
    """Kept indices and mask equal, with some boxes suppressed."""
    rng = np.random.RandomState(seed)
    m = 80
    boxes = random_boxes7(rng, m, spread=0.8)
    scores = rng.rand(m).astype(np.float32)
    classes = rng.randint(0, 3, m).astype(np.int32)
    valid = rng.rand(m) > 0.2
    idx_j, mask_j = jx_nms.rotated_3d_nms(boxes, scores, classes, 0.25, valid,
                                          m)
    idx_t, mask_t = nms.rotated_3d_nms(T(boxes), T(scores), T(classes), 0.25,
                                       T(valid), m)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert 0 < mask_t.sum() < valid.sum()


# -- the yaw head -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yaw_head_matches_jax(dtype):
    """The conv towers with the yaw channel left linear, on bf16-valued
    levels.  float32: every output to 1e-5.  bf16 (JAX compiled with
    excess precision off): center and cls, in bf16, to 2.5e-4 (0.0
    measured); bbox, in float32 (the float32 scale promotes the distances'
    product, and the concatenation the yaw channel), to 1e-5 (4e-8
    measured); each beside its witness, JAX bf16 against JAX float32
    (9e-4 to 3.2e-3), at least four times the tolerance."""
    rng = np.random.RandomState(2)
    levels = [jnp.asarray(rng.randn(1, 8 >> i, 8 >> i, 4 >> i, 16))
              .astype(jnp.bfloat16).astype(jnp.float32) for i in range(3)]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jcfg = jx_yaw_head_config()
    tree = random_variables(jx_head.DetectionHead(jcfg), levels)
    want = jax.jit(jx_head.DetectionHead(jcfg, dtype=jdt).apply,
                   compiler_options={"xla_allow_excess_precision": False})(
        tree, [x.astype(jdt) for x in levels])
    want32 = jax.jit(jx_head.DetectionHead(jcfg).apply)(tree, levels)
    mod = head.DetectionHead(yaw_head_config(), in_channels=16, dtype=tdt)
    load_flax_variables(mod, tree)
    with torch.no_grad():
        got = mod([T(np.array(x)).permute(0, 4, 1, 2, 3).to(tdt)
                   for x in levels])
    for lvl_t, lvl_j, lvl_32 in zip(got, want, want32):
        assert [o.dtype for o in lvl_t] == [tdt, torch.float32, tdt]
        assert lvl_t[1].shape[1] == 7
        for name, t, j, j32 in zip(("center", "bbox", "cls"), lvl_t, lvl_j,
                                   lvl_32):
            j = np.asarray(jnp.asarray(j).astype(jnp.float32))
            tol = 1e-5 if dtype == "float32" or name == "bbox" else 2.5e-4
            assert rel(t.to(torch.float32).numpy(), j) <= tol, name
            if dtype == "bfloat16":
                assert rel(np.asarray(j32), j) >= 4 * tol, name
    # the yaw channel is linear: negative values pass, the distances are
    # positive
    reg = got[0][1]
    assert (reg[:, 6] < 0).any() and (reg[:, :6] > 0).all()


@pytest.mark.parametrize("mode", ["rotated_iou", "decoupled"])
def test_head_loss_rotated_matches_jax(mode):
    """Loss terms to 1e-5 and the gradients of their sum with respect to
    every head output to 1e-4 relative, in both box-loss modes."""
    cfg, outs, points, valids, boxes, labels, mask = head_inputs(
        cfg=yaw_head_config(rotated_bbox_loss=mode))
    jcfg = jx_yaw_head_config(rotated_bbox_loss=mode)

    def jx_terms(outs):
        losses, aux = jx_head.head_loss_rotated(outs, points, valids, boxes,
                                                labels, mask, jcfg)
        return sum(losses.values()), (losses, aux)

    (_, (want, aux)), want_grads = jax.value_and_grad(
        jx_terms, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, outs))
    t_outs = [tuple(T(a).requires_grad_(True) for a in lvl) for lvl in outs]
    got, got_aux = head.head_loss_rotated(
        t_outs, [T(p) for p in points], [T(v) for v in valids],
        T(boxes), T(labels), T(mask), cfg)
    assert float(got_aux["n_pos"]) == float(aux["n_pos"]) > 0
    for key, value in want.items():
        assert abs(got[key].item() - float(value)) <= 1e-5 * abs(
            float(value)), key
    sum(got.values()).backward()
    for lvl_t, lvl_w in zip(t_outs, want_grads):
        for t, w in zip(lvl_t, lvl_w):
            assert rel(t.grad.numpy(), w) <= 1e-4


def test_head_loss_rotated_refuses_an_unknown_box_loss():
    cfg, outs, points, valids, boxes, labels, mask = head_inputs(
        cfg=yaw_head_config(rotated_bbox_loss="corners"))
    with pytest.raises(ValueError, match="corners"):
        head.head_loss_rotated(
            [tuple(T(a) for a in lvl) for lvl in outs], [T(p) for p in points],
            [T(v) for v in valids], T(boxes), T(labels), T(mask), cfg)
