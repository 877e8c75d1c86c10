"""The port's networks against the JAX modules, weights carried across by
the bridge: ResNet-50 + FPN (1e-4), CostRegNet with its softmax, sigmoid
and top-k (1e-5, equal indices), the 3D neck and the detection head."""

import numpy as np
import pytest

import jax
import torch

from mvsdet_tpu.config import HeadConfig
from mvsdet_tpu.models.cost_reg import CostRegNet as JxCostRegNet
from mvsdet_tpu.models.fpn import FPN as JxFPN
from mvsdet_tpu.models.head import DetectionHead as JxDetectionHead
from mvsdet_tpu.models.neck3d import IndoorImVoxelNeck as JxNeck
from mvsdet_tpu.models.resnet import ResNet50 as JxResNet50

from mvsdet_torch import config as port_config
from mvsdet_torch.interop import load_flax_variables
from mvsdet_torch.models.cost_reg import CostRegNet
from mvsdet_torch.models.fpn import FPN
from mvsdet_torch.models.head import DetectionHead
from mvsdet_torch.models.neck3d import IndoorImVoxelNeck
from mvsdet_torch.models.resnet import ResNet50

from test_torch_port_interop import random_variables


def cl(t):
    """Channels-first torch tensor -> channels-last numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def cf(x):
    """Channels-last numpy -> channels-first torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def test_image_features_match_jax():
    images = np.random.RandomState(0).randn(2, 32, 48, 3).astype(np.float32)
    jx_resnet, jx_fpn = JxResNet50(), JxFPN(out_channels=32)
    tree_r = random_variables(jx_resnet, images, seed=1)
    feats_j = jax.jit(jx_resnet.apply)(tree_r, images)
    tree_f = random_variables(jx_fpn, feats_j, seed=2)
    want = jax.jit(jx_fpn.apply)(tree_f, feats_j)

    resnet, fpn = ResNet50(), FPN(out_channels=32)
    load_flax_variables(resnet, tree_r)
    load_flax_variables(fpn, tree_f)
    with torch.no_grad():
        feats_t = resnet(cf(images))
        got = fpn(feats_t)
    for g, w in zip(feats_t, feats_j):
        np.testing.assert_allclose(cl(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want):                       # level 0 is the feature
        np.testing.assert_allclose(cl(g), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_cost_reg_probabilities_and_top_k_match_jax():
    vol = np.random.RandomState(3).rand(2, 4, 8, 12, 16).astype(np.float32)
    jx = JxCostRegNet(in_channels=16, norm="group")
    tree = random_variables(jx, vol, False, seed=4)
    out_j = np.asarray(jax.jit(lambda t, x: jx.apply(t, x, False))(tree, vol))
    prob_j = np.asarray(jax.nn.softmax(out_j[..., 0], axis=1))
    off_j = np.asarray(jax.nn.sigmoid(out_j[..., 1]))

    net = CostRegNet(in_channels=16, norm="group")
    load_flax_variables(net, tree)
    with torch.no_grad():
        out_t = net(cf(vol))
    prob_t = torch.softmax(out_t[:, 0], dim=1)
    off_t = torch.sigmoid(out_t[:, 1])
    np.testing.assert_allclose(prob_t.numpy(), prob_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(off_t.numpy(), off_j, rtol=1e-5, atol=1e-5)
    top_j = jax.lax.top_k(np.moveaxis(prob_j, 1, -1), 2)[1]
    top_t = torch.topk(prob_t.permute(0, 2, 3, 1), 2, dim=-1).indices
    np.testing.assert_array_equal(top_t.numpy(), np.asarray(top_j))


@pytest.fixture(scope="module")
def neck_pair():
    vol = np.random.RandomState(5).randn(1, 8, 8, 4, 16).astype(np.float32)
    jx = JxNeck(in_channels=16, out_channels=8)
    tree = random_variables(jx, vol, False, seed=6)
    want = jax.jit(lambda t, x: jx.apply(t, x, False))(tree, vol)
    neck = IndoorImVoxelNeck(in_channels=16, out_channels=8)
    load_flax_variables(neck, tree)
    with torch.no_grad():
        got = neck.eval()(cf(vol))
    return want, got


def test_neck_matches_jax(neck_pair):
    want, got = neck_pair
    assert [g.shape[2:] for g in got] == [(8, 8, 4), (4, 4, 2), (2, 2, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(cl(g), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_head_matches_jax(neck_pair):
    levels_j, levels_t = neck_pair
    cfg = HeadConfig(n_classes=5)
    jx = JxDetectionHead(cfg)
    levels_j = [np.asarray(l[0]) for l in levels_j]
    tree = random_variables(jx, levels_j, seed=7)
    want = jax.jit(jx.apply)(tree, levels_j)
    head = DetectionHead(port_config.HeadConfig(n_classes=5), in_channels=8)
    load_flax_variables(head, tree)
    with torch.no_grad():
        got = head(levels_t)
    for lvl_t, lvl_j in zip(got, want):
        for g, w in zip(lvl_t, lvl_j):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
