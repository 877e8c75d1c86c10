"""The port's weight bridge, its entry points and its independence of JAX.

`random_variables` (used by the other port tests too) gives a JAX
variable tree with every leaf drawn from a numpy seed, shapes from
`jax.eval_shape` of the module's init (no compile).
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.config import tiny_test_config
from mvsdet_tpu.data.synthetic import make_synthetic_scene
from mvsdet_tpu.models import layers as jx_layers
from mvsdet_tpu.models.mvsdet import MVSDet as JxMVSDet
from mvsdet_tpu.models.nerfdet import NerfDetLegacy as JxNerfDetLegacy

from mvsdet_torch import config as port_config
from mvsdet_torch.evaluation.harness import make_predict_fn
from mvsdet_torch.interop import flax_to_state_dict, load_flax_variables
from mvsdet_torch.models import layers
from mvsdet_torch.models.mvsdet import MVSDet, build_model
from mvsdet_torch.models.nerfdet import NerfDetLegacy

REPO = Path(__file__).resolve().parents[1]
# the real-format data path, the metrics and the launchers: imported by the
# walk below like every other module, named here so that none is skipped
M13_MODULES = (
    "mvsdet_torch.data.infos", "mvsdet_torch.data.native_loader",
    "mvsdet_torch.data.pipeline", "mvsdet_torch.evaluation.indoor_eval",
    "mvsdet_torch.evaluation.nvs_metrics", "mvsdet_torch.evaluation.harness",
    "mvsdet_torch.tools.train", "mvsdet_torch.tools.test")
# the data x view parallelism, named for the same reason
M15_MODULES = (
    "mvsdet_torch.parallel.mesh", "mvsdet_torch.parallel.collectives",
    "mvsdet_torch.parallel.sharding", "mvsdet_torch.parallel.multihost")
# the legacy NeRF-Det, named for the same reason
M16_MODULES = (
    "mvsdet_torch.models.nerfdet", "mvsdet_torch.models.nerf_mlp",
    "mvsdet_torch.ops.ray_render", "mvsdet_torch.training.loop")
# the learning check, named for the same reason
M18_MODULES = ("mvsdet_torch.tools.overfit_map", "mvsdet_torch.models.flax_init")
# the diagnostics and the last modules, named for the same reason
M17_MODULES = (
    "mvsdet_torch.utils.imageio", "mvsdet_torch.utils.box_vis",
    "mvsdet_torch.utils.ply_export", "mvsdet_torch.utils.profiling",
    "mvsdet_torch.ops.splat", "mvsdet_torch.ops.voxel_lift")
# the JAX package's default plane sweep, named for the same reason
SWEEP_MODULES = ("mvsdet_torch.ops.plane_sweep_mxu",)
NAMED_MODULES = (M13_MODULES + M15_MODULES + M16_MODULES + M18_MODULES
                 + M17_MODULES + SWEEP_MODULES)


def _leaf(path, shape, rng):
    collection, leaf = path[0], path[-1]
    if leaf == "kernel":                       # lecun-normal scale
        fan_in = int(np.prod(shape[:-1]))
        return rng.randn(*shape) / np.sqrt(fan_in)
    if leaf in ("var",):
        return rng.uniform(0.5, 1.5, shape)
    if leaf in ("scale", "scales"):
        return rng.uniform(0.8, 1.2, shape)
    if collection in ("params", "batch_stats", "frozen"):
        return rng.uniform(-0.1, 0.1, shape)   # bias, mean
    raise KeyError(path)


def random_variables(module, *args, seed=0, method=None):
    """A numpy variable tree for `module.init(key, *args, method=method)`."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                method=method))
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _leaf(tuple(k.key for k in p), s.shape, rng)
        .astype(np.float32), shapes)


def narrow(cfg):
    """A `tiny_test_config()` (of either package) with narrow FPN and neck
    widths."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, neck3d_out_channels=16,
        backbone=dataclasses.replace(cfg.model.backbone,
                                     fpn_out_channels=32)))


@pytest.fixture(scope="module")
def tiny_tree():
    cfg = narrow(tiny_test_config())
    batch = {k: jnp.asarray(v) for k, v in make_synthetic_scene(
        cfg, seed=0, n_views=3, n_targets=1).items()}
    jx_model = JxMVSDet(cfg.model, sweep_method="gather")
    return random_variables(jx_model, batch, method=JxMVSDet.predict)


class TestBridge:
    def test_maps_every_leaf_with_nothing_left_over(self, tiny_tree):
        model = MVSDet(narrow(port_config.tiny_test_config()).model,
                       sweep_method="gather")
        load_flax_variables(model, tiny_tree)
        arrays = flax_to_state_dict(tiny_tree)
        n_leaves = len(jax.tree_util.tree_leaves(tiny_tree))
        state = model.state_dict()
        port_keys = [k for k in state if not k.endswith("num_batches_tracked")]
        assert len(arrays) == n_leaves == len(port_keys)
        for key, value in arrays.items():
            np.testing.assert_array_equal(state[key].numpy(), value)

    def test_maps_every_nerfdet_leaf_with_nothing_left_over(self):
        """A `NerfDetLegacy` tree: the backbone, FPN, neck (with its
        BatchNorm statistics), head, `mapping` and the NeRF MLP."""
        cfg = narrow(tiny_test_config())
        batch = {k: jnp.asarray(v) for k, v in make_synthetic_scene(
            cfg, seed=0, n_views=3, n_targets=2).items()}
        tree = random_variables(JxNerfDetLegacy(cfg.model, n_rand=8,
                                                n_samples=4),
                                batch, method=JxNerfDetLegacy.loss)
        model = NerfDetLegacy(narrow(port_config.tiny_test_config()).model)
        load_flax_variables(model, tree)
        arrays = flax_to_state_dict(tree)
        state = model.state_dict()
        port_keys = [k for k in state if not k.endswith("num_batches_tracked")]
        assert len(arrays) == len(jax.tree_util.tree_leaves(tree)) \
            == len(port_keys)
        for key, value in arrays.items():
            np.testing.assert_array_equal(state[key].numpy(), value)
        for name in ("mapping.weight", "nerf_mlp.base.hidden3.weight",
                     "nerf_mlp.sigma.bias", "nerf_mlp.bottleneck.weight",
                     "nerf_mlp.rgb.hidden0.weight", "nerf_mlp.rgb.output.bias",
                     "neck3d.out0.norm.running_var",
                     "backbone.stem_bn.running_mean", "head.scales"):
            assert name in arrays, name
        np.testing.assert_array_equal(
            arrays["nerf_mlp.rgb.output.weight"],
            tree["params"]["nerf_mlp"]["rgb"]["output"]["kernel"].T)

    def test_conversions(self, tiny_tree):
        arrays = flax_to_state_dict(tiny_tree)
        p, f = tiny_tree["params"], tiny_tree["frozen"]
        conv = p["backbone"]["stem_conv"]["kernel"]           # HWIO
        np.testing.assert_array_equal(arrays["backbone.stem_conv.weight"],
                                      conv.transpose(3, 2, 0, 1))
        dense = p["to_gaussians"]["proj"]["kernel"]
        np.testing.assert_array_equal(arrays["to_gaussians.proj.weight"],
                                      dense.T)
        deconv = p["cost_reg"]["conv9"]["ConvTranspose_0"]["kernel"]
        np.testing.assert_array_equal(
            arrays["cost_reg.conv9.conv.weight"],
            deconv[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))
        np.testing.assert_array_equal(
            arrays["backbone.stem_bn.running_var"], f["backbone"]["stem_bn"]["var"])
        np.testing.assert_array_equal(
            arrays["neck3d.out0.norm.running_mean"],
            tiny_tree["batch_stats"]["neck3d"]["out0"]["BatchNorm_0"]["mean"])
        np.testing.assert_array_equal(
            arrays["cost_reg.conv0.norm.weight"],
            p["cost_reg"]["conv0"]["GroupNorm_0"]["scale"])

    @pytest.mark.parametrize("change", ["drop", "extra", "reshape"])
    def test_rejects_a_tree_that_does_not_fit(self, tiny_tree, change):
        tree = jax.tree_util.tree_map(lambda x: x, tiny_tree)   # a copy
        head = dict(tree["params"]["head"])
        if change == "drop":
            del head["scales"]
        elif change == "extra":
            head["extra"] = {"kernel": np.zeros((3, 3, 3, 4, 4), np.float32)}
        else:
            head["scales"] = np.ones(4, np.float32)
        tree["params"] = dict(tree["params"], head=head)
        model = MVSDet(narrow(port_config.tiny_test_config()).model,
                       sweep_method="gather")
        with pytest.raises((KeyError, ValueError)):
            load_flax_variables(model, tree)


class TestLayers:
    """ConvTranspose flip (ROADMAP trap T7) and GroupNorm groups (T8)."""

    @pytest.mark.parametrize("kernel", [3, 2])
    def test_deconv_matches_flax(self, kernel):
        rng = np.random.RandomState(kernel)
        x = rng.randn(2, 3, 4, 5, 6).astype(np.float32)       # NDHWC
        jx = jx_layers.DeconvBnReLU(6, kernel=kernel, norm="group")
        tree = random_variables(jx, x, False)
        want = np.asarray(jx.apply(tree, x, False))
        mod = layers.DeconvBnReLU(6, 6, kernel=kernel, norm="group")
        load_flax_variables(mod, tree)
        got = mod(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                                   want, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("channels,stride", [(12, 1), (6, 2), (9, 1)])
    def test_group_norm_conv_matches_flax(self, channels, stride):
        rng = np.random.RandomState(channels)
        x = rng.randn(2, 5, 6, 7, 4).astype(np.float32)
        jx = jx_layers.ConvBnReLU(channels, strides=stride, dims=3,
                                  norm="group")
        tree = random_variables(jx, x, False)
        want = np.asarray(jx.apply(tree, x, False))
        mod = layers.ConvBnReLU(4, channels, stride=stride, norm="group")
        assert mod.norm.num_groups == channels // layers.group_size(channels)
        load_flax_variables(mod, tree)
        got = mod(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                                   want, atol=1e-5, rtol=1e-5)

    def test_frozen_batch_norm_matches_flax(self):
        rng = np.random.RandomState(5)
        x = rng.randn(2, 4, 5, 8).astype(np.float32)
        jx = jx_layers.FrozenBatchNorm(8)
        tree = random_variables(jx, x)
        want = np.asarray(jx.apply(tree, x))
        mod = layers.FrozenBatchNorm(8)
        load_flax_variables(mod, tree)
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-6, rtol=1e-6)


class TestEntryPoints:
    def test_build_model_needs_cuda_unless_cpu_is_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = narrow(port_config.tiny_test_config())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
        model = build_model(cfg, device="cpu")
        assert not model.training
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_predict_fn(model)

    def test_build_model_weights_follow_the_generator(self):
        cfg = narrow(port_config.tiny_test_config())
        a = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
        b = build_model(cfg, "cpu", torch.Generator().manual_seed(1))
        c = build_model(cfg, "cpu", torch.Generator().manual_seed(2))
        wa, wb, wc = (m.neck3d.out0.conv.weight for m in (a, b, c))
        assert torch.equal(wa, wb) and not torch.equal(wa, wc)
        assert torch.all(a.head.conv_cls.bias == -4.595)

    def test_port_imports_neither_jax_nor_the_jax_package(self):
        code = (
            "import pkgutil, sys, importlib, mvsdet_torch\n"
            "for m in pkgutil.walk_packages(mvsdet_torch.__path__, "
            "'mvsdet_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mvsdet_tpu')]\n"
            "assert not bad, bad\n"
            f"missing = [m for m in {NAMED_MODULES!r} "
            "if m not in sys.modules]\n"
            "assert not missing, missing\n")
        env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
               "JAX_PLATFORMS": "cpu"}
        result = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                                env=env, capture_output=True, text=True,
                                timeout=120)
        assert result.returncode == 0, result.stderr

    def test_no_source_line_imports_jax(self):
        """Also imports inside functions, which importing does not run."""
        pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|"
                             r"mvsdet_tpu)\b")
        sources = sorted((REPO / "mvsdet_torch").rglob("*.py")) \
            + [REPO / "chip_smoke.py"]
        bad = [f"{path.relative_to(REPO)}:{i}"
               for path in sources
               for i, line in enumerate(path.read_text().splitlines(), 1)
               if pattern.match(line)]
        assert len(sources) > 20 and not bad, bad
        scanned = {str(p.relative_to(REPO).with_suffix("")).replace("/", ".")
                   for p in sources}
        assert set(NAMED_MODULES) <= scanned
