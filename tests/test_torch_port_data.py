"""The port's real-format data path against the JAX package's.

The ScanNet and ARKit fixtures (`tests/fixtures/`) are written into a
temporary directory, with a 16-bit depth PNG beside every ScanNet frame,
and converted with `tools/prepare_infos.py` in a subprocess.  Then:
`load_infos` field by field; the native image library's decoded and
resized bytes (JPEG, depth PNG, the threaded batch) against the JAX
package's library built from its own source; the three view samplers;
and whole `ScenePipeline` batches, training and eval, from the same
`RandomState` seed with the same decoder on both sides, all bit-equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from fixtures.arkit_fixture import make_raw_arkit_fixture
from fixtures.scannet_fixture import make_raw_fixture

from mvsdet_tpu import config as jx_config
from mvsdet_tpu.data import infos as jx_infos
from mvsdet_tpu.data import native_loader as jx_native
from mvsdet_tpu.data import pipeline as jx_pipeline

from mvsdet_torch import config
from mvsdet_torch.data import infos, native_loader, pipeline

REPO = Path(__file__).resolve().parents[1]


def arkit_tiny(cfg_module):
    """`tiny_test_config()` with the ARKit head, classes and view counts."""
    base = cfg_module.tiny_test_config()
    arkit = cfg_module.arkit_config()
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, head=dataclasses.replace(
            base.model.head, n_classes=17, n_reg_outs=7, with_yaw=True)),
        data=dataclasses.replace(base.data, classes=arkit.data.classes,
                                 n_views_train=5, n_views_test=5))


def prepare(root, raw_pkl, *flags):
    out = os.path.join(root, "converted")
    res = subprocess.run(
        [sys.executable, str(REPO / "tools" / "prepare_infos.py"),
         "--input", raw_pkl, "--out-dir", out, *flags],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return os.path.join(out, os.path.basename(raw_pkl))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """{name: (root, converted pkl, port config, JAX config)}."""
    root = str(tmp_path_factory.mktemp("scannet"))
    raw = make_raw_fixture(root, n_scenes=2, n_frames=12)
    rng = np.random.RandomState(7)
    for dirpath, _, files in os.walk(os.path.join(root, "posed_images")):
        for name in files:
            depth_mm = rng.randint(300, 5000, (121, 162)).astype(np.uint16)
            cv2.imwrite(os.path.join(dirpath, name[:-4] + ".png"), depth_mm)
    out = {"scannet": (root, prepare(root, raw), config.tiny_test_config(),
                       jx_config.tiny_test_config())}
    root = str(tmp_path_factory.mktemp("arkit"))
    raw = make_raw_arkit_fixture(root, n_scenes=2, n_frames=10)
    out["arkit"] = (root, prepare(root, raw, "--dataset", "arkit",
                                  "--reverse-yaw"),
                    arkit_tiny(config), arkit_tiny(jx_config))
    return out


@pytest.fixture(scope="module")
def jx_lib(tmp_path_factory, datasets):
    """The JAX package's native library, built by its own loader from its
    own source, into a temporary file (so no other test sees a part)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jx_native, "_LIB",
               str(tmp_path_factory.mktemp("jxlib") / "libimage_ops.so"))
    mp.setattr(jx_native, "_CACHED", None)
    mp.setattr(jx_native, "_FAILED", False)
    lib = jx_native.load()
    assert lib is not None, "the JAX package's native library did not build"
    yield jx_native
    mp.undo()


def frames(datasets, name):
    root, pkl, cfg, _ = datasets[name]
    return [p for s in infos.load_infos(pkl, root, cfg.data.classes)
            for p in s.img_paths]


@pytest.mark.parametrize("name", ["scannet", "arkit"])
def test_load_infos_equals_jax(datasets, name):
    root, pkl, cfg, _ = datasets[name]
    got = infos.load_infos(pkl, root, cfg.data.classes)
    want = jx_infos.load_infos(pkl, root, cfg.data.classes)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in dataclasses.fields(w):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), field.name
            else:
                assert a == b, field.name
    if name == "arkit":
        assert got[0].intrinsic.shape == (10, 4, 4)
        assert got[0].gt_boxes.shape[1] == 7
        assert got[0].original_hw == (192, 256)


def test_native_library_builds_from_the_ports_source():
    lib = native_loader.load()
    path = native_loader.library_path()
    assert path.exists() and path.parent == REPO / "build" / "native"
    assert Path(lib._name) == path
    assert not list((REPO / "mvsdet_torch" / "data" / "_native").glob("*.so"))


@pytest.mark.parametrize("hw", [(32, 48), (240, 320), (121, 162)])
def test_decoded_bytes_equal_jax(datasets, jx_lib, hw):
    paths = frames(datasets, "scannet")[:6] + frames(datasets, "arkit")[:4]
    for p in paths:
        np.testing.assert_array_equal(native_loader.load_resize_rgb(p, hw),
                                      jx_lib.load_resize_rgb(p, hw))
    batch = native_loader.load_batch_rgb(paths, hw, n_threads=3)
    for p, img in zip(paths, batch):
        np.testing.assert_array_equal(img, native_loader.load_resize_rgb(p,
                                                                        hw))
    depth = paths[0][:-4] + ".png"
    got = native_loader.load_depth_png(depth, hw)
    np.testing.assert_array_equal(got, jx_lib.load_depth_png(depth, hw))


SAMPLER_CASES = [(seed, n_total) for seed in (0, 1, 2) for n_total in
                 (12, 40)] + [(0, 4), (3, 5)]        # too short for 'gap'


def outcome(fn, *args):
    """fn's result, or the type of what it raised."""
    try:
        return fn(*args)
    except ValueError as exc:       # numpy's choice from an empty pool
        return type(exc)


@pytest.mark.parametrize("seed,n_total", SAMPLER_CASES)
def test_samplers_equal_jax(seed, n_total):
    for n_images, n_targets in ((6, 2), (12, 2), (81, 1)):
        for name in ("sample_views_random", "sample_views_gap"):
            got = outcome(getattr(pipeline, name),
                          np.random.RandomState(seed), n_total, n_images,
                          n_targets)
            want = outcome(getattr(jx_pipeline, name),
                           np.random.RandomState(seed), n_total, n_images,
                           n_targets)
            if want is ValueError:
                assert got is ValueError
                continue
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            pipeline.sample_views_stride(n_total, n_images, 3),
            jx_pipeline.sample_views_stride(n_total, n_images, 3))


def jx_cv2_rgb(path, hw):
    return jx_pipeline._imresize(jx_pipeline._imread_rgb(path), hw)


PORT_DECODERS = {"default": None, "native": native_loader.load_resize_rgb,
                 "cv2": pipeline.cv2_load_rgb}


@pytest.mark.parametrize("decoder", ["default", "native", "cv2"])
@pytest.mark.parametrize("name,training", [("scannet", True),
                                           ("scannet", False),
                                           ("arkit", True), ("arkit", False)])
def test_pipeline_batches_equal_jax(datasets, jx_lib, name, training,
                                    decoder):
    """Both pipelines read depth with cv2.  The port's default decoder is
    the native library here (see the fallback test below), so its batches
    are held to JAX's with the JAX package's native library."""
    root, pkl, cfg, jx_cfg = datasets[name]
    scenes = infos.load_infos(pkl, root, cfg.data.classes)
    load_depth = name == "scannet"
    port = pipeline.ScenePipeline(cfg, training=training,
                                  load_depth=load_depth,
                                  image_loader=PORT_DECODERS[decoder])
    jx = jx_pipeline.ScenePipeline(
        jx_cfg, training=training, load_depth=load_depth,
        image_loader=(jx_cv2_rgb if decoder == "cv2"
                      else jx_lib.load_resize_rgb))
    for i, scene in enumerate(scenes):
        got = port(scene, np.random.RandomState(10 + i))
        want = jx(scene, np.random.RandomState(10 + i))
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert ("depth" in got) == load_depth
    assert got["gt_boxes"].shape[1] == (7 if name == "arkit" else 6)


def test_scene_iterator_equals_jax(datasets):
    root, pkl, cfg, jx_cfg = datasets["scannet"]
    scenes = infos.load_infos(pkl, root, cfg.data.classes)
    port = pipeline.ScenePipeline(cfg, image_loader=pipeline.cv2_load_rgb)
    jx = jx_pipeline.ScenePipeline(jx_cfg, image_loader=jx_cv2_rgb)
    got = list(pipeline.scene_iterator(scenes, port, seed=3, repeat=2))
    want = list(jx_pipeline.scene_iterator(scenes, jx, seed=3, repeat=2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("decoder", ["native", "cv2"])
def test_a_missing_image_raises(datasets, decoder):
    root, pkl, cfg, _ = datasets["scannet"]
    scene = infos.load_infos(pkl, root, cfg.data.classes)[0]
    scene = dataclasses.replace(
        scene, img_paths=scene.img_paths[:-1] + [scene.img_paths[-1]
                                                 + ".missing.jpg"])
    loader = (native_loader.load_resize_rgb if decoder == "native"
              else pipeline.cv2_load_rgb)
    port = pipeline.ScenePipeline(cfg, training=False, image_loader=loader)
    with pytest.raises(OSError, match="missing"):
        # the eval sampler draws every view of this 12-view scene
        port(scene, np.random.RandomState(0))


def test_no_decoder_raises_and_names_both(monkeypatch):
    def no_build():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native_loader, "load", no_build)
    monkeypatch.setitem(sys.modules, "cv2", None)        # import cv2 fails
    with pytest.raises(RuntimeError, match="native.*g\\+\\+.*cv2"):
        pipeline.default_image_loader()
    with pytest.raises(RuntimeError, match="cv2"):
        pipeline.ScenePipeline(config.tiny_test_config())


def test_decoder_falls_back_to_cv2_without_the_native_library(monkeypatch,
                                                               tmp_path):
    assert pipeline.default_image_loader() is native_loader.load_resize_rgb
    # a library built on another machine, linked against a libjpeg that
    # this one lacks, does not load: that is no native library either
    junk = tmp_path / "libimage_ops-elsewhere.so"
    junk.write_bytes(b"not an ELF file")
    monkeypatch.setattr(native_loader, "library_path", lambda: junk)
    monkeypatch.setattr(native_loader, "_loaded", [])
    with pytest.raises(RuntimeError, match="does not load"):
        native_loader.load()
    assert pipeline.default_image_loader() is pipeline.cv2_load_rgb
