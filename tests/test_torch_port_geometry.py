"""The port's geometry, sampling and plane sweep against the JAX package.

Geometry to 1e-6 relative with equal neighbour index sets; sampling and
the plane-sweep variance to 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from mvsdet_tpu.geometry import cameras as jx_cameras
from mvsdet_tpu.geometry import rays as jx_rays
from mvsdet_tpu.geometry import sh as jx_sh
from mvsdet_tpu.geometry import transforms as jx_transforms
from mvsdet_tpu.geometry import voxels as jx_voxels
from mvsdet_tpu.ops import plane_sweep as jx_plane_sweep
from mvsdet_tpu.ops import sampling as jx_sampling

from mvsdet_torch.geometry import cameras, rays, sh, transforms, voxels
from mvsdet_torch.ops import plane_sweep, sampling

T = torch.from_numpy


def close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def ring_cameras(n, seed=0, h=8, w=12):
    """(N, 4, 4) w2c of cameras on a jittered ring looking at the origin,
    and a (4, 4) K at image resolution."""
    rng = np.random.RandomState(seed)
    w2cs = []
    for i in range(n):
        ang = 2 * np.pi * i / n + rng.uniform(-0.2, 0.2)
        eye = np.array([3 * np.cos(ang), 3 * np.sin(ang),
                        1.2 + rng.uniform(-0.3, 0.3)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = \
            right, np.cross(fwd, right), fwd, eye
        w2cs.append(np.linalg.inv(c2w))
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.9 * w * 4
    k[0, 2], k[1, 2] = w * 2.0, h * 2.0
    return np.asarray(w2cs, np.float32), k.astype(np.float32)


class TestCameras:
    def test_projection_and_intrinsics(self):
        w2c, k = ring_cameras(5)
        kf_j = jx_cameras.scale_intrinsics(jnp.asarray(k), 4.0)
        kf_t = cameras.scale_intrinsics(T(k), 4.0)
        close(kf_t, kf_j)
        close(cameras.full_projection(T(w2c), kf_t),
              jx_cameras.full_projection(jnp.asarray(w2c), kf_j), rtol=1e-6,
              atol=1e-5)

    @pytest.mark.parametrize("n,k", [(6, 2), (9, 3)])
    def test_neighbour_indices_equal(self, n, k):
        w2c, _ = ring_cameras(n, seed=n)
        c2w = np.linalg.inv(w2c).astype(np.float32)
        want = jx_cameras.knn_camera_neighbors(jnp.asarray(c2w[:, :3, 3]), k)
        got = cameras.knn_camera_neighbors(T(c2w[:, :3, 3]), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tgt = np.linalg.inv(ring_cameras(2, seed=n + 1)[0]).astype(np.float32)
        want = jx_cameras.nearest_pose_ids(jnp.asarray(tgt), jnp.asarray(c2w),
                                           k)
        got = cameras.nearest_pose_ids(T(tgt), T(c2w), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("seed", range(4))
    def test_neighbour_indices_equal_on_ties(self, seed):
        """Cameras at equal distances: a symmetric ring (12 views at equal
        angles, as the real-format fixtures orbit) sampled with repeats,
        as the pipeline repeats views of a scene shorter than its view
        count.  `torch.topk` broke these ties unlike `jax.lax.top_k`."""
        ang = 2 * np.pi * np.arange(12) / 12
        ring = np.stack([2.2 * np.cos(ang), 2.2 * np.sin(ang),
                         1.4 + 0.2 * np.sin(2 * ang)], -1)
        rng = np.random.RandomState(seed)
        pos = ring[rng.choice(12, 16)].astype(np.float32)
        c2w = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
        c2w[:, :3, 3] = pos
        for k in (2, 3):
            want = jx_cameras.knn_camera_neighbors(jnp.asarray(pos), k)
            got = cameras.knn_camera_neighbors(T(pos), k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            want = jx_cameras.nearest_pose_ids(jnp.asarray(c2w[:2]),
                                               jnp.asarray(c2w), k)
            got = cameras.nearest_pose_ids(T(c2w[:2]), T(c2w), k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestVoxelsAndRays:
    def test_voxel_points(self):
        origin = np.array([0.1, -0.2, 0.5], np.float32)
        close(voxels.voxel_points((4, 6, 2), (0.16, 0.16, 0.2), T(origin)),
              jx_voxels.voxel_points((4, 6, 2), (0.16, 0.16, 0.2), origin))
        sizes = [(8, 8, 4), (4, 4, 2)]
        for got, want in zip(
                voxels.multiscale_voxel_points(sizes, (0.16, 0.16, 0.2),
                                               T(origin)),
                jx_voxels.multiscale_voxel_points(sizes, (0.16, 0.16, 0.2),
                                                  origin)):
            close(got, want)
        close(voxels.depth_plane_values(0.2, 5.0, 12),
              jx_voxels.depth_plane_values(0.2, 5.0, 12))

    def test_rays(self):
        xy_t, ij_t = rays.sample_image_grid((5, 7))
        xy_j, ij_j = jx_rays.sample_image_grid((5, 7))
        close(xy_t, xy_j)
        np.testing.assert_array_equal(ij_t.numpy(), np.asarray(ij_j))
        w2c, k = ring_cameras(3)
        c2w = np.linalg.inv(w2c).astype(np.float32)
        kn = (k[:3, :3] / np.array([[48.0], [32.0], [1.0]])).astype(np.float32)
        coords = np.random.RandomState(0).rand(3, 10, 2).astype(np.float32)
        got = rays.get_world_rays(T(coords), T(c2w)[:, None], T(kn))
        want = jx_rays.get_world_rays(coords, c2w[:, None], kn)
        for g, w in zip(got, want):
            close(g, w)
        close(rays.depth_scale_map(8, 12, T(k / 4)),
              jx_rays.depth_scale_map(8, 12, jnp.asarray(k / 4)))


class TestGaussianGeometry:
    def test_build_covariance(self):
        rng = np.random.RandomState(1)
        scale = rng.uniform(0.01, 0.3, (20, 3)).astype(np.float32)
        quat = rng.randn(20, 4).astype(np.float32)
        close(transforms.build_covariance(T(scale), T(quat)),
              jx_transforms.build_covariance(scale, quat))

    @pytest.mark.parametrize("degree", [1, 4])
    def test_sh_rotate_and_eval(self, degree):
        rng = np.random.RandomState(degree)
        n = (degree + 1) ** 2
        coeffs = rng.randn(6, 3, n).astype(np.float32)
        q = rng.randn(6, 4).astype(np.float32)
        rot = np.array(jx_transforms.quaternion_to_matrix(q))
        got = sh.rotate_sh(T(coeffs), T(rot)[:, None])
        want = jx_sh.rotate_sh(coeffs, rot[:, None])
        close(got, want, rtol=1e-5, atol=1e-5)
        dirs = rng.randn(6, 3).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        close(sh.eval_sh_color(T(coeffs), T(dirs)),
              jx_sh.eval_sh_color(coeffs, dirs), rtol=1e-6, atol=1e-6)


class TestSampling:
    def test_bilinear_sample_zero_padding(self):
        rng = np.random.RandomState(2)
        img = rng.rand(6, 9, 4).astype(np.float32)
        coords = rng.uniform(-2, 11, (5, 7, 2)).astype(np.float32)
        close(sampling.bilinear_sample(T(img)[None], T(coords)[None])[0],
              jx_sampling.bilinear_sample(img, coords), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("src,dst", [((240, 320), (60, 80)),
                                         ((32, 48), (8, 12)),
                                         ((7, 9), (14, 20))])
    def test_bilinear_resize_antialias_like_jax(self, src, dst):
        """ROADMAP trap T1: JAX antialiases when it downsamples."""
        img = np.random.RandomState(3).rand(*src, 3).astype(np.float32)
        close(sampling.bilinear_resize(T(img)[None], dst)[0],
              jx_sampling.bilinear_resize(img, dst), rtol=1e-5, atol=1e-5)

    def test_trilinear_resize_like_jax(self):
        """ROADMAP trap T2: the head's validity volume 40x40x16 -> halves."""
        vol = np.random.RandomState(4).randint(0, 4, (40, 40, 16)) \
            .astype(np.float32)
        for shape in [(20, 20, 8), (10, 10, 4), (40, 40, 16)]:
            want = jax.image.resize(vol, shape, method="trilinear")
            got = sampling.linear_resize(T(vol), shape, (0, 1, 2))
            close(got, want, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal((got >= 0.5).numpy(),
                                          np.asarray(want) >= 0.5)

    @pytest.mark.parametrize("src,dst", [((8, 10), (15, 20)),
                                         ((1, 2), (2, 3)), ((4, 6), (8, 12))])
    def test_nearest_resize_like_jax(self, src, dst):
        """ROADMAP trap T3: JAX nearest takes half-pixel centres."""
        x = np.random.RandomState(5).rand(2, 3, *src).astype(np.float32)
        want = jax.image.resize(x, (2, 3) + dst, method="nearest")
        np.testing.assert_array_equal(
            sampling.nearest_resize(T(x), dst, (2, 3)).numpy(),
            np.asarray(want))


class TestPlaneSweep:
    def test_homography_coords(self):
        rel = np.eye(4, dtype=np.float32)
        rel[:3, :3] += np.random.RandomState(6).randn(3, 3) * 0.05
        rel[:3, 3] = [0.3, -0.2, 0.1]
        depths = np.linspace(0.5, 4.0, 5).astype(np.float32)
        close(plane_sweep.homography_coords(T(rel), T(depths), 6, 8),
              jx_plane_sweep.homography_coords(rel, depths, 6, 8),
              rtol=1e-5, atol=1e-5)

    def test_variance_volume(self):
        n, h, w, c = 5, 8, 12, 16
        w2c, k = ring_cameras(n, h=h, w=w)
        feats = np.random.RandomState(7).rand(n, h, w, c).astype(np.float32)
        kf = np.array(jx_cameras.scale_intrinsics(jnp.asarray(k), 4.0))
        proj = np.array(jx_cameras.full_projection(jnp.asarray(w2c), kf))
        c2w = np.linalg.inv(w2c)
        nb = np.array(jx_cameras.knn_camera_neighbors(
            jnp.asarray(c2w[:, :3, 3].astype(np.float32)), 2))
        depths = np.array(jx_voxels.depth_plane_values(0.2, 5.0, 6))
        ref_ids = np.array([1, 3], np.int32)
        want = jax.jit(jx_plane_sweep.plane_sweep_variance_for_refs)(
            feats, proj, ref_ids, nb[ref_ids], depths)
        got = plane_sweep.plane_sweep_variance_for_refs(
            T(feats), T(proj), T(ref_ids).long(), T(nb[ref_ids]).long(),
            T(depths))
        close(got, want, rtol=1e-5, atol=1e-5)
        assert np.asarray(want).max() > 0
