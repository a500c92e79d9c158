"""Camera tests mirroring tests/test_Camera.cpp plus the lookAt quirks the
reference never exercises."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.camera import (
    default_camera,
    generate_rays,
    horizontal_fov_35mm,
    look_at,
)


def _dir_at(cam, x, y):
    _, d = generate_rays(cam, jnp.float32(x), jnp.float32(y))
    return np.array([float(d.x), float(d.y), float(d.z)])


class TestFov35mm:
    def test_throws_nonpositive(self):
        with pytest.raises(ValueError):
            horizontal_fov_35mm(0.0)
        with pytest.raises(ValueError):
            horizontal_fov_35mm(-1.0)

    def test_values(self):
        # 2*atan(36 / (2*f)) (Camera.cpp:36-39).
        assert horizontal_fov_35mm(36.0) == pytest.approx(2 * math.atan(0.5))
        assert horizontal_fov_35mm(18.0) == pytest.approx(math.pi / 2)


class TestDefaultCamera:
    def test_center_ray(self):
        # Default ctor: center of frame looks straight down +Z
        # (tests/test_Camera.cpp default-camera case).
        cam = default_camera()
        d = _dir_at(cam, 0.5, 0.5)
        assert np.allclose(d, [0, 0, 1], atol=1e-6)

    def test_corner(self):
        cam = default_camera()
        d = _dir_at(cam, 0.0, 0.0)
        expected = np.array([-0.4794255386, -0.4794255386, 1.0])
        expected /= np.linalg.norm(expected)
        assert np.allclose(d, expected, atol=1e-6)


class TestLookAt:
    def test_axis_aligned_center(self):
        cam = look_at((0.0, 0.0, -5.0), (0.0, 0.0, 0.0), 1.0, 1.0)
        d = _dir_at(cam, 0.5, 0.5)
        assert np.allclose(d, [0, 0, 1], atol=1e-6)

    def test_eye_position(self):
        cam = look_at((1.0, 2.0, 3.0), (1.0, 2.0, 10.0), 1.0, 0.7)
        o, _ = generate_rays(cam, jnp.float32(0.5), jnp.float32(0.5))
        assert np.allclose([float(o.x), float(o.y), float(o.z)], [1, 2, 3])

    def test_fov_scale(self):
        # frame width vector |u| = 2 sin(hFov/2) for axis-aligned view
        # (Camera.cpp:23-24; |up x dir| = 1 there).
        hfov = 0.7
        cam = look_at((0.0, 0.0, -5.0), (0.0, 0.0, 0.0), 1.0, hfov)
        u = np.array([float(cam.u.x), float(cam.u.y), float(cam.u.z)])
        assert np.linalg.norm(u) == pytest.approx(2 * math.sin(hfov / 2), abs=1e-6)

    def test_v_points_down(self):
        # v = u x dir points world-down for an axis-aligned camera: y=0 is
        # the TOP of the image (Camera.cpp:21).
        cam = look_at((0.0, 0.0, -5.0), (0.0, 0.0, 0.0), 1.0, 0.7)
        v = np.array([float(cam.v.x), float(cam.v.y), float(cam.v.z)])
        assert v[1] < 0

    def test_unnormalized_u_quirk(self):
        # When dir is not perpendicular to up, |up x dir| < 1 and the FOV
        # shrinks -- reference quirk (Camera.cpp:20, never re-normalized).
        hfov = 0.7
        cam = look_at((0.0, 5.0, -5.0), (0.0, 0.0, 0.0), 1.0, hfov)
        u = np.array([float(cam.u.x), float(cam.u.y), float(cam.u.z)])
        sin_tilt = 5.0 / math.sqrt(50.0)  # |up x dir| for this 45-degree tilt
        assert np.linalg.norm(u) == pytest.approx(
            2 * math.sin(hfov / 2) * sin_tilt, abs=1e-6
        )

    def test_aspect_multiplies_v(self):
        cam1 = look_at((0.0, 0.0, -5.0), (0.0, 0.0, 0.0), 1.0, 0.7)
        cam2 = look_at((0.0, 0.0, -5.0), (0.0, 0.0, 0.0), 2.0, 0.7)
        v1 = np.linalg.norm([float(cam1.v.x), float(cam1.v.y), float(cam1.v.z)])
        v2 = np.linalg.norm([float(cam2.v.x), float(cam2.v.y), float(cam2.v.z)])
        u1 = np.linalg.norm([float(cam1.u.x), float(cam1.u.y), float(cam1.u.z)])
        u2 = np.linalg.norm([float(cam2.u.x), float(cam2.u.y), float(cam2.u.z)])
        assert v2 == pytest.approx(2 * v1, rel=1e-6)
        assert u2 == pytest.approx(u1, rel=1e-6)

    def test_vectorized_raygen(self):
        cam = look_at((0.0, 0.0, -5.0), (0.0, 0.0, 0.0), 1.0, 0.7)
        xs = jnp.linspace(0.0, 1.0, 16)
        ys = jnp.linspace(0.0, 1.0, 16)
        o, d = generate_rays(cam, xs, ys)
        assert o.x.shape == (16,)
        norms = np.sqrt(
            np.asarray(d.x) ** 2 + np.asarray(d.y) ** 2 + np.asarray(d.z) ** 2
        )
        assert np.allclose(norms, 1.0, atol=1e-6)
