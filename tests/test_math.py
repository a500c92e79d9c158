"""Math core tests, mirroring the reference's test_Math.cpp / test_Color.cpp /
test_Tiles.cpp coverage plus the fixed spill behavior."""

import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.math import color, tiles
from cornelis.math.vec import (
    Basis,
    Vec3,
    construct_basis,
    cross,
    dot,
    length,
    mag2,
    normalize,
    ray_at,
    vec3,
)


def v(x, y, z):
    return vec3(float(x), float(y), float(z))


def as_np(a: Vec3):
    return np.array([float(a.x), float(a.y), float(a.z)])


class TestVecOps:
    def test_componentwise_ops(self):
        a = v(1, 2, 3)
        b = v(4, 5, 6)
        assert np.allclose(as_np(a + b), [5, 7, 9])
        assert np.allclose(as_np(a - b), [-3, -3, -3])
        assert np.allclose(as_np(a * b), [4, 10, 18])
        assert np.allclose(as_np(a * 2.0), [2, 4, 6])
        assert np.allclose(as_np(2.0 * a), [2, 4, 6])
        assert np.allclose(as_np(-a), [-1, -2, -3])
        assert np.allclose(as_np(a / 2.0), [0.5, 1, 1.5])

    def test_dot_mag2(self):
        # Exact-value checks as in test_Math.cpp.
        assert float(dot(v(1, 2, 3), v(4, 5, 6))) == pytest.approx(32.0)
        assert float(mag2(v(3, 4, 0))) == pytest.approx(25.0)
        assert float(length(v(3, 4, 0))) == pytest.approx(5.0)

    def test_ray_at(self):
        p = ray_at(v(1, 0, 0), v(0, 1, 0), jnp.float32(2.5))
        assert np.allclose(as_np(p), [1, 2.5, 0])

    def test_cross(self):
        assert np.allclose(as_np(cross(v(1, 0, 0), v(0, 1, 0))), [0, 0, 1])
        assert np.allclose(as_np(cross(v(0, 1, 0), v(1, 0, 0))), [0, 0, -1])

    def test_normalize(self):
        n = normalize(v(3, 0, 0))
        assert np.allclose(as_np(n), [1, 0, 0])
        # Zero cut-off (Math.hpp:392-398): tiny vectors map to zero.
        z = normalize(v(1e-6, 1e-6, 0))
        assert np.allclose(as_np(z), [0, 0, 0])

    def test_normalize_batched(self):
        vs = Vec3(jnp.array([3.0, 0.0]), jnp.array([0.0, 2.0]), jnp.array([4.0, 0.0]))
        n = normalize(vs)
        assert np.allclose(np.asarray(n.x), [0.6, 0.0])
        assert np.allclose(np.asarray(n.y), [0.0, 1.0])
        assert np.allclose(np.asarray(n.z), [0.8, 0.0])


class TestBasis:
    def test_orthonormal(self):
        for n in ([0, 0, 1], [1, 0, 0], [0.577, 0.577, 0.577]):
            nn = normalize(v(*n))
            b = construct_basis(nn)
            assert float(dot(b.n, b.t)) == pytest.approx(0.0, abs=1e-6)
            assert float(dot(b.n, b.b)) == pytest.approx(0.0, abs=1e-6)
            assert float(dot(b.t, b.b)) == pytest.approx(0.0, abs=1e-6)
            assert float(mag2(b.t)) == pytest.approx(1.0, abs=1e-5)
            assert float(mag2(b.b)) == pytest.approx(1.0, abs=1e-5)

    def test_helper_flip_at_095(self):
        # |N.y| > 0.95 switches helper to +Z (Math.hpp:424-428); the basis
        # must stay well-conditioned for a straight-up normal.
        b = construct_basis(v(0, 1, 0))
        assert float(mag2(b.t)) == pytest.approx(1.0, abs=1e-5)
        assert float(mag2(b.b)) == pytest.approx(1.0, abs=1e-5)

    def test_batched_mixed_flip(self):
        ns = Vec3(
            jnp.array([0.0, 1.0]), jnp.array([1.0, 0.0]), jnp.array([0.0, 0.0])
        )
        b = construct_basis(ns)
        t0 = np.array([float(b.t.x[0]), float(b.t.y[0]), float(b.t.z[0])])
        assert np.linalg.norm(t0) == pytest.approx(1.0, abs=1e-5)


class TestColor:
    def test_srgb_reference_slope(self):
        # Linear segment uses 12.95 (reference quirk, src/Color.cpp:68).
        x = jnp.float32(0.001)
        assert float(color.srgb_encode(x)) == pytest.approx(0.001 * 12.95, rel=1e-6)
        assert float(color.srgb_encode(x, standard=True)) == pytest.approx(
            0.001 * 12.92, rel=1e-6
        )

    def test_srgb_known_values(self):
        # toSRGB at black / mid / white (test_Color.cpp:47-65, tol 0.01).
        assert float(color.srgb_encode(jnp.float32(0.0))) == pytest.approx(0.0, abs=1e-6)
        assert float(color.srgb_encode(jnp.float32(1.0))) == pytest.approx(1.0, abs=1e-5)
        assert float(color.srgb_encode(jnp.float32(0.5))) == pytest.approx(0.7353, abs=0.01)

    def test_srgb_roundtrip(self):
        xs = jnp.linspace(0.0, 1.0, 64)
        back = color.srgb_decode(color.srgb_encode(xs))
        assert np.allclose(np.asarray(back), np.asarray(xs), atol=1e-5)

    def test_quantize(self):
        # Rounding / saturation (test_FrameBuffer.cpp quantize coverage).
        q = color.quantize_to_8bit(jnp.array([-0.5, 0.0, 0.5, 1.0, 2.0]))
        assert list(np.asarray(q)) == [0, 0, 128, 255, 255]


class TestTiling:
    def test_throws_on_degenerate(self):
        with pytest.raises(ValueError):
            tiles.FrameTiling(0, 10)
        with pytest.raises(ValueError):
            tiles.FrameTiling(10, 10, 0, 4)

    def test_exact_multiple_grid(self):
        # Mirrors test_Tiles.cpp:21-37: exact-multiple grid bounds and
        # tile-number bijection.
        t = tiles.FrameTiling(64, 64, 32, 32)
        assert len(t) == 4
        assert [tb.tile_number for tb in t] == [0, 1, 2, 3]
        assert (t[0].min_i, t[0].min_j, t[0].max_i, t[0].max_j) == (0, 0, 31, 31)
        assert (t[3].min_i, t[3].min_j, t[3].max_i, t[3].max_j) == (32, 32, 63, 63)
        assert all(tb.area == 32 * 32 for tb in t)

    def test_spill_fixed(self):
        # The reference's spill path is buggy (src/Tiles.cpp:21-24 writes
        # absolute spill-1); we clip the last tile to the frame edge.
        t = tiles.FrameTiling(70, 40, 32, 32)
        assert t.num_x == 3 and t.num_y == 2
        last_col = t[2]
        assert (last_col.min_i, last_col.max_i) == (64, 69)
        last_row = t[5]
        assert (last_row.min_j, last_row.max_j) == (32, 39)
        # Tiles exactly partition the frame.
        assert sum(tb.area for tb in t) == 70 * 40

    def test_split_evenly(self):
        chunks = tiles.split_evenly(10, 4)
        assert chunks == [(0, 3), (3, 3), (6, 2), (8, 2)]
        assert tiles.pad_to_multiple(10, 4) == 12
        assert tiles.pad_to_multiple(8, 4) == 8
