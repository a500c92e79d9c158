"""RNG tests: statistical moments of the hemisphere sampler (what the
reference leaves to the Eyeball) and the determinism guarantees the
counter-based design provides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cornelis import rng
from cornelis.math.vec import PI, construct_basis, dot, mag2, normalize, vec3


class TestKeys:
    def test_deterministic(self):
        k = rng.make_key(123)
        ids = jnp.arange(64, dtype=jnp.uint32)
        u1 = rng.ray_uniforms(rng.ray_keys(k, ids), 0, 4)
        u2 = rng.ray_uniforms(rng.ray_keys(k, ids), 0, 4)
        assert np.array_equal(np.asarray(u1), np.asarray(u2))

    def test_order_independent(self):
        # The property the reference's per-tile jump-ahead streams provide
        # (Tiles.hpp:22-31), strengthened: each ray's draws depend only on
        # its global id, not on batch layout.
        k = rng.make_key(7)
        ids = jnp.arange(128, dtype=jnp.uint32)
        full = np.asarray(rng.ray_uniforms(rng.ray_keys(k, ids), 3, 2))
        half = np.asarray(rng.ray_uniforms(rng.ray_keys(k, ids[64:]), 3, 2))
        assert np.array_equal(full[64:], half)

    def test_streams_differ(self):
        k = rng.make_key(7)
        ids = jnp.arange(32, dtype=jnp.uint32)
        keys = rng.ray_keys(k, ids)
        a = np.asarray(rng.ray_uniforms(keys, 0, 4))
        b = np.asarray(rng.ray_uniforms(keys, 1, 4))
        assert not np.array_equal(a, b)

    def test_uniform_range(self):
        k = rng.make_key(42)
        ids = jnp.arange(4096, dtype=jnp.uint32)
        u = np.asarray(rng.ray_uniforms(rng.ray_keys(k, ids), 0, 4))
        assert u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 0.02

    def test_no_wraparound_collisions(self):
        # Regression: the old packing `pixel * spp_total + sample` wrapped
        # uint32 past 2^32 rays (1080p at >2070 spp), silently reusing keys.
        # These (pixel, sample) pairs all collide at rid = 0 under spp_total
        # = 4096 with 32-bit packing; separate fold_ins must keep them apart.
        k = rng.make_key(3)
        spp_total = 4096
        pixels = jnp.array([0, 1 << 20, 2 << 20, 3 << 20], dtype=jnp.uint32)
        samples = jnp.zeros(4, dtype=jnp.uint32)
        # Confirm the test premise: packed ids do collide in uint32.
        packed = np.asarray(pixels, np.uint32) * np.uint32(spp_total)
        assert len(set(packed.tolist())) == 1
        streams = rng.make_ray_streams(k, pixels, samples, spp_total)
        u = np.asarray(rng.stream_uniforms(streams, 0, 2))
        assert len({tuple(row) for row in u.tolist()}) == 4

    def test_streams_chunk_invariant_across_spp_total(self):
        # Keys no longer depend on spp_total at all: the same (pixel,
        # sample) pair draws the same numbers whatever the session budget.
        k = rng.make_key(11)
        px = jnp.arange(16, dtype=jnp.uint32)
        si = jnp.full(16, 5, dtype=jnp.uint32)
        a = rng.make_ray_streams(k, px, si, 64)
        b = rng.make_ray_streams(k, px, si, 4096)
        ua = np.asarray(rng.stream_uniforms(a, 1, 2))
        ub = np.asarray(rng.stream_uniforms(b, 1, 2))
        assert np.array_equal(ua, ub)


class TestHemisphere:
    def test_mapping_exact(self):
        # (x1, x2) -> (cos(2 pi x2) b, sin(2 pi x2) b, x1) (PRNG.hpp:39-46).
        x1, x2 = 0.5, 0.25
        v = rng.hemisphere_sample(jnp.float32(x1), jnp.float32(x2))
        b = np.sqrt(1 - x1 * x1)
        a = 2 * PI * x2
        assert float(v.x) == pytest.approx(np.cos(a) * b, abs=1e-6)
        assert float(v.y) == pytest.approx(np.sin(a) * b, abs=1e-6)
        assert float(v.z) == pytest.approx(x1, abs=1e-7)

    def test_unit_and_upper(self):
        k = jax.random.key(0)
        x = jax.random.uniform(k, (2, 8192))
        v = rng.hemisphere_sample(x[0], x[1])
        m = np.asarray(mag2(v))
        assert np.allclose(m, 1.0, atol=1e-5)
        assert np.asarray(v.z).min() >= 0.0

    def test_uniform_moments(self):
        # Uniform hemisphere: E[z] = 1/2, E[x] = E[y] = 0, E[z^2] = 1/3.
        k = jax.random.key(1)
        x = jax.random.uniform(k, (2, 1 << 16))
        v = rng.hemisphere_sample(x[0], x[1])
        z = np.asarray(v.z)
        assert abs(z.mean() - 0.5) < 5e-3
        assert abs((z**2).mean() - 1 / 3) < 5e-3
        assert abs(np.asarray(v.x).mean()) < 5e-3
        assert abs(np.asarray(v.y).mean()) < 5e-3

    def test_basis_placement(self):
        # v0 -> B, v1 -> T, v2 -> N (PRNG.hpp:52-55).
        n = normalize(vec3(0.0, 0.0, 1.0))
        basis = construct_basis(n)
        x1, x2 = jnp.float32(0.7), jnp.float32(0.3)
        placed = rng.hemisphere_sample_basis(x1, x2, basis)
        canonical = rng.hemisphere_sample(x1, x2)
        expected = (
            basis.b * canonical.x + basis.t * canonical.y + basis.n * canonical.z
        )
        assert float(placed.x) == pytest.approx(float(expected.x), abs=1e-6)
        assert float(dot(placed, n)) == pytest.approx(float(canonical.z), abs=1e-6)

    def test_pdf(self):
        assert rng.hemisphere_pdf() == pytest.approx(1.0 / (2.0 * PI))
