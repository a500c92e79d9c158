"""QMC sampler tests (the reference's Sampling.hpp is an empty placeholder
for this subsystem -- README Milestone 5; our tests define its contract).

Key properties verified:
  * the unscrambled generator reproduces the canonical base-2 Sobol
    (0,2)-sequence;
  * hash-based Owen scrambling is a *nested* permutation (prefix-preserving
    bijection), so stratification guarantees survive;
  * scrambled points keep the (0,2) elementary-interval property;
  * integration error beats pseudo-random at equal sample count;
  * the integrator runs end-to-end with sampler="sobol" and agrees with the
    uniform sampler in the mean.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cornelis import sampling
from cornelis.rng import make_key, make_ray_streams, stream_uniforms


def _sobol_points(n, seed_x=None, seed_y=None):
    idx = jnp.arange(n, dtype=jnp.uint32)
    d0, d1 = sampling.sobol2d_bits(idx)
    if seed_x is not None:
        d0 = sampling.owen_scramble(d0, jnp.full((n,), seed_x, jnp.uint32))
        d1 = sampling.owen_scramble(d1, jnp.full((n,), seed_y, jnp.uint32))
    x = np.asarray(sampling.bits_to_unit_float(d0))
    y = np.asarray(sampling.bits_to_unit_float(d1))
    return x, y


class TestBitUtils:
    def test_reverse_bits(self):
        got = np.asarray(
            sampling.reverse_bits32(jnp.array([1, 0x80000000, 0xF], jnp.uint32))
        )
        assert got[0] == 0x80000000
        assert got[1] == 1
        assert got[2] == 0xF0000000

    def test_hash32_distinct(self):
        xs = jnp.arange(4096, dtype=jnp.uint32)
        hs = np.asarray(sampling.hash32(xs))
        assert len(np.unique(hs)) == 4096  # injective on this range

    def test_bits_to_unit_float_matches_reference_quantization(self):
        # (x >> 8) * 2^-24 (XoshiroCpp.hpp:649-654).
        bits = jnp.array([0, 0xFFFFFFFF, 1 << 8], jnp.uint32)
        got = np.asarray(sampling.bits_to_unit_float(bits))
        assert got[0] == 0.0
        assert got[1] == np.float32((0xFFFFFF) * 2.0**-24)
        assert got[2] == np.float32(2.0**-24)
        assert np.all(got < 1.0)


class TestSobolSequence:
    def test_first_points_match_canonical_sobol(self):
        x, y = _sobol_points(8)
        # dim 0: van der Corput base 2; dim 1: Sobol' second dimension.
        assert np.allclose(x, [0, 0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875])
        assert np.allclose(y, [0, 0.5, 0.75, 0.25, 0.625, 0.125, 0.375, 0.875])

    @pytest.mark.parametrize("nx,ny", [(16, 1), (1, 16), (4, 4), (2, 8), (8, 2)])
    def test_elementary_intervals_unscrambled(self, nx, ny):
        x, y = _sobol_points(16)
        cells = (np.floor(x * nx).astype(int), np.floor(y * ny).astype(int))
        counts = np.zeros((nx, ny), int)
        np.add.at(counts, cells, 1)
        assert np.all(counts == 1)

    @pytest.mark.parametrize("seed", [1, 0xDEADBEEF, 12345])
    @pytest.mark.parametrize("nx,ny", [(16, 1), (1, 16), (4, 4), (2, 8), (8, 2)])
    def test_elementary_intervals_survive_scrambling(self, seed, nx, ny):
        x, y = _sobol_points(16, seed_x=seed, seed_y=seed ^ 0x5555)
        cells = (np.floor(x * nx).astype(int), np.floor(y * ny).astype(int))
        counts = np.zeros((nx, ny), int)
        np.add.at(counts, cells, 1)
        assert np.all(counts == 1)


class TestOwenScramble:
    def test_bijection(self):
        xs = jnp.arange(8192, dtype=jnp.uint32) * jnp.uint32(524287)
        seed = jnp.full((8192,), 77, jnp.uint32)
        ys = np.asarray(sampling.owen_scramble(xs, seed))
        assert len(np.unique(ys)) == 8192

    def test_nested_prefix_property(self):
        # Owen scrambling: if two inputs share their top-k bits, the outputs
        # share their top-k bits (digit permutations are nested).
        rng = np.random.default_rng(0)
        a = rng.integers(0, 2**32, 256, dtype=np.uint32)
        for k in (1, 4, 9, 17):
            mask = np.uint32(0xFFFFFFFF) << np.uint32(32 - k)
            b = (a & mask) | rng.integers(0, 2**32, 256, dtype=np.uint32) & ~mask
            seed = jnp.full((256,), 1234, jnp.uint32)
            sa = np.asarray(sampling.owen_scramble(jnp.asarray(a), seed))
            sb = np.asarray(sampling.owen_scramble(jnp.asarray(b), seed))
            assert np.all((sa & mask) == (sb & mask))

    def test_scramble_changes_with_seed(self):
        xs = jnp.arange(64, dtype=jnp.uint32) << 16
        y1 = np.asarray(sampling.owen_scramble(xs, jnp.full((64,), 1, jnp.uint32)))
        y2 = np.asarray(sampling.owen_scramble(xs, jnp.full((64,), 2, jnp.uint32)))
        assert np.any(y1 != y2)


class TestIntegrationError:
    def test_beats_random_on_smooth_integrand(self):
        n = 256
        x, y = _sobol_points(n, seed_x=99, seed_y=1717)
        sobol_err = abs(np.mean(x * y) - 0.25)
        rng = np.random.default_rng(3)
        rand_errs = [
            abs(np.mean(rng.random(n) * rng.random(n)) - 0.25) for _ in range(20)
        ]
        # Sobol beats the *median* random run by a wide margin.
        assert sobol_err < np.median(rand_errs) / 2
        assert sobol_err < 5e-3


class TestStreamUniforms:
    def _streams(self, n_pixels, spp):
        px = jnp.repeat(jnp.arange(n_pixels, dtype=jnp.uint32), spp)
        si = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), n_pixels)
        return make_ray_streams(make_key(7), px, si, spp)

    def test_sobol_camera_jitter_is_stratified_per_pixel(self):
        spp = 16
        streams = self._streams(4, spp)
        u = np.asarray(stream_uniforms(streams, 0, 2, sampler="sobol"))
        u = u.reshape(4, spp, 2)
        for p in range(4):
            counts = np.zeros((4, 4), int)
            cells = (
                np.floor(u[p, :, 0] * 4).astype(int),
                np.floor(u[p, :, 1] * 4).astype(int),
            )
            np.add.at(counts, cells, 1)
            assert np.all(counts == 1), f"pixel {p} not (0,2)-stratified"

    def test_pixels_decorrelated(self):
        spp = 64
        streams = self._streams(2, spp)
        u = np.asarray(stream_uniforms(streams, 0, 2, sampler="sobol"))
        u = u.reshape(2, spp, 2)
        # Same sample index, different pixel: values differ (per-pixel seeds).
        assert np.any(np.abs(u[0] - u[1]) > 1e-3)

    def test_streams_decorrelated(self):
        streams = self._streams(1, 64)
        a = np.asarray(stream_uniforms(streams, 1, 4, sampler="sobol"))
        b = np.asarray(stream_uniforms(streams, 2, 4, sampler="sobol"))
        assert np.any(np.abs(a - b) > 1e-3)

    def test_padded_pairs_decorrelated(self):
        streams = self._streams(1, 256)
        u = np.asarray(stream_uniforms(streams, 3, 4, sampler="sobol"))
        # Columns (0, 2) reuse the same Sobol dim under different scrambles;
        # their correlation must be small.
        c = np.corrcoef(u[:, 0], u[:, 2])[0, 1]
        assert abs(c) < 0.2

    def test_uniform_mode_unchanged(self):
        from cornelis.rng import pixel_sample_keys, ray_uniforms

        px = jnp.array([3, 3], jnp.uint32)
        si = jnp.array([0, 1], jnp.uint32)
        streams = make_ray_streams(make_key(5), px, si, 8)
        got = np.asarray(stream_uniforms(streams, 2, 3, sampler="uniform"))
        want = np.asarray(
            ray_uniforms(pixel_sample_keys(make_key(5), px, si), 2, 3)
        )
        assert np.array_equal(got, want)


class TestEndToEnd:
    def test_sobol_render_matches_uniform_mean(self):
        from cornelis.integrator import render_chunk
        from cornelis.scene.compile import compile_scene
        from cornelis.scene.library import sphere_on_plane

        scene = compile_scene(sphere_on_plane())
        spp = 512
        kw = dict(width=24, height=24, spp_chunk=spp, spp_total=spp, max_depth=6)
        img_u = np.asarray(
            render_chunk(scene, make_key(1), jnp.uint32(0), sampler="uniform", **kw)
        ) / spp
        img_s = np.asarray(
            render_chunk(scene, make_key(1), jnp.uint32(0), sampler="sobol", **kw)
        ) / spp
        assert np.all(np.isfinite(img_s))
        assert img_s.mean() > 0
        # Same scene, same (unbiased) estimator: means agree within MC noise
        # (measured +0.03% at 512 spp; 2% bound leaves noise headroom).
        assert abs(img_s.mean() - img_u.mean()) / img_u.mean() < 0.02
