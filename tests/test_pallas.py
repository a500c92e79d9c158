"""Pallas megakernel tests (runnable on CPU).

Coverage for the GPU's default backend, which the CPU suite otherwise never
exercises (on the CPU, backend="auto" renders on the XLA wavefront):

  * ops/threefry.py against the Random123 published known-answer vectors
    for Threefry-2x32 (20 rounds) AND cross-validated against JAX's own
    threefry_2x32 on random batches -- the megakernel's only component with
    no jax.random counterpart in the hot path;
  * the full megakernel in Pallas *interpret* mode (pallas_call lowers to
    plain jnp on CPU, same program structure) compared distributionally
    against the XLA wavefront (integrator.render_chunk) at identical
    (scene, resolution, spp): different RNG bits by design, identical
    physics, so the two images must agree within Monte-Carlo noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.integrator import render_chunk
from cornelis.ops.threefry import pair_uniforms, threefry2x32, to_unit_float
from cornelis.rng import make_key
from cornelis.scene.compile import compile_scene
from cornelis.scene.library import cornell_box


def _tf(k0, k1, c0, c1):
    a = lambda v: jnp.asarray(v, jnp.uint32)
    x0, x1 = threefry2x32(a(k0), a(k1), a(c0), a(c1))
    return int(np.asarray(x0)), int(np.asarray(x1))


class TestThreefryKAT:
    """Random123 kat_vectors for threefry2x32, 20 rounds (Salmon et al.
    SC'11; the same vectors JAX pins its own implementation to)."""

    def test_zero_key_zero_counter(self):
        assert _tf(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)

    def test_ones(self):
        m = 0xFFFFFFFF
        assert _tf(m, m, m, m) == (0x1CB996FC, 0xBB002BE7)

    def test_pi_digits(self):
        # ctr = (0x243f6a88, 0x85a308d3), key = (0x13198a2e, 0x03707344).
        assert _tf(0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3) == (
            0xC4923A9C,
            0x483DF7A0,
        )

    def test_matches_jax_threefry(self):
        # Cross-validation against jax's internal threefry_2x32 on a batch
        # of random (key, counter) inputs.
        from jax._src.prng import threefry_2x32

        rk = jax.random.key(0)
        bits = jax.random.bits(rk, (4, 256), jnp.uint32)
        k0, k1, c0, c1 = bits
        ours = threefry2x32(k0, k1, c0, c1)
        theirs = threefry_2x32(jnp.stack([k0, k1]), jnp.stack([c0, c1]))
        assert np.array_equal(np.asarray(ours[0]), np.asarray(theirs[0]))
        assert np.array_equal(np.asarray(ours[1]), np.asarray(theirs[1]))


class TestUnitFloat:
    def test_quantization(self):
        # (x >> 8) * 2^-24: the reference's FloatFromBits
        # (XoshiroCpp.hpp:649-654).
        bits = jnp.asarray([0, 0xFF, 0x100, 0xFFFFFFFF], jnp.uint32)
        f = np.asarray(to_unit_float(bits))
        assert f[0] == 0.0
        assert f[1] == 0.0  # low 8 bits discarded
        assert f[2] == pytest.approx(2.0**-24)
        assert f[3] == pytest.approx((2**24 - 1) / 2**24)
        assert np.all(f >= 0.0) and np.all(f < 1.0)

    def test_pair_uniforms_distinct_streams(self):
        k0 = jnp.uint32(1)
        k1 = jnp.uint32(2)
        px = jnp.arange(64, dtype=jnp.uint32)
        si = jnp.zeros(64, jnp.uint32)
        a = pair_uniforms(k0, k1, px, si, np.uint32(0), 0)
        b = pair_uniforms(k0, k1, px, si, np.uint32(1), 0)
        c = pair_uniforms(k0, k1, px, si, np.uint32(0), 1)
        assert not np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
        assert not np.array_equal(np.asarray(a[0]), np.asarray(c[0]))

    def test_pair_uniforms_moments(self):
        k0 = jnp.uint32(7)
        k1 = jnp.uint32(9)
        px = jnp.arange(1 << 14, dtype=jnp.uint32)
        si = jnp.zeros(1 << 14, jnp.uint32)
        u0, u1 = pair_uniforms(k0, k1, px, si, np.uint32(3), 0)
        for u in (np.asarray(u0), np.asarray(u1)):
            assert abs(u.mean() - 0.5) < 0.01
            assert abs(u.var() - 1.0 / 12.0) < 0.01


class TestMegakernelInterpret:
    """The megakernel itself, interpret=True (plain jnp on CPU)."""

    W = H = 32
    SPP = 16
    MAX_DEPTH = 8

    @pytest.fixture(scope="class")
    def images(self):
        from cornelis.ops.pallas_integrator import render_chunk_pallas

        scene = compile_scene(cornell_box())
        key = make_key()
        kw = dict(
            width=self.W,
            height=self.H,
            spp_chunk=self.SPP,
            spp_total=self.SPP,
            max_depth=self.MAX_DEPTH,
        )
        pallas_img = np.asarray(
            render_chunk_pallas(scene, key, np.uint32(0), interpret=True, **kw)
        ) / self.SPP
        xla_img = np.asarray(
            render_chunk(scene, key, jnp.uint32(0), **kw)
        ) / self.SPP
        return pallas_img, xla_img

    def test_finite_and_plausible(self, images):
        pallas_img, _ = images
        assert pallas_img.shape == (self.H, self.W, 3)
        assert np.all(np.isfinite(pallas_img))
        assert pallas_img.max() > 0.0  # the light is visible

    def test_distribution_matches_xla(self, images):
        # Same physics, independent RNG bits: images are two MC estimators
        # of the same integral. Compare whole-image means per channel and
        # 8x8-block means with a tolerance scaled to the sample variance.
        pallas_img, xla_img = images
        for c in range(3):
            a, b = pallas_img[..., c], xla_img[..., c]
            # Whole-image mean: N = W*H*SPP samples on each side.
            sigma = max(a.std(), b.std(), 1e-3) / np.sqrt(a.size * self.SPP)
            assert abs(a.mean() - b.mean()) < 8 * sigma + 5e-3
        # Block means (structure, not just global brightness).
        blk = 8
        pa = pallas_img.reshape(self.H // blk, blk, self.W // blk, blk, 3).mean(
            axis=(1, 3)
        )
        xa = xla_img.reshape(self.H // blk, blk, self.W // blk, blk, 3).mean(
            axis=(1, 3)
        )
        # Pixel values are already means over SPP samples, so the stderr of
        # a blk*blk-pixel block mean is pixel_std / blk. The image is heavy-
        # tailed (the emitter block dominates the variance), so allow 6
        # sigma; measured max deviation at this config is ~4 sigma.
        per_block_sigma = xla_img.std() / blk
        assert np.all(np.abs(pa - xa) < 6 * per_block_sigma + 0.02)

    def test_deterministic(self):
        from cornelis.ops.pallas_integrator import render_chunk_pallas

        scene = compile_scene(cornell_box())
        key = make_key(5)
        kw = dict(
            width=16, height=16, spp_chunk=4, spp_total=4, max_depth=4
        )
        a = np.asarray(
            render_chunk_pallas(scene, key, np.uint32(0), interpret=True, **kw)
        )
        b = np.asarray(
            render_chunk_pallas(scene, key, np.uint32(0), interpret=True, **kw)
        )
        assert np.array_equal(a, b)

    def test_sdf_scene_matches_xla(self):
        # SDF primitives in the megakernel (sphere-traced in-kernel via the
        # shared geometry.sdf_candidate): compare against the XLA wavefront
        # on the sdf-gallery scene.
        from cornelis.ops.pallas_integrator import render_chunk_pallas
        from cornelis.scene.library import sdf_gallery

        scene = compile_scene(sdf_gallery())
        assert scene.num_sdfs > 0
        key = make_key(2)
        W = H = 24
        SPP = 16
        kw = dict(width=W, height=H, spp_chunk=SPP, spp_total=SPP, max_depth=6)
        p = np.asarray(
            render_chunk_pallas(scene, key, np.uint32(0), interpret=True, **kw)
        ) / SPP
        x = np.asarray(render_chunk(scene, key, jnp.uint32(0), **kw)) / SPP
        assert np.all(np.isfinite(p))
        assert p.max() > 0.0
        for c in range(3):
            sigma = max(x[..., c].std(), 1e-3) / np.sqrt(W * H * SPP)
            assert abs(p[..., c].mean() - x[..., c].mean()) < 8 * sigma + 5e-3

    def test_sobol_matches_xla_bitwise_draws(self):
        # In sobol mode both backends run sampling.py's exact pipeline with
        # identical (pixel_seed, sample, stream) keys, so the rendered
        # images agree to float tolerance (only op-fusion order differs).
        from cornelis.ops.pallas_integrator import render_chunk_pallas

        scene = compile_scene(cornell_box())
        key = make_key(9)
        kw = dict(width=16, height=16, spp_chunk=8, spp_total=8, max_depth=4)
        p = np.asarray(
            render_chunk_pallas(
                scene, key, np.uint32(0), interpret=True, sampler="sobol", **kw
            )
        )
        x = np.asarray(
            render_chunk(scene, key, jnp.uint32(0), sampler="sobol", **kw)
        )
        np.testing.assert_allclose(p, x, rtol=1e-4, atol=1e-4)

    def test_sample_offset_extends_stream(self):
        # Chunk (0..4) + chunk (4..8) must equal one chunk (0..8): the same
        # accumulation contract as the XLA path (sums over disjoint sample
        # ranges add).
        from cornelis.ops.pallas_integrator import render_chunk_pallas

        scene = compile_scene(cornell_box())
        key = make_key(5)
        kw = dict(width=16, height=16, spp_total=8, max_depth=4)
        a = np.asarray(
            render_chunk_pallas(
                scene, key, np.uint32(0), spp_chunk=4, interpret=True, **kw
            )
        )
        b = np.asarray(
            render_chunk_pallas(
                scene, key, np.uint32(4), spp_chunk=4, interpret=True, **kw
            )
        )
        full = np.asarray(
            render_chunk_pallas(
                scene, key, np.uint32(0), spp_chunk=8, interpret=True, **kw
            )
        )
        assert np.allclose(a + b, full, rtol=1e-5, atol=1e-5)


class TestMegakernelNEE:
    def test_nee_sobol_matches_xla_bitwise_draws(self):
        # NEE + MIS in-kernel, sobol draws bit-shared with the XLA path:
        # interpret-mode images agree to float tolerance.
        from cornelis.ops.pallas_integrator import render_chunk_pallas

        scene = compile_scene(cornell_box())
        key = make_key(4)
        kw = dict(width=16, height=16, spp_chunk=8, spp_total=8, max_depth=4)
        p = np.asarray(
            render_chunk_pallas(
                scene, key, np.uint32(0), interpret=True,
                sampler="sobol", mode="nee", **kw,
            )
        )
        x = np.asarray(
            render_chunk(
                scene, key, jnp.uint32(0), sampler="sobol", mode="nee", **kw
            )
        )
        np.testing.assert_allclose(p, x, rtol=1e-4, atol=1e-4)

    def test_nee_uniform_distribution(self):
        # Different RNG bits (threefry vs jax.random), same estimator:
        # distributional agreement.
        from cornelis.ops.pallas_integrator import render_chunk_pallas

        scene = compile_scene(cornell_box())
        key = make_key(6)
        W = H = 24
        SPP = 24
        kw = dict(width=W, height=H, spp_chunk=SPP, spp_total=SPP, max_depth=6)
        p = np.asarray(
            render_chunk_pallas(
                scene, key, np.uint32(0), interpret=True, mode="nee", **kw
            )
        ) / SPP
        x = np.asarray(
            render_chunk(scene, key, jnp.uint32(0), mode="nee", **kw)
        ) / SPP
        assert np.all(np.isfinite(p))
        for c in range(3):
            sigma = max(x[..., c].std(), 1e-3) / np.sqrt(W * H * SPP)
            assert abs(p[..., c].mean() - x[..., c].mean()) < 8 * sigma + 5e-3


class TestMegakernelPlaneLights:
    def test_mixed_lights_parity_with_xla(self):
        # Round-4 plane-emitter NEE: the kernel's kind-aware light table
        # (sphere cone + plane area branches, unified prim index for the
        # MIS pickup weights) must match the XLA path bitwise-close on
        # shared sobol draws -- a scene with BOTH emitter kinds exercises
        # selection, both sample branches, and both pickup weights.
        import os
        import sys

        sys.path.insert(0, os.path.dirname(__file__))
        from test_nee import _panel_scene

        from cornelis.ops.pallas_integrator import render_chunk_pallas

        scene = compile_scene(_panel_scene(with_sphere_light=True))
        key = make_key(3)
        kw = dict(width=24, height=24, spp_chunk=16, spp_total=16,
                  max_depth=6, sampler="sobol", mode="nee")
        p = np.asarray(
            render_chunk_pallas(scene, key, np.uint32(0), interpret=True, **kw)
        )
        x = np.asarray(render_chunk(scene, key, jnp.uint32(0), **kw))
        np.testing.assert_allclose(p, x, rtol=1e-4, atol=1e-4)
