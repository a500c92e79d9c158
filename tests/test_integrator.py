"""Integrator tests: exact bookkeeping cases, chunk invariance, determinism.

These cover the reference's untested Render.cpp surface (integrator, RR,
accumulation) with properties instead of eyeballs."""

import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.integrator import (
    render_chunk,
    russian_roulette_probability,
    trace_paths,
)
from cornelis.math.vec import RGB, Vec3
from cornelis.rng import make_key, ray_keys
from cornelis.scene.compile import compile_scene
from cornelis.scene.description import (
    MaterialDescription,
    PerspectiveCameraDescription,
    SceneDescription,
    SphereDescription,
)
from cornelis.scene.library import sphere_on_plane


def _emissive_sphere_scene():
    scene = SceneDescription()
    scene.set_camera(
        PerspectiveCameraDescription(
            origin=(0.0, 0.0, -5.0), look_at=(0.0, 0.0, 0.0), aspect=1.0, horizontal_fov=0.5
        )
    )
    light = scene.add_material(
        MaterialDescription(albedo=(0, 0, 0), emissive=(15.0, 15.0, 15.0))
    )
    scene.add_sphere(SphereDescription(center=(0.0, 0.0, 0.0), radius=2.0, material=light))
    return compile_scene(scene)


class TestRussianRoulette:
    def test_young_paths_survive(self):
        # depth < 3 -> 0.99 regardless of throughput (Render.cpp:157-158).
        thr = RGB(jnp.zeros(4), jnp.zeros(4), jnp.zeros(4))
        p = russian_roulette_probability(thr, jnp.int32(0))
        assert np.allclose(np.asarray(p), 0.99)

    def test_old_paths_clamped(self):
        # depth >= 3: 0.55 * clamp(mag2(T), 0.05/0.55, 0.99) (Render.cpp:159-164).
        thr = RGB(jnp.array([0.0, 10.0, 0.5]), jnp.zeros(3), jnp.zeros(3))
        p = np.asarray(russian_roulette_probability(thr, jnp.int32(3)))
        assert p[0] == pytest.approx(0.05)  # clamped low
        assert p[1] == pytest.approx(0.55 * 0.99)  # clamped high
        assert p[2] == pytest.approx(0.55 * 0.25)  # mag2 = 0.25


class TestTracePaths:
    def test_direct_emission_exact(self):
        # A black-albedo emissive surface contributes its emission exactly
        # once: throughput dies (f = 0) after the first bounce.
        scene = _emissive_sphere_scene()
        n = 64
        o = Vec3(jnp.zeros(n), jnp.zeros(n), jnp.full((n,), -5.0))
        d = Vec3(jnp.zeros(n), jnp.zeros(n), jnp.ones(n))
        keys = ray_keys(make_key(1), jnp.arange(n, dtype=jnp.uint32))
        rad = trace_paths(scene, o, d, keys, max_depth=8)
        assert np.allclose(np.asarray(rad.x), 15.0, atol=1e-4)
        assert np.allclose(np.asarray(rad.y), 15.0, atol=1e-4)

    def test_miss_is_black(self):
        scene = _emissive_sphere_scene()
        n = 8
        o = Vec3(jnp.zeros(n), jnp.zeros(n), jnp.full((n,), -5.0))
        d = Vec3(jnp.zeros(n), jnp.ones(n), jnp.zeros(n))  # straight up: miss
        keys = ray_keys(make_key(1), jnp.arange(n, dtype=jnp.uint32))
        rad = trace_paths(scene, o, d, keys, max_depth=8)
        assert np.allclose(np.asarray(rad.x), 0.0)

    def test_unroll_matches_whileloop(self):
        scene = compile_scene(sphere_on_plane())
        n = 128
        o = Vec3(jnp.zeros(n), jnp.full((n,), 2.0), jnp.full((n,), -8.0))
        d = Vec3(jnp.zeros(n), jnp.full((n,), -0.12), jnp.ones(n))
        from cornelis.math.vec import normalize

        d = normalize(d)
        keys = ray_keys(make_key(3), jnp.arange(n, dtype=jnp.uint32))
        r_while = trace_paths(scene, o, d, keys, max_depth=6)
        r_fori = trace_paths(scene, o, d, keys, max_depth=6, unroll_bounces=True)
        assert np.allclose(np.asarray(r_while.x), np.asarray(r_fori.x), atol=1e-5)


class TestRenderChunk:
    W = H = 16

    def _chunk(self, scene, offset, spp_chunk, spp_total=8, seed=5):
        return np.asarray(
            render_chunk(
                scene,
                make_key(seed),
                np.uint32(offset),
                width=self.W,
                height=self.H,
                spp_chunk=spp_chunk,
                spp_total=spp_total,
                max_depth=8,
            )
        )

    def test_smoke_finite_nonzero(self):
        scene = compile_scene(sphere_on_plane())
        img = self._chunk(scene, 0, 4)
        assert img.shape == (self.H, self.W, 3)
        assert np.all(np.isfinite(img))
        assert img.max() > 0.0

    def test_chunk_invariance(self):
        # Counter-based RNG: 8 spp in one dispatch == 2 dispatches of 4,
        # up to float summation order. The reference can only promise this
        # per-tile (Tiles.hpp:22-31); we get it per-sample.
        scene = compile_scene(sphere_on_plane())
        whole = self._chunk(scene, 0, 8)
        parts = self._chunk(scene, 0, 4) + self._chunk(scene, 4, 4)
        assert np.allclose(whole, parts, rtol=1e-4, atol=1e-4)

    def test_seed_determinism(self):
        scene = compile_scene(sphere_on_plane())
        a = self._chunk(scene, 0, 4, seed=7)
        b = self._chunk(scene, 0, 4, seed=7)
        c = self._chunk(scene, 0, 4, seed=8)
        assert np.array_equal(a, b)
        assert not np.array_equal(a, c)

    def test_emissive_camera_view(self):
        # Center pixels look straight at the light sphere: exactly 15 per
        # sample after averaging.
        scene = _emissive_sphere_scene()
        img = self._chunk(scene, 0, 4)
        center = img[self.H // 2, self.W // 2] / 4
        assert np.allclose(center, 15.0, atol=1e-3)


def check_depth_rules(rule: str) -> None:
    """The depth-guarded integrator rules under a jitted lax.fori_loop with
    an int32 bounce counter -- the loop form of the diff path
    (trace_paths(unroll_bounces=True)). Shared by the CPU test below and
    its `gpu`-marked twin in test_gpu.py."""
    import jax

    from cornelis.diff import render_diff
    from cornelis.integrator import (
        RR_BASE,
        nee_clamp_at_depth,
        russian_roulette_probability,
    )

    depths = 6
    if rule == "nee_direct_emitter":
        # Depth 0 sees the emitter: MIS weight 1, no clamp -- the pixel is
        # exactly L_e (a depth test taking the depth > 0 branch at depth 0
        # would scale it by the MIS weight).
        img = render_diff(_emissive_sphere_scene(), make_key(1), width=8,
                          height=8, spp=2, max_depth=4, mode="nee")
        np.testing.assert_allclose(np.asarray(img)[4, 4], 15.0, rtol=1e-5)
        return

    thru = RGB(jnp.full(2, 0.1), jnp.full(2, 0.1), jnp.full(2, 0.1))

    def body(i, carry):
        depth, out = carry
        if rule == "rr_schedule":
            v = russian_roulette_probability(thru, depth)[0]
        else:
            v = nee_clamp_at_depth(2.0, depth)
        return depth + 1, out.at[i].set(v)

    _, got = jax.jit(lambda: jax.lax.fori_loop(
        0, depths, body, (jnp.int32(0), jnp.zeros(depths, jnp.float32))
    ))()
    d = np.arange(depths)
    if rule == "rr_schedule":
        # 0.99 while young (depth < 3), then 0.55 * clip(|T|^2 = 0.03).
        want = np.where(d < 3, 0.99, RR_BASE * (0.05 / RR_BASE))
    else:
        want = 2.0 * (1.0 / RR_BASE) ** np.maximum(d - 3, 0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5)


@pytest.mark.parametrize(
    "rule", ["rr_schedule", "clamp_schedule", "nee_direct_emitter"]
)
def test_depth_rules_in_fori_loop(rule):
    check_depth_rules(rule)
