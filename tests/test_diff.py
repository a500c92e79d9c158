"""Differentiable-mode tests: finite-difference gradient checks (common
random numbers make the FD low-variance) and a small inverse-render
recovery. SURVEY.md section 7 step 10.

DEPTH is capped at 4: the reference's Russian-roulette schedule multiplies
surviving dim paths by up to 1/0.05 per bounce past depth 3 (Render.cpp:
153-165), so deeper traces produce fireflies whose kill boundary can fall
inside the FD window -- one flipping 17.9-radiance pixel was measured
swinging the 24x24 FD by 2x (round 3). The gradient itself was verified
correct against the FD in both jvp and vjp modes; only the FD *test*
needs firefly-free windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.diff import InverseRenderer, apply_params, extract_params, render_diff
from cornelis.math.vec import Vec3
from cornelis.scene.compile import compile_scene
from cornelis.scene.library import cornell_box, sphere_on_plane

W = H = 24
SPP = 24
DEPTH = 4  # keeps RR fireflies small: FD windows must not straddle big kill-boundary jumps (see test docstring)


@pytest.fixture(scope="module")
def scene():
    return compile_scene(cornell_box())


FLOAT_FIELDS = (
    "mat_albedo",
    "mat_emission",
    "mat_tint",
    "mat_roughness",
    "sphere_center",
    "sphere_radius",
    "plane_point",
)


def _mean_intensity(scene, key, detach=True, mode="path"):
    img = render_diff(
        scene,
        key,
        width=W,
        height=H,
        spp=SPP,
        max_depth=DEPTH,
        detach=detach,
        mode=mode,
    )
    return jnp.mean(img)


def _grad_wrt_floats(scene, key, detach=True, mode="path"):
    """Gradient over the float scene fields only (material ids are int32 and
    non-differentiable by construction)."""
    fields = {f: getattr(scene, f) for f in FLOAT_FIELDS}

    def fn(fields):
        return _mean_intensity(scene._replace(**fields), key, detach, mode)

    return jax.grad(fn)(fields)


class TestFiniteDifference:
    """Directional-derivative checks: same key on both sides of the FD (the
    estimator is deterministic given the key, so FD error is O(eps^2) plus
    float32 noise, not MC noise)."""

    def _check_field(
        self,
        scene,
        field,
        component,
        index,
        eps,
        rtol,
        atol=2e-4,
        detach=True,
        mode="path",
    ):
        key = jax.random.key(5)

        def perturbed(delta):
            value = getattr(scene, field)
            if component is None:
                new = value.at[index].add(delta)
            else:
                new = value._replace(
                    **{component: getattr(value, component).at[index].add(delta)}
                )
            return scene._replace(**{field: new})

        grads = _grad_wrt_floats(scene, key, detach, mode)
        g_struct = grads[field]
        g = (
            g_struct[index]
            if component is None
            else getattr(g_struct, component)[index]
        )

        f_plus = _mean_intensity(perturbed(+eps), key, detach, mode)
        f_minus = _mean_intensity(perturbed(-eps), key, detach, mode)
        fd = (f_plus - f_minus) / (2 * eps)
        assert np.isfinite(float(g)), f"grad not finite for {field}"
        np.testing.assert_allclose(float(g), float(fd), rtol=rtol, atol=atol)

    def test_albedo_gradient(self, scene):
        # Material 1 = white walls/floor in the Cornell scene: large effect.
        self._check_field(scene, "mat_albedo", "x", 1, eps=1e-2, rtol=0.05)

    def test_emission_gradient(self, scene):
        # Light material emission: the image is linear in it along direct
        # paths, so FD is extremely clean.
        emissive = int(np.argmax(np.asarray(scene.mat_emission.x)))
        self._check_field(
            scene, "mat_emission", "x", emissive, eps=1e-2, rtol=0.05
        )

    def test_roughness_gradient(self, scene):
        # Roughness moves the sampled directions themselves, so FD (which
        # perturbs the sampler) only matches the *attached* pathwise
        # estimator -- the detached default deliberately drops that term.
        # eps must stay below the discontinuity scale (RR kill boundaries
        # and below-horizon flips shift with roughness; at eps = 5e-3 the
        # FD is dominated by those jumps -- measured convergence:
        # eps 5e-3 -> -0.323, 1e-3 -> -0.061, 2e-4 -> +0.0705 = grad).
        self._check_field(
            scene, "mat_roughness", None, 1, eps=2e-4, rtol=0.05, atol=5e-4,
            detach=False,
        )

    def test_sphere_radius_gradient(self, scene):
        # Geometry gradient (interior shading term only; silhouettes are
        # discontinuous and excluded by the mean over many pixels).
        self._check_field(scene, "sphere_radius", None, 0, eps=1e-3, rtol=0.25, atol=2e-3)


class TestNeeGradients:
    """Differentiable NEE (round 5, VERDICT r4 #2): the diff mode can now
    use the low-variance next-event estimator. Detached light sampling --
    the sampled light direction/distance/density are stop_gradiented,
    gradients flow through the BRDF, emission, cosine, and MIS weights
    (integrator._bounce)."""

    def test_albedo_fd(self, scene):
        # Albedo does not steer any sampler except through the (detached)
        # RR probability, so the detached NEE gradient matches FD to the
        # same tolerance as path mode.
        self._check = TestFiniteDifference._check_field
        self._check(
            self, scene, "mat_albedo", "x", 1, eps=1e-2, rtol=0.05, mode="nee"
        )

    def test_emission_fd(self, scene):
        # Emission enters the NEE term through light_le AND the MIS weights
        # (via the light-selection pdf: Cornell has one emitter, so the
        # selection is constant and the FD is clean).
        emissive = int(np.argmax(np.asarray(scene.mat_emission.x)))
        self._check = TestFiniteDifference._check_field
        self._check(
            self,
            scene,
            "mat_emission",
            "x",
            emissive,
            eps=1e-2,
            rtol=0.05,
            mode="nee",
        )

    def test_roughness_fd_attached(self, scene):
        # Fully-attached NEE estimator (detach=False): gradients flow
        # through the GGX inverse-CDF AND the light sampling, so the grad
        # must equal FD of this exact function (same eps rationale as the
        # path-mode twin above).
        self._check = TestFiniteDifference._check_field
        self._check(
            self,
            scene,
            "mat_roughness",
            None,
            1,
            eps=2e-4,
            rtol=0.05,
            atol=5e-4,
            detach=False,
            mode="nee",
        )

    def test_grads_flow_and_finite(self, scene):
        grads = _grad_wrt_floats(scene, jax.random.key(1), mode="nee")
        assert float(jnp.abs(grads["mat_albedo"].x).sum()) > 0
        assert float(jnp.abs(grads["mat_emission"].x).sum()) > 0
        assert float(jnp.abs(grads["mat_roughness"]).sum()) > 0
        for leaf in jax.tree.leaves(grads):
            assert np.all(np.isfinite(np.asarray(leaf))), "NaN/inf in grads"

    def test_nee_gradient_variance_below_path(self, scene):
        # The whole point: at equal spp, NEE's albedo gradient over
        # independent keys has (much) lower empirical variance than path
        # mode's on the small-emitter Cornell scene. A loose 2x bound --
        # the measured ratio is far larger (PERF.md 2b) -- keeps the test
        # noise-proof.
        def grad_samples(mode, n=6):
            gs = []
            for s in range(n):
                g = _grad_wrt_floats(scene, jax.random.key(100 + s), mode=mode)
                gs.append(float(g["mat_albedo"].x[1]))
            return np.asarray(gs)

        v_path = grad_samples("path").var()
        v_nee = grad_samples("nee").var()
        assert v_nee < v_path / 2.0, (v_path, v_nee)


class TestGatherVJPEquivalence:
    def test_matmul_transpose_gather_matches_scatter_gather_grads(self, scene):
        # materials._take_rows swaps jnp.take's scatter-add transpose for
        # a one-hot matmul reduction (5.7x faster diff step on the H100,
        # PERF.md). The estimator is
        # IDENTICAL: on common draws, gradients through the custom rule
        # must match gradients through plain jnp.take to float-sum
        # reordering tolerance.
        import cornelis.materials as materials

        key = jax.random.key(11)
        g_custom = _grad_wrt_floats(scene, key)
        orig = materials._take_rows
        materials._take_rows = lambda table, ids: jnp.take(table, ids, axis=0)
        try:
            g_plain = _grad_wrt_floats(scene, key)
        finally:
            materials._take_rows = orig
        for leaf_c, leaf_p in zip(
            jax.tree.leaves(g_custom), jax.tree.leaves(g_plain)
        ):
            np.testing.assert_allclose(
                np.asarray(leaf_c), np.asarray(leaf_p), rtol=1e-4, atol=1e-6
            )


class TestGradientSanity:
    def test_grads_flow_to_all_material_leaves(self, scene):
        key = jax.random.key(1)
        grads = _grad_wrt_floats(scene, key)
        assert float(jnp.abs(grads["mat_albedo"].x).sum()) > 0
        assert float(jnp.abs(grads["mat_emission"].x).sum()) > 0
        assert float(jnp.abs(grads["mat_roughness"]).sum()) > 0
        for leaf in jax.tree.leaves(grads):
            assert np.all(np.isfinite(np.asarray(leaf))), "NaN/inf in grads"


class TestInverseRender:
    def test_recovers_albedo(self):
        # Ground truth scene; corrupt the sphere albedo; recover it.
        true_scene = compile_scene(sphere_on_plane())
        key = jax.random.key(9)
        # The target must be much cleaner than the per-step renders: with a
        # noisy single-render target the loss landscape's true minimum
        # genuinely shifts away from the ground-truth parameters (measured:
        # a 24-spp target moves the sphere-albedo optimum from 0.6 to
        # ~0.35; 192 spp brings it back to ~0.55-0.6).
        target = render_diff(
            true_scene, key, width=W, height=H, spp=192, max_depth=DEPTH
        )

        corrupted = true_scene._replace(
            mat_albedo=Vec3(
                true_scene.mat_albedo.x * 0.3 + 0.1,
                true_scene.mat_albedo.y * 0.5 + 0.3,
                true_scene.mat_albedo.z * 0.2 + 0.5,
            )
        )
        inv = InverseRenderer(
            corrupted,
            target,
            fields=("mat_albedo",),
            width=W,
            height=H,
            spp=SPP,
            max_depth=DEPTH,
            learning_rate=0.1,
            seed=3,
            key_strategy="dual",  # naive MSE is variance-biased, see make_loss
        )
        inv.run(250)

        rec = inv.scene()

        # Only the *visible* materials are identifiable: 0 is the unused
        # default (zero gradient) and 3 is the light, whose albedo has no
        # visible effect (emission dominates), so Adam random-walks it.
        # Measure the sphere (1) and plane (2) albedos over all channels.
        vis = slice(1, 3)

        def err(scene_albedo):
            total = 0.0
            for c in "xyz":
                t = np.asarray(getattr(true_scene.mat_albedo, c))[vis]
                v = np.asarray(getattr(scene_albedo, c))[vis]
                total += np.abs(v - t).mean()
            return total / 3

        err0 = err(corrupted.mat_albedo)
        err1 = err(rec.mat_albedo)
        assert err1 < 0.6 * err0, (err0, err1)

    def test_extract_apply_roundtrip(self):
        scene = compile_scene(cornell_box())
        params = extract_params(scene, ("mat_albedo", "mat_roughness", "sphere_center"))
        back = apply_params(scene, params)
        np.testing.assert_allclose(
            np.asarray(back.mat_albedo.x),
            np.asarray(scene.mat_albedo.x),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(back.mat_roughness),
            np.asarray(scene.mat_roughness),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(back.sphere_center.x),
            np.asarray(scene.sphere_center.x),
            atol=0,
        )

    def test_rejects_unknown_field(self):
        scene = compile_scene(cornell_box())
        with pytest.raises(ValueError, match="not optimizable"):
            extract_params(scene, ("mat_ior",))


class TestLossWeight:
    def test_weight_masks_corrupted_pixels(self):
        # 8-bit-recovered targets clip at 1.0 while the render produces
        # physical radiance (~15 on an emitter) -- the weight mask is how
        # inverse rendering from PNG targets stays sane (round-4 fix:
        # unweighted optimization against the committed golden had a 3.9
        # loss floor from the clipped light disc and diverged). Masked
        # pixels must contribute NOTHING: corrupting them must not change
        # the loss.
        from cornelis.diff.inverse import extract_params, make_loss

        scene = compile_scene(sphere_on_plane())
        W = H = 16
        key = jax.random.key(5)
        target = np.asarray(render_diff(scene, key, width=W, height=H, spp=4, max_depth=3))
        corrupted = target.copy()
        corrupted[:4, :4] = 100.0  # "clipped emitter" region, wildly off
        weight = np.ones((H, W), np.float32)
        weight[:4, :4] = 0.0

        params = extract_params(scene, ("mat_albedo",))
        kw = dict(width=W, height=H, spp=4, max_depth=3, key_strategy="fixed")
        clean = make_loss(scene, jnp.asarray(target), weight=jnp.asarray(weight), **kw)
        dirty = make_loss(scene, jnp.asarray(corrupted), weight=jnp.asarray(weight), **kw)
        lc = float(clean(params, key))
        ld = float(dirty(params, key))
        assert lc == ld, f"masked corruption leaked into the loss: {lc} vs {ld}"
        # And the unweighted loss DOES see the corruption (sanity).
        plain = make_loss(scene, jnp.asarray(corrupted), **kw)
        assert float(plain(params, key)) > ld + 1.0
