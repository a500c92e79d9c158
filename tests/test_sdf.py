"""Implicit (SDF / level-set) surface tests.

The reference stages NanoVDB level sets as a future milestone (README
Milestone 6; the vendored grid machinery is unused). Our sphere-traced
analytic SDFs stand in for it (BASELINE.json config 5); these tests pin the
distance fields, the march, normals, closest-hit integration with the
analytic kernels, and an end-to-end render.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cornelis.geometry import (
    SDF_KIND_BOX,
    SDF_KIND_SPHERE,
    SDF_KIND_TORUS,
    intersect_scene,
    sdf_candidate,
    sdf_distance,
    sphere_candidate,
)
from cornelis.math.vec import Vec3
from cornelis.scene.compile import compile_scene
from cornelis.scene.description import (
    SceneDescription,
    SDFDescription,
    SphereDescription,
)
from cornelis.scene.library import sdf_gallery


def _vec(*rows):
    a = np.asarray(rows, np.float32)
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def _params(*vals):
    return jnp.asarray(tuple(vals) + (0.0,) * (4 - len(vals)), jnp.float32)


class TestDistanceFields:
    def test_sphere_distance(self):
        q = _vec([3.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        d = np.asarray(sdf_distance(SDF_KIND_SPHERE, _params(1.0), q))
        assert np.allclose(d, [2.0, -1.0, 0.0], atol=1e-6)

    def test_box_distance(self):
        q = _vec([2.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 1.0, 0.0], [2.0, 2.0, 0.0])
        d = np.asarray(sdf_distance(SDF_KIND_BOX, _params(1.0, 1.0, 1.0), q))
        assert np.allclose(d[0], 1.0, atol=1e-6)  # one unit outside +x face
        assert np.allclose(d[1], -1.0, atol=1e-6)  # center, unit half-extent
        assert np.allclose(d[2], 0.0, atol=1e-6)  # on the edge
        assert np.allclose(d[3], np.sqrt(2.0), atol=1e-6)  # corner diagonal

    def test_torus_distance(self):
        # Major radius 2, tube radius 0.5, axis = local y.
        q = _vec([2.0, 0.0, 0.0], [0.0, 0.0, 0.0], [2.5, 0.0, 0.0], [0.0, 2.0, 0.0])
        d = np.asarray(sdf_distance(SDF_KIND_TORUS, _params(2.0, 0.5), q))
        assert np.allclose(d[0], -0.5, atol=1e-6)  # tube center
        assert np.allclose(d[1], 1.5, atol=1e-6)  # hole center
        assert np.allclose(d[2], 0.0, atol=1e-6)  # outer surface
        assert np.allclose(d[3], np.sqrt(8.0) - 0.5, atol=1e-6)  # above axis


class TestSphereTrace:
    def test_sdf_sphere_matches_analytic_sphere(self):
        o = _vec([0.0, 0.0, -5.0], [0.3, -0.2, -5.0], [0.0, 3.0, -5.0])
        d = _vec([0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0])
        center = Vec3(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
        t_sdf, p_sdf, n_sdf, v_sdf = sdf_candidate(
            o, d, SDF_KIND_SPHERE, center, _params(1.0)
        )
        t_ref, p_ref, n_ref, v_ref = sphere_candidate(o, d, center, jnp.float32(1.0))
        assert np.array_equal(np.asarray(v_sdf), np.asarray(v_ref))
        hit = np.asarray(v_ref)
        assert np.allclose(
            np.asarray(t_sdf)[hit], np.asarray(t_ref)[hit], rtol=5e-3, atol=1e-3
        )
        for a, b in ((n_sdf.x, n_ref.x), (n_sdf.y, n_ref.y), (n_sdf.z, n_ref.z)):
            assert np.allclose(np.asarray(a)[hit], np.asarray(b)[hit], atol=5e-3)

    def test_non_normalized_direction_t_parameterization(self):
        o = _vec([0.0, 0.0, -5.0])
        d = _vec([0.0, 0.0, 2.0])  # length 2: t should be half the distance
        center = Vec3(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
        t, _, _, valid = sdf_candidate(o, d, SDF_KIND_SPHERE, center, _params(1.0))
        assert bool(np.asarray(valid)[0])
        assert abs(float(np.asarray(t)[0]) - 2.0) < 5e-3

    def test_box_face_hit_and_normal(self):
        o = _vec([-5.0, 0.2, 0.1])
        d = _vec([1.0, 0.0, 0.0])
        center = Vec3(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
        t, p, n, valid = sdf_candidate(o, d, SDF_KIND_BOX, center, _params(1.0, 1.0, 1.0))
        assert bool(np.asarray(valid)[0])
        assert abs(float(np.asarray(t)[0]) - 4.0) < 5e-3
        assert abs(float(np.asarray(n.x)[0]) + 1.0) < 1e-2  # -x face normal

    def test_torus_hole_miss(self):
        # Straight through the hole along the axis: no hit.
        o = _vec([0.0, -5.0, 0.0])
        d = _vec([0.0, 1.0, 0.0])
        center = Vec3(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
        t, _, _, valid = sdf_candidate(o, d, SDF_KIND_TORUS, center, _params(2.0, 0.5))
        assert not bool(np.asarray(valid)[0])
        assert np.isinf(np.asarray(t)[0])

    def test_degenerate_ray_misses(self):
        o = _vec([0.0, 0.0, -5.0])
        d = _vec([0.0, 0.0, 0.0])
        center = Vec3(jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0))
        _, _, _, valid = sdf_candidate(o, d, SDF_KIND_SPHERE, center, _params(1.0))
        assert not bool(np.asarray(valid)[0])


class TestSceneIntegration:
    def test_closest_hit_across_kinds(self):
        # An analytic sphere at z=0 and an SDF box behind it at z=4: rays
        # from -z must report the sphere; rays offset to miss the sphere
        # must report the box.
        scene = SceneDescription()
        m = scene.add_material(__import__("cornelis").MaterialDescription())
        scene.add_sphere(SphereDescription(center=(0.0, 0.0, 0.0), radius=1.0, material=m))
        scene.add_sdf(
            SDFDescription(kind="box", center=(0.0, 0.0, 4.0), params=(3.0, 3.0, 1.0, 0.0))
        )
        arrays = compile_scene(scene)

        o = _vec([0.0, 0.0, -5.0], [2.5, 0.0, -5.0])
        d = _vec([0.0, 0.0, 1.0], [0.0, 0.0, 1.0])
        hit = intersect_scene(arrays, o, d)
        t = np.asarray(hit.t)
        assert bool(np.asarray(hit.hit)[0]) and abs(t[0] - 4.0) < 5e-3  # sphere front
        assert bool(np.asarray(hit.hit)[1]) and abs(t[1] - 8.0) < 5e-2  # box front face

    def test_compile_roundtrip_json(self):
        scene = sdf_gallery()
        clone = SceneDescription.from_json(scene.to_json())
        assert clone.to_dict() == scene.to_dict()
        arrays = compile_scene(clone)
        assert arrays.num_sdfs == 3

    def test_render_smoke(self):
        from cornelis.integrator import render_chunk
        from cornelis.rng import make_key

        arrays = compile_scene(sdf_gallery())
        img = np.asarray(
            render_chunk(
                arrays,
                make_key(1),
                jnp.uint32(0),
                width=24,
                height=24,
                spp_chunk=8,
                spp_total=8,
                max_depth=4,
            )
        )
        assert np.all(np.isfinite(img))
        assert img.mean() > 0  # light reaches the film

    def test_unknown_kind_rejected(self):
        scene = SceneDescription()
        with pytest.raises(ValueError):
            scene.add_sdf(SDFDescription(kind="gyroid"))
