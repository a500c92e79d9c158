"""Intersection kernel tests.

Ports the reference's case matrix (tests/test_Geometry.cpp:20-239) to the
masked wavefront design: two-root hit, double root with non-normalized
direction, miss, degenerate zero-direction ray, and closest-hit semantics.
The reference's "inactive ray" case maps to the integrator's active mask
(kernels here intersect every lane; masking happens in the bounce loop)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.geometry import (
    intersect_scene,
    plane_candidate,
    sphere_candidate,
)
from cornelis.math.vec import Vec3, vec3
from cornelis.scene.compile import compile_scene
from cornelis.scene.description import (
    PlaneDescription,
    SceneDescription,
    SphereDescription,
)


def rays(origins, dirs):
    o = np.array(origins, np.float32)
    d = np.array(dirs, np.float32)
    return (
        Vec3(jnp.array(o[:, 0]), jnp.array(o[:, 1]), jnp.array(o[:, 2])),
        Vec3(jnp.array(d[:, 0]), jnp.array(d[:, 1]), jnp.array(d[:, 2])),
    )


class TestSphere:
    def test_case_matrix(self):
        # Unit sphere at origin; mirrors test_Geometry.cpp's ray set.
        o, d = rays(
            [
                [0, 0, -3],  # two-root hit along +z
                [0, 0, -4],  # tangent-ish double root with non-normalized dir
                [0, 5, -3],  # miss
                [0, 0, -3],  # degenerate zero-direction ray
            ],
            [
                [0, 0, 1],
                [0, 0, 2],  # non-normalized: A = 4
                [0, 0, 1],
                [0, 0, 0],
            ],
        )
        center = vec3(0.0, 0.0, 0.0)
        t, p, n, valid = sphere_candidate(o, d, center, jnp.float32(1.0))
        t = np.asarray(t)
        valid = np.asarray(valid)

        assert valid[0] and t[0] == pytest.approx(2.0, abs=1e-3)
        # Non-normalized dir: param t halves (t=1.5 covers distance 3).
        assert valid[1] and t[1] == pytest.approx(1.5, abs=1e-3)
        assert not valid[2] and np.isinf(t[2])
        assert not valid[3] and np.isinf(t[3])

        # Hit point & outward normal for ray 0.
        assert float(p.z[0]) == pytest.approx(-1.0, abs=1e-3)
        assert float(n.z[0]) == pytest.approx(-1.0, abs=1e-3)

    def test_behind_origin(self):
        # Sphere fully behind the ray: both roots negative -> inf.
        o, d = rays([[0, 0, 5]], [[0, 0, 1]])
        t, _, _, valid = sphere_candidate(o, d, vec3(0.0, 0.0, 0.0), jnp.float32(1.0))
        assert not bool(valid[0])

    def test_origin_inside(self):
        # Origin inside: nearest positive root is the exit point.
        o, d = rays([[0, 0, 0]], [[0, 0, 1]])
        t, _, n, valid = sphere_candidate(o, d, vec3(0.0, 0.0, 0.0), jnp.float32(1.0))
        assert bool(valid[0]) and float(t[0]) == pytest.approx(1.0, abs=1e-3)


class TestPlane:
    def test_hit_and_extents(self):
        # Finite 2x2 plane at origin, normal +y (test_Geometry.cpp plane set).
        o, d = rays(
            [
                [0, 1, 0],  # straight down -> hit at t=1
                [5, 1, 0],  # outside extents -> miss
                [0, 1, 0],  # parallel -> miss
                [0, -1, 0],  # below, pointing down -> t negative -> miss
            ],
            [
                [0, -1, 0],
                [0, -1, 0],
                [1, 0, 0],
                [0, -1, 0],
            ],
        )
        t, p, n, valid = plane_candidate(
            o,
            d,
            vec3(0.0, 1.0, 0.0),
            vec3(0.0, 0.0, 0.0),
            jnp.float32(2.0),
            jnp.float32(2.0),
        )
        valid = np.asarray(valid)
        t = np.asarray(t)
        assert valid[0] and t[0] == pytest.approx(1.0, abs=1e-3)
        assert not valid[1]
        assert not valid[2]
        assert not valid[3]

    def test_extents_boundary(self):
        # |(p - anchor) . T| * 2 > width is a strict test: the exact edge hits.
        o, d = rays([[0.999, 1, 0], [1.001, 1, 0]], [[0, -1, 0], [0, -1, 0]])
        _, _, _, valid = plane_candidate(
            o,
            d,
            vec3(0.0, 1.0, 0.0),
            vec3(0.0, 0.0, 0.0),
            jnp.float32(2.0),
            jnp.float32(2.0),
        )
        assert bool(valid[0])
        assert not bool(valid[1])


class TestClosestHit:
    def _scene(self):
        scene = SceneDescription()
        scene.add_sphere(SphereDescription(center=(0, 0, 5), radius=1, material=None))
        scene.add_sphere(SphereDescription(center=(0, 0, 10), radius=1, material=None))
        scene.add_plane(
            PlaneDescription(
                normal=(0, 0, -1), point=(0, 0, 20), extents=(100, 100, 0)
            )
        )
        return compile_scene(scene)

    def test_nearest_wins(self):
        arrays = self._scene()
        o, d = rays([[0, 0, 0]], [[0, 0, 1]])
        hit = intersect_scene(arrays, o, d)
        assert bool(hit.hit[0])
        assert float(hit.t[0]) == pytest.approx(4.0, abs=1e-3)
        assert float(hit.normal.z[0]) == pytest.approx(-1.0, abs=1e-3)

    def test_plane_when_spheres_missed(self):
        arrays = self._scene()
        o, d = rays([[3, 0, 0]], [[0, 0, 1]])
        hit = intersect_scene(arrays, o, d)
        assert bool(hit.hit[0])
        assert float(hit.t[0]) == pytest.approx(20.0, abs=1e-3)

    def test_all_miss(self):
        arrays = self._scene()
        o, d = rays([[0, 0, 0]], [[0, 1, 0]])
        hit = intersect_scene(arrays, o, d)
        assert not bool(hit.hit[0])
        assert np.isinf(float(hit.t[0]))

    def test_closer_previous_semantics(self):
        # Mixed wavefront: each lane independently keeps its nearest hit.
        arrays = self._scene()
        o, d = rays([[0, 0, 0], [0, 0, 7]], [[0, 0, 1], [0, 0, 1]])
        hit = intersect_scene(arrays, o, d)
        # Lane 0 hits sphere 1 at t=4; lane 1 starts past it, hits sphere 2
        # at t=2.
        assert float(hit.t[0]) == pytest.approx(4.0, abs=1e-3)
        assert float(hit.t[1]) == pytest.approx(2.0, abs=1e-3)

    def test_empty_scene(self):
        arrays = compile_scene(SceneDescription())
        o, d = rays([[0, 0, 0]], [[0, 0, 1]])
        hit = intersect_scene(arrays, o, d)
        assert not bool(hit.hit[0])


class TestSelfIntersectionGuard:
    """Scale-aware minimum hit distance (geometry.T_MIN_SCALE).

    Float32 hit positions round by ulp(coordinate / ray length); once that
    exceeds the reference's absolute 1e-4 bounce offset (coordinates or ray
    lengths ~1000+), a bounced ray can start BEHIND its own surface and the
    closest hit finds the same surface at t ~ 0. Measured in round 3:
    27% of Cornell back-wall light-cone rays self-intersected, losing ~15%
    of the region's radiance vs the reference renderer and carving
    iso-rounding rings into the wall. These tests pin the guard.
    """

    def test_overshot_origin_does_not_self_hit_plane(self):
        from cornelis.geometry import plane_candidate
        from cornelis.math.vec import vec3

        # The measured failure shape: a bounce origin that f32 rounding
        # placed 2e-5 BEHIND the Cornell back wall (plane z=275, normal -z),
        # heading back into the room. Without the guard this hits the wall
        # it just left at t ~ 2.6e-5.
        import jax.numpy as jnp

        from cornelis.math.vec import Vec3

        o = Vec3(jnp.array([-179.0]), jnp.array([509.7]), jnp.array([275.00002]))
        d = Vec3(jnp.array([0.6095]), jnp.array([0.0808]), jnp.array([-0.7886]))
        t, p, n, valid = plane_candidate(
            o, d, vec3(0.0, 0.0, -1.0), vec3(0.0, 275.0, 275.0), 555.0, 555.0
        )
        assert not bool(valid[0])

    def test_distant_legitimate_hit_still_accepted(self):
        import jax.numpy as jnp

        from cornelis.geometry import min_hit_t, plane_candidate
        from cornelis.math.vec import Vec3, vec3

        o = Vec3(jnp.array([0.0]), jnp.array([275.0]), jnp.array([-1100.0]))
        d = Vec3(jnp.array([0.0]), jnp.array([0.0]), jnp.array([1.0]))
        t, p, n, valid = plane_candidate(
            o, d, vec3(0.0, 0.0, -1.0), vec3(0.0, 275.0, 275.0), 555.0, 555.0
        )
        assert bool(valid[0]) and abs(float(t[0]) - 1375.0) < 1e-2
        # Guard scale: a few ulps of the origin magnitude, far below real
        # geometry spacing.
        assert float(min_hit_t(o)[0]) < 0.01

    def test_sphere_near_root_rejected_far_root_kept(self):
        import jax.numpy as jnp

        from cornelis.geometry import sphere_candidate
        from cornelis.math.vec import Vec3, vec3

        # Origin a hair outside a unit sphere pointing inward: the entry
        # root sits at ~1e-7 (below the guard), the exit root at ~2 -- the
        # guard must skip to the exit root, not reject the sphere.
        o = Vec3(jnp.array([0.0]), jnp.array([0.0]), jnp.array([-1.0000001]))
        d = Vec3(jnp.array([0.0]), jnp.array([0.0]), jnp.array([1.0]))
        t, p, n, valid = sphere_candidate(o, d, vec3(0.0, 0.0, 0.0), 1.0)
        assert bool(valid[0]) and abs(float(t[0]) - 2.0) < 1e-3
