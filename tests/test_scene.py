"""Scene description + compile tests (mirroring tests/test_SceneDescription.cpp
and tests/test_Scene.cpp)."""

import numpy as np
import pytest

from cornelis.scene.compile import compile_scene
from cornelis.scene.description import (
    MaterialDescription,
    PerspectiveCameraDescription,
    PlaneDescription,
    SceneDescription,
    SphereDescription,
)
from cornelis.scene.library import cornell_box, sphere_on_plane


class TestDescription:
    def test_default_material_at_zero(self):
        # Material index 0 is always a default material
        # (SceneDescription.hpp:89, test_SceneDescription.cpp:9-13).
        scene = SceneDescription()
        assert len(scene.materials) == 1
        assert scene.materials[0] == MaterialDescription()

    def test_add_returns_indices(self):
        scene = SceneDescription()
        m1 = scene.add_material(MaterialDescription(albedo=(1, 0, 0)))
        m2 = scene.add_material(MaterialDescription(albedo=(0, 1, 0)))
        assert (m1, m2) == (1, 2)
        s0 = scene.add_sphere(SphereDescription(center=(1, 2, 3), radius=4))
        assert s0 == 0
        p0 = scene.add_plane(PlaneDescription())
        assert p0 == 0
        assert scene.spheres[s0].center == (1, 2, 3)

    def test_defaults_match_reference(self):
        m = MaterialDescription()
        assert m.albedo == (0.5, 0.5, 0.5)
        assert m.roughness == pytest.approx(0.2)
        assert m.reflection_tint == (0.0, 0.0, 0.0)
        assert m.ior == pytest.approx(1.5)
        c = PerspectiveCameraDescription()
        assert c.aspect == pytest.approx(0.5)
        assert c.horizontal_fov == pytest.approx(1.011)
        p = PlaneDescription()
        assert p.extents == (1000.0, 1000.0, 0.0)

    def test_json_roundtrip(self):
        scene = cornell_box()
        restored = SceneDescription.from_json(scene.to_json())
        assert restored.to_dict() == scene.to_dict()


class TestCompile:
    def test_empty_scene(self):
        # Empty-scene edge case (test_Scene.cpp:24-31).
        arrays = compile_scene(SceneDescription())
        assert arrays.num_spheres == 0
        assert arrays.num_planes == 0
        assert arrays.num_materials == 1

    def test_sphere_soa(self):
        scene = SceneDescription()
        mid = scene.add_material(MaterialDescription())
        scene.add_sphere(SphereDescription(center=(1, 2, 3), radius=4, material=mid))
        scene.add_sphere(SphereDescription(center=(5, 6, 7), radius=8))
        arrays = compile_scene(scene)
        assert np.allclose(np.asarray(arrays.sphere_center.x), [1, 5])
        assert np.allclose(np.asarray(arrays.sphere_center.z), [3, 7])
        assert np.allclose(np.asarray(arrays.sphere_radius), [4, 8])
        # material None resolves to 0 (Scene.cpp:16).
        assert list(np.asarray(arrays.sphere_material)) == [mid, 0]

    def test_plane_soa(self):
        scene = SceneDescription()
        scene.add_plane(
            PlaneDescription(normal=(0, 1, 0), point=(1, 2, 3), extents=(10, 20, 0))
        )
        arrays = compile_scene(scene)
        # extents.x -> width, extents.y -> height (Scene.cpp:34-35).
        assert float(arrays.plane_width[0]) == 10
        assert float(arrays.plane_height[0]) == 20
        assert float(arrays.plane_point.y[0]) == 2

    def test_cornell_counts(self):
        arrays = compile_scene(cornell_box())
        assert arrays.num_spheres == 4
        assert arrays.num_planes == 5
        assert arrays.num_materials == 6  # default + 5 added

    def test_material_table(self):
        arrays = compile_scene(cornell_box())
        # gold material (index 4): roughness 0.01, ior 0.470, tint set.
        assert float(arrays.mat_roughness[4]) == pytest.approx(0.01)
        assert float(arrays.mat_ior[4]) == pytest.approx(0.470)
        assert float(arrays.mat_tint.x[4]) == pytest.approx(0.916)
        # light material (index 5): emissive 15.
        assert float(arrays.mat_emission.x[5]) == pytest.approx(15.0)

    def test_sphere_on_plane_compiles(self):
        arrays = compile_scene(sphere_on_plane())
        assert arrays.num_spheres == 2
        assert arrays.num_planes == 1


class TestHostTableConsistency:
    """The Pallas kernel's baked constants and the XLA path's device scene
    must be the SAME numbers regardless of which backend compiled the scene
    (advisor finding, round 2). compile_scene computes all of its math --
    including the camera (camera.look_at_host) -- in host numpy, so this
    holds bitwise by construction on any platform."""

    def test_host_tables_match_compiled_scene_exactly(self):
        from cornelis.ops.pallas_integrator import (
            _HOST_SCENE_MEMO,
            host_scene_from_description,
            scene_to_host,
        )

        descr = cornell_box()
        a = host_scene_from_description(descr)
        scene = compile_scene(descr)
        _HOST_SCENE_MEMO.pop(id(scene), None)  # force a real device fetch
        b = scene_to_host(scene)
        assert a == b  # exact tuple equality, no tolerance

    def test_look_at_host_matches_traced_look_at(self):
        import numpy as np

        from cornelis.camera import look_at, look_at_host

        h = look_at_host((50.0, 40.8, 155.0), (50.0, 40.8, 0.0), 0.5, 1.011)
        d = look_at((50.0, 40.8, 155.0), (50.0, 40.8, 0.0), 0.5, 1.011)
        for hv, dv in zip(h, d):
            for hc, dc in zip(hv, dv):
                np.testing.assert_allclose(float(hc), float(dc), rtol=1e-6)


def test_sphere_grid_scales():
    """Procedural stress scene (VERDICT r2 #6): deterministic, 64+1 spheres."""
    arrays = compile_scene(__import__("cornelis.scene.library", fromlist=["sphere_grid"]).sphere_grid(64))
    assert arrays.num_spheres == 65
    assert arrays.num_planes == 1
    assert arrays.num_materials >= 9
    # Deterministic: two builds give identical tables.
    again = compile_scene(__import__("cornelis.scene.library", fromlist=["sphere_grid"]).sphere_grid(64))
    np.testing.assert_array_equal(
        np.asarray(arrays.sphere_center.x), np.asarray(again.sphere_center.x)
    )
