"""User-facing scene description (builder API).

Mirrors the reference's `SceneDescription` builder and description value
types (include/cornelis/SceneDescription.hpp:14-92) with identical defaults,
including the invariant that material index 0 is always a default material
(SceneDescription.hpp:89; asserted by tests/test_SceneDescription.cpp:9-13).

Descriptions are plain Python data (AoS, user-friendly); `compile_scene`
turns them into the SoA device arrays the integrator consumes -- the same
split the reference makes between SceneDescription and SceneData
(src/Scene.cpp:40-53).

Also provides JSON (de)serialization -- the reference lists a scene
description language as a planned milestone (README.md); JSON is our v1.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

F3 = Tuple[float, float, float]


@dataclass
class MaterialDescription:
    """Defaults match SceneDescription.hpp:14-22."""

    albedo: F3 = (0.5, 0.5, 0.5)
    emissive: F3 = (0.0, 0.0, 0.0)
    roughness: float = 0.2
    reflection_tint: F3 = (0.0, 0.0, 0.0)
    ior: float = 1.5



# Optional object-to-world transform: a row-major 4x4 (nested lists/tuples)
# restricted to translate * rotate * uniform-scale, validated and baked to
# world-space parameters at compile (math/linalg.py decompose_trs). The
# reference stages this capability (empty Transform, Math.hpp:273; SIMD
# matrixMultiply with no caller, Linalg.cpp:43-53); here it works.
Transform4 = Optional[list]


@dataclass
class SphereDescription:
    """Defaults match SceneDescription.hpp:30-35."""

    center: F3 = (0.0, 0.0, 0.0)
    radius: float = 1.0
    material: Optional[int] = None
    transform: Transform4 = None


@dataclass
class PlaneDescription:
    """A finite rectangle: extents.x -> width, extents.y -> height
    (SceneDescription.hpp:37-43, Scene.cpp:34-35)."""

    normal: F3 = (0.0, 1.0, 0.0)
    point: F3 = (0.0, 0.0, 0.0)
    extents: F3 = (1000.0, 1000.0, 0.0)
    material: Optional[int] = None
    transform: Transform4 = None


@dataclass
class SDFDescription:
    """An implicit (level-set) surface, sphere-traced in the intersect
    kernel. This is our stand-in for the reference's staged
    NanoVDB level-set milestone (README Milestone 6; external/nanovdb is
    vendored but unused -- SURVEY §2 #18).

    kind/params:
      "sphere": params[0] = radius
      "box":    params[0:3] = half-extents
      "torus":  params[0] = major radius, params[1] = tube radius
    """

    kind: str = "sphere"
    center: F3 = (0.0, 0.0, 0.0)
    params: Tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)
    material: Optional[int] = None
    transform: Transform4 = None  # enables ORIENTED boxes / tori


SDF_KINDS = ("sphere", "box", "torus")


@dataclass
class PerspectiveCameraDescription:
    """Defaults match SceneDescription.hpp:45-53."""

    origin: F3 = (0.0, 0.0, 0.0)
    look_at: F3 = (0.0, 0.0, 1.0)
    aspect: float = 0.5
    horizontal_fov: float = 1.011  # 35mm-normal lens (43mm)


@dataclass
class SceneDescription:
    """Builder with the reference's semantics: add* return indices; objects
    reference materials by optional index resolved to 0 at compile."""

    camera: PerspectiveCameraDescription = field(
        default_factory=PerspectiveCameraDescription
    )
    materials: List[MaterialDescription] = field(
        default_factory=lambda: [MaterialDescription()]
    )
    spheres: List[SphereDescription] = field(default_factory=list)
    planes: List[PlaneDescription] = field(default_factory=list)
    sdfs: List[SDFDescription] = field(default_factory=list)

    def set_camera(self, cam: PerspectiveCameraDescription) -> None:
        self.camera = cam

    def add_material(self, mat: MaterialDescription) -> int:
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_sphere(self, sphere: SphereDescription) -> int:
        self.spheres.append(sphere)
        return len(self.spheres) - 1

    def add_plane(self, plane: PlaneDescription) -> int:
        self.planes.append(plane)
        return len(self.planes) - 1

    def add_sdf(self, sdf: SDFDescription) -> int:
        if sdf.kind not in SDF_KINDS:
            raise ValueError(f"unknown SDF kind {sdf.kind!r} (expected {SDF_KINDS})")
        self.sdfs.append(sdf)
        return len(self.sdfs) - 1

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "camera": dataclasses.asdict(self.camera),
            "materials": [dataclasses.asdict(m) for m in self.materials],
            "spheres": [dataclasses.asdict(s) for s in self.spheres],
            "planes": [dataclasses.asdict(p) for p in self.planes],
            "sdfs": [dataclasses.asdict(s) for s in self.sdfs],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @staticmethod
    def from_dict(d: dict) -> "SceneDescription":
        def _t(v):
            return tuple(v) if isinstance(v, (list, tuple)) else v

        def _load(cls, obj):
            kwargs = {}
            for f in dataclasses.fields(cls):
                if f.name in obj:
                    kwargs[f.name] = _t(obj[f.name])
            return cls(**kwargs)

        scene = SceneDescription()
        if "camera" in d:
            scene.camera = _load(PerspectiveCameraDescription, d["camera"])
        if "materials" in d:
            scene.materials = [_load(MaterialDescription, m) for m in d["materials"]]
            if not scene.materials:
                scene.materials = [MaterialDescription()]
        scene.spheres = [_load(SphereDescription, s) for s in d.get("spheres", [])]
        scene.planes = [_load(PlaneDescription, p) for p in d.get("planes", [])]
        scene.sdfs = [_load(SDFDescription, s) for s in d.get("sdfs", [])]
        return scene

    @staticmethod
    def from_json(text: str) -> "SceneDescription":
        return SceneDescription.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "SceneDescription":
        with open(path) as f:
            return SceneDescription.from_json(f.read())
