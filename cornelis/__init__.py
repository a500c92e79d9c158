"""cornelis: a differentiable Monte Carlo path tracer in JAX for the GPU.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference CPU path tracer (skurmedel/cornelis), redesigned for an
accelerator: SoA wavefronts, masked bounce loops under jit, a Triton
megakernel for forward renders, counter-based stateless RNG, device-mesh
sharding across cards, and differentiable rendering.
"""

from .camera import Camera, default_camera, generate_rays, horizontal_fov_35mm, look_at
from .film import Film
from .integrator import render_chunk, trace_paths
from .math.vec import RGB, Basis, Vec3, construct_basis, cross, dot, mag2, normalize
from .options import RenderOptions
from .render import (
    ProgressCallback,
    RenderCommand,
    RenderProgress,
    RenderResult,
    RenderSession,
    RenderStatus,
    render_scene,
)
from .scene.compile import SceneArrays, compile_scene
from .scene.description import (
    MaterialDescription,
    PerspectiveCameraDescription,
    PlaneDescription,
    SceneDescription,
    SDFDescription,
    SphereDescription,
)
from .scene.library import BUILTIN_SCENES, cornell_box, sdf_gallery, sphere_on_plane

__version__ = "0.1.0"

__all__ = [
    "BUILTIN_SCENES",
    "Basis",
    "Camera",
    "Film",
    "MaterialDescription",
    "PerspectiveCameraDescription",
    "PlaneDescription",
    "ProgressCallback",
    "RGB",
    "RenderCommand",
    "RenderOptions",
    "RenderProgress",
    "RenderResult",
    "RenderSession",
    "RenderStatus",
    "SDFDescription",
    "SceneArrays",
    "SceneDescription",
    "SphereDescription",
    "Vec3",
    "compile_scene",
    "construct_basis",
    "cornell_box",
    "cross",
    "default_camera",
    "dot",
    "generate_rays",
    "horizontal_fov_35mm",
    "look_at",
    "mag2",
    "normalize",
    "render_chunk",
    "render_scene",
    "sdf_gallery",
    "sphere_on_plane",
    "trace_paths",
]
