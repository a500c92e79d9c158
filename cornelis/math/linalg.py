"""4x4 transform linear algebra.

The reference ships a SIMD 4x4 * vec4 multiply (src/Linalg.cpp:43-53 via
xsimd), an empty `Transform` placeholder (Math.hpp:273), a float4x4 with
identity/scaling constructors (Math.hpp:330-360), and a commented-out
ray-stream transform stub (include/cornelis/Linalg.hpp:30-44,
src/Linalg.cpp:55-69). This module is the working JAX form of all
four: XLA's einsum IS the SIMD path (no hand-vectorization needed), and the
ray-stream transform is a vectorized jnp op over the whole wavefront.

Object-to-world transforms are restricted to TRS with *uniform* scale
(translate . rotate . uniform-scale): spheres stay spheres, plane rects
stay rects, and signed-distance fields scale linearly (d_world(p) =
s * d_local(R^T (p - t) / s)), so every primitive supports the transform
exactly with no per-ray matrix work in the hot loop -- everything bakes
into world-space parameters at scene compile (scene/compile.py), matching
the reference's aspiration without its per-ray cost.

Matrices are row-major (4, 4) float32 (the reference's layout,
Math.hpp:331), acting on column vectors: world = M @ local.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

Mat4 = np.ndarray  # host-side (4, 4) float32, baked at scene compile


def identity() -> Mat4:
    """float4x4::identityMatrix (Math.hpp:333-341)."""
    return np.eye(4, dtype=np.float32)


def scaling(s: float) -> Mat4:
    """Uniform scale (float4x4::scalingMatrix restricted to uniform
    diagonals, Math.hpp:343-359 -- non-uniform scale would break spheres
    and SDF distances; validated in decompose_trs)."""
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = float(s)
    return m


def translation(t: Sequence[float]) -> Mat4:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, np.float32)
    return m


def rotation_x(angle: float) -> Mat4:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotation_y(angle: float) -> Mat4:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotation_z(angle: float) -> Mat4:
    c, s = math.cos(angle), math.sin(angle)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def rotation_axis_angle(axis: Sequence[float], angle: float) -> Mat4:
    """Rodrigues rotation about a (normalized internally) axis."""
    a = np.asarray(axis, np.float64)
    n = np.linalg.norm(a)
    if n == 0.0:
        raise ValueError("rotation axis must be nonzero")
    x, y, z = a / n
    c, s = math.cos(angle), math.sin(angle)
    C = 1.0 - c
    r = np.array(
        [
            [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
            [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
            [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
        ],
        np.float64,
    )
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r.astype(np.float32)
    return m


def compose(*ms: Mat4) -> Mat4:
    """compose(A, B, C) = A @ B @ C (C applied first)."""
    out = np.eye(4, dtype=np.float32)
    for m in ms:
        out = out @ np.asarray(m, np.float32)
    return out.astype(np.float32)


def matrix_multiply(a, x):
    """4x4 matrix times length-4 vector(s): the reference's SIMD
    matrixMultiply (src/Linalg.cpp:43-53) as an einsum -- XLA vectorizes.

    x may be (4,) or batched (..., 4)."""
    return jnp.einsum("ij,...j->...i", jnp.asarray(a), jnp.asarray(x))


def transform_point(m: Mat4, p):
    """Apply the full affine transform to 3D point(s) (..., 3)."""
    p = jnp.asarray(p)
    lin = jnp.einsum("ij,...j->...i", jnp.asarray(m[:3, :3]), p)
    return lin + jnp.asarray(m[:3, 3])


def transform_vector(m: Mat4, v):
    """Apply the linear part only (directions ignore translation)."""
    return jnp.einsum("ij,...j->...i", jnp.asarray(m[:3, :3]), jnp.asarray(v))


def transform_normal(m: Mat4, n):
    """Normals transform by the inverse-transpose of the linear part
    (for our TRS-with-uniform-scale matrices this is R up to scale; the
    result is NOT re-normalized -- callers normalize)."""
    inv_t = np.linalg.inv(np.asarray(m[:3, :3], np.float64)).T.astype(np.float32)
    return jnp.einsum("ij,...j->...i", jnp.asarray(inv_t), jnp.asarray(n))


def transform_rays(m: Mat4, origins, directions):
    """Transform a whole ray wavefront: the reference's commented-out
    transformRays stub (src/Linalg.cpp:55-69), realized. origins/directions
    are (..., 3); directions are not re-normalized (rayT parameterization
    is preserved under uniform scale)."""
    return transform_point(m, origins), transform_vector(m, directions)


def decompose_trs(m) -> Tuple[np.ndarray, np.ndarray, float]:
    """Split a TRS matrix into (R (3,3), t (3,), s): validates that the
    linear part is s * R with R orthogonal (uniform scale, no shear) --
    the invariant every primitive's baked transform relies on."""
    m = np.asarray(m, np.float32)
    if m.shape != (4, 4):
        raise ValueError(f"transform must be 4x4, got {m.shape}")
    if not np.allclose(m[3], [0.0, 0.0, 0.0, 1.0], atol=1e-5):
        raise ValueError("transform must be affine (last row 0 0 0 1)")
    lin = np.asarray(m[:3, :3], np.float64)
    t = np.asarray(m[:3, 3], np.float32)
    s = float(np.cbrt(np.linalg.det(lin)))
    if not s > 0.0:
        raise ValueError("transform must have positive uniform scale")
    r = lin / s
    if not np.allclose(r @ r.T, np.eye(3), atol=1e-4):
        raise ValueError(
            "transform linear part must be rotation * uniform scale "
            "(no shear / non-uniform scale: spheres and SDF distances "
            "would not survive it)"
        )
    return r.astype(np.float32), t, s
