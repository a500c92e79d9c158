"""SoA 3-vector math for the wavefront.

The reference (cornelis) builds its math on a `float3` value type plus SoA
containers (`include/cornelis/Math.hpp`, `include/cornelis/SoA.hpp`). Under
JAX the natural equivalent is a *structure of arrays* from the start: a `Vec3`
is a pytree of three same-shaped `jnp` arrays. Elementwise math over (N,)
component arrays vectorizes across rays with contiguous loads -- an (N, 3)
layout would put the 3-wide axis minor.

Free-function API mirrors the reference's (`dot`, `mag2`, `cross`,
`normalize`, `ray_at`, `construct_basis`): see Math.hpp:278-292, 380-434.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Array = jnp.ndarray
Scalar = Union[float, Array]

# Matches cornelis::RayEpsilon (Math.hpp:20). Used as the zero cut-off for
# normalize() and the "is almost zero" guards in kernels.
RAY_EPSILON = 5e-5

PI = 3.14159265359  # cornelis::Pi (Math.hpp:25)


class Vec3(NamedTuple):
    """A batch of 3D vectors (or linear RGB colors) in SoA form.

    Each field is an array of identical shape; the vector/color is the tuple
    across fields. NamedTuple => automatically a JAX pytree.
    """

    x: Array
    y: Array
    z: Array

    # -- arithmetic (componentwise, the reference's product_ring semantics,
    #    Math.hpp:63-128) --------------------------------------------------
    def __add__(self, other: "Vec3") -> "Vec3":  # type: ignore[override]
        return Vec3(self.x + other.x, self.y + other.y, self.z + other.z)

    def __sub__(self, other: "Vec3") -> "Vec3":
        return Vec3(self.x - other.x, self.y - other.y, self.z - other.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, other: Union["Vec3", Scalar]) -> "Vec3":  # type: ignore[override]
        if isinstance(other, Vec3):
            return Vec3(self.x * other.x, self.y * other.y, self.z * other.z)
        return Vec3(self.x * other, self.y * other, self.z * other)

    def __rmul__(self, other: Scalar) -> "Vec3":  # type: ignore[override]
        return self.__mul__(other)

    def __truediv__(self, other: Scalar) -> "Vec3":
        inv = 1.0 / other
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    @property
    def shape(self):
        return jnp.shape(self.x)

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))


# Linear RGB shares the representation (reference keeps RGB a separate type
# with the same componentwise ops, Color.hpp:19-57 -- one SoA type serves both
# here; color-specific transfer lives in math/color.py).
RGB = Vec3


def vec3(x: Scalar, y: Scalar, z: Scalar, dtype=jnp.float32) -> Vec3:
    """Build a Vec3 from scalars / arrays, promoting python floats to arrays."""
    return Vec3(jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype))


def full_like(v: Vec3, value: float) -> Vec3:
    return Vec3(
        jnp.full_like(v.x, value), jnp.full_like(v.y, value), jnp.full_like(v.z, value)
    )


def broadcast_to(v: Vec3, shape) -> Vec3:
    return Vec3(
        jnp.broadcast_to(v.x, shape),
        jnp.broadcast_to(v.y, shape),
        jnp.broadcast_to(v.z, shape),
    )


def from_array(a: Array) -> Vec3:
    """(..., 3) array -> Vec3. Host-side convenience; avoid in hot paths."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_array(v: Vec3) -> Array:
    """Vec3 -> (..., 3) array. Host-side convenience (image assembly etc.)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def dot(a: Vec3, b: Vec3) -> Array:
    """Dot product (Math.hpp:278)."""
    return a.x * b.x + a.y * b.y + a.z * b.z


def mag2(a: Vec3) -> Array:
    """Squared magnitude (Math.hpp:284)."""
    return dot(a, a)


def length(a: Vec3) -> Array:
    return jnp.sqrt(mag2(a))


def cross(a: Vec3, b: Vec3) -> Vec3:
    """Cross product (Math.hpp:380-384)."""
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def ray_at(origin: Vec3, direction: Vec3, t: Array) -> Vec3:
    """Point along a ray: o + t*d (Math.hpp:290-292)."""
    return Vec3(origin.x + direction.x * t, origin.y + direction.y * t, origin.z + direction.z * t)


def is_almost_zero(v: Array) -> Array:
    """|v| < RayEpsilon (Math.hpp:22)."""
    return jnp.abs(v) < RAY_EPSILON


def normalize(v: Vec3) -> Vec3:
    """Normalize with the reference's zero cut-off (Math.hpp:392-398).

    Vectors whose length is below RayEpsilon are mapped to the zero vector
    instead of dividing by a tiny number.
    """
    # Grad-safe: guard the sqrt argument too -- sqrt'(0) = inf would leak
    # NaN through the unselected where branch in reverse mode.
    m2 = mag2(v)
    zero = m2 < RAY_EPSILON * RAY_EPSILON  # <=> length < RayEpsilon
    ln = jnp.sqrt(jnp.where(zero, 1.0, m2))
    s = jnp.where(zero, 0.0, 1.0 / ln)
    return v * s


def normalize_unchecked(v: Vec3) -> Vec3:
    """Plain v/|v| -- matches nanovdb Vec3::normalize used by the camera.

    (The reference camera normalizes ray directions with nanovdb's method,
    which has no epsilon cut-off: Camera.cpp:11-13.)
    """
    return v * (1.0 / length(v))


def where(mask: Array, a: Vec3, b: Vec3) -> Vec3:
    """Componentwise select: mask ? a : b."""
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def clamp(v: Vec3, lo: Scalar, hi: Scalar) -> Vec3:
    """Componentwise clamp (RGB::clamp, Color.cpp:26-30)."""
    return Vec3(jnp.clip(v.x, lo, hi), jnp.clip(v.y, lo, hi), jnp.clip(v.z, lo, hi))


class Basis(NamedTuple):
    """Orthonormal surface basis {N, T, B} (Math.hpp:403-416)."""

    n: Vec3
    t: Vec3
    b: Vec3


def construct_basis(n: Vec3) -> Basis:
    """Build a tangent basis from a normal (Math.hpp:424-434).

    Reproduces the reference exactly: helper axis (0,1,0) flipped to (0,0,1)
    where |N.y| > 0.95; T = normalize(helper x N); B = T x N.
    Precondition: N normalized.
    """
    flip = jnp.abs(n.y) > 0.95
    zeros = jnp.zeros_like(n.x)
    ones = jnp.ones_like(n.x)
    helper = Vec3(zeros, jnp.where(flip, 0.0, ones), jnp.where(flip, ones, 0.0))
    t = normalize(cross(helper, n))
    b = cross(t, n)
    return Basis(n=n, t=t, b=b)
