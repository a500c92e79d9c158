"""Color transfer and quantization.

Accelerator-side mirror of the reference's Color.cpp / FrameBuffer.hpp: linear RGB
lives as Vec3 SoA arrays (or (H, W, 3) images on the host side); only the
sRGB transfer function and 8-bit quantization live here.

Quirk preserved from the reference: its sRGB linear-segment slope is 12.95,
not the standard 12.92 (src/Color.cpp:47,68). We default to reference-
compatible behavior for golden matching and expose `standard=True` for the
spec-correct transfer. Thresholds (0.0031308 / 0.04045) and the 1.055/2.4
constants match the sRGB standard in both modes.
"""

from __future__ import annotations

import jax.numpy as jnp

Array = jnp.ndarray

_SRGB_A = 0.055


def _linear_slope(standard: bool) -> float:
    return 12.92 if standard else 12.95


def srgb_encode(linear: Array, standard: bool = False) -> Array:
    """Linear -> sRGB gamma correction (src/Color.cpp:64-78)."""
    slope = _linear_slope(standard)
    lo = linear * slope
    # Guard the pow against negative inputs (radiance should be >= 0, but the
    # unselected branch must still not produce NaNs under jnp.where).
    hi = (1.0 + _SRGB_A) * jnp.power(jnp.maximum(linear, 0.0), 1.0 / 2.4) - _SRGB_A
    return jnp.where(linear <= 0.0031308, lo, hi)


def srgb_decode(encoded: Array, standard: bool = False) -> Array:
    """sRGB -> linear (src/Color.cpp:40-57)."""
    slope = _linear_slope(standard)
    lo = encoded / slope
    hi = jnp.power(jnp.maximum(encoded + _SRGB_A, 0.0) / (1.0 + _SRGB_A), 2.4)
    return jnp.where(encoded <= 0.04045, lo, hi)


def quantize_to_8bit(v: Array) -> Array:
    """round(255*v) clamped to [0, 255], uint8 (FrameBuffer.hpp:91-100)."""
    q = jnp.round(255.0 * v)
    return jnp.clip(q, 0.0, 255.0).astype(jnp.uint8)
