"""Threefry-2x32 counter-based RNG as plain uint32 jnp ops.

The XLA integrator uses jax.random (threefry behind the scenes); inside a
Pallas kernel jax.random's key machinery is unavailable, so the
megakernel (ops/pallas_integrator.py) needs the block cipher spelled out.
This is the standard 20-round Threefry-2x32 (Salmon et al., "Parallel Random
Numbers: As Easy as 1, 2, 3", SC'11) -- pure adds/xors/rotates on uint32
lanes, all register work. It is validated against the Random123 known-answer
vectors in tests/test_pallas.py.

Draw discipline mirrors rng.py's stream scheme: every uniform is keyed by
(root key, pixel, sample, stream, slot) through the counter words, so
results are deterministic and invariant to chunking, sharding, and
evaluation order -- the same guarantee as the XLA path (different bits, same
distribution).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray
# numpy scalars (not jnp arrays) so every constant embeds as a jaxpr
# *literal* -- Pallas rejects kernels that capture concrete jnp arrays.
_U32 = np.uint32

# Rotation schedule (Threefry-2x32).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA  # key-schedule parity constant (Skein/Threefish)


def _rotl(x: Array, r: int) -> Array:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k0: Array, k1: Array, c0: Array, c1: Array) -> tuple[Array, Array]:
    """20-round Threefry-2x32: (key, counter) -> two uint32 blocks.

    All inputs broadcastable uint32 arrays; fully unrolled (20 rounds of
    3 ops + 5 key injections) -- cheap, branch-free integer code.
    """
    k0 = k0.astype(_U32) if hasattr(k0, "astype") else _U32(k0)
    k1 = k1.astype(_U32) if hasattr(k1, "astype") else _U32(k1)
    ks = (k0, k1, k0 ^ k1 ^ _U32(_PARITY))

    x0 = c0.astype(_U32) + ks[0]
    x1 = c1.astype(_U32) + ks[1]

    for block in range(5):
        rots = _ROTATIONS[0:4] if block % 2 == 0 else _ROTATIONS[4:8]
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + _U32(block + 1)
    return x0, x1


def to_unit_float(bits: Array) -> Array:
    """uint32 -> float32 in [0, 1): (x >> 8) * 2^-24 -- the reference's
    FloatFromBits quantization (external/XoshiroCpp.hpp:649-654).

    The top-24-bit value fits in int32, so the cast goes through int32
    (a signed conversion)."""
    return (bits >> _U32(8)).astype(jnp.int32).astype(jnp.float32) * np.float32(
        1.0 / (1 << 24)
    )


# Draw-id packing: counter word 1 = sample * 256 + stream * 2 + slot.
# Budget: streams (camera=0, bounce d=1+d) < 128 and spp <= 2^24 -- far
# beyond the render loop's bounds (max_depth <= 126, spp <= 16M).
_DRAWS_PER_SAMPLE = 256


def pair_uniforms(
    k0: Array, k1: Array, pixel: Array, sample: Array, stream: Array, pair: int
) -> tuple[Array, Array]:
    """Two uniforms for draw-pair `pair` of (pixel, sample, stream)."""
    c0 = pixel.astype(_U32)
    c1 = (
        sample.astype(_U32) * _U32(_DRAWS_PER_SAMPLE)
        + stream * _U32(2)
        + _U32(pair)
    )
    b0, b1 = threefry2x32(k0, k1, c0, c1)
    return to_unit_float(b0), to_unit_float(b1)
