"""Low-discrepancy sample sequences: hash-based Owen-scrambled Sobol (0,2).

The reference reserves an (empty) Sampling.hpp for a planned QMC sample-
generator subsystem (README Milestone 5: "Sample generators (for QMC
sampling)"; include/cornelis/Sampling.hpp is a placeholder TU). This module
implements it: a base-2 Sobol (0,2)-sequence with hash-based Owen
scrambling, evaluated branch-free over whole wavefronts.

Scheme (Burley, "Practical Hash-Based Owen Scrambling", JCGT 2020 --
technique, not code):
  * dimension 0 is the van der Corput radical inverse (bit-reversed index);
  * dimension 1 is the classic Sobol' direction-number recurrence
    v_0 = 2^31, v_{j+1} = v_j ^ (v_j >> 1);
  * each dimension is Owen-scrambled by a Laine-Karras-style hash keyed per
    (pixel, stream, dimension) -- a nested uniform digit permutation, so the
    (0,2) stratification guarantees survive scrambling;
  * higher draw counts are *padded*: every 2-draw group reuses the same 2D
    point under an independent scramble key.

Uniform floats use the reference's bits-to-float mapping
(x >> 8) * 2^-24 (external/XoshiroCpp.hpp:649-654) so both samplers share
the exact [0, 1) quantization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray

_U32 = jnp.uint32


def reverse_bits32(x: Array) -> Array:
    """Bit-reverse each uint32 lane."""
    x = x.astype(_U32)
    x = ((x >> 1) & _U32(0x55555555)) | ((x & _U32(0x55555555)) << 1)
    x = ((x >> 2) & _U32(0x33333333)) | ((x & _U32(0x33333333)) << 2)
    x = ((x >> 4) & _U32(0x0F0F0F0F)) | ((x & _U32(0x0F0F0F0F)) << 4)
    x = ((x >> 8) & _U32(0x00FF00FF)) | ((x & _U32(0x00FF00FF)) << 8)
    return (x >> 16) | (x << 16)


def hash32(x: Array) -> Array:
    """Low-bias integer hash (xmur3-style avalanche) for scramble keys."""
    x = x.astype(_U32)
    x = x ^ (x >> 16)
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _laine_karras(x: Array, seed: Array) -> Array:
    """Hash that permutes bits with strictly *upward* (toward-MSB) influence
    -- bit j of the output depends only on bits <= j of the input -- so
    applied to a bit-reversed value it realizes an Owen (nested uniform)
    scramble per dimension. Constants are Burley's published improvement of
    the Laine-Karras hash (JCGT 2020, eq. 14)."""
    x = x ^ (x * _U32(0x3D20ADEA))
    x = x + seed
    x = x * ((seed >> 16) | _U32(1))
    x = x ^ (x * _U32(0x05526C56))
    x = x ^ (x * _U32(0x53A22864))
    return x


def shuffle_index(index: Array, bits: int, seed: Array) -> Array:
    """Per-group sample-index shuffle for padding decorrelation.

    A seeded bijection of [0, 2^bits): the index is placed in the top bits,
    Owen-scrambled (whose nested property makes the top-`bits` prefix a
    bijection of itself), and shifted back. Each padded draw group sees the
    *same set* of Sobol indices in an independent order, so per-group
    stratification is exactly preserved while cross-group correlation
    vanishes (pbrt's PaddedSobolSampler / Burley's shuffled scrambled
    sequences -- technique, not code).
    """
    bits = max(1, min(32, bits))
    shift = _U32(32 - bits)
    x = index.astype(_U32) << shift
    return owen_scramble(x, seed.astype(_U32)) >> shift


def owen_scramble(x: Array, seed: Array) -> Array:
    """Owen-scramble uint32 sample bits with a per-lane seed."""
    return reverse_bits32(_laine_karras(reverse_bits32(x), seed.astype(_U32)))


def sobol2d_bits(index: Array, bits: int = 32) -> tuple[Array, Array]:
    """Unscrambled base-2 (0,2) Sobol point as uint32 bit patterns.

    dim 0: van der Corput; dim 1: Sobol' second-dimension recurrence,
    XOR of direction numbers v_j = (2^31 >> j-ish via v ^= v >> 1) over the
    set bits of the index.

    `bits`: how many low index bits can be set (ceil-log2 of the sample
    budget). Trips beyond that XOR nothing, so truncating the recurrence
    is exact -- it just saves work and kernel compile time (the loop
    runs inside the megakernel's bounce loop).
    """
    index = index.astype(_U32)
    d0 = reverse_bits32(index)

    def body(_, carry):
        d1, v, idx = carry
        d1 = jnp.where((idx & _U32(1)) != 0, d1 ^ v, d1)
        return (d1, v ^ (v >> 1), idx >> 1)

    d1, _, _ = jax.lax.fori_loop(
        0,
        max(1, min(32, bits)),
        body,
        (
            jnp.zeros_like(index),
            jnp.full_like(index, _U32(0x80000000)),
            index,
        ),
    )
    return d0, d1


def bits_to_unit_float(x: Array) -> Array:
    """uint32 -> float32 in [0, 1): (x >> 8) * 2^-24, the reference's
    FloatFromBits quantization (external/XoshiroCpp.hpp:649-654).

    The top-24-bit value fits in int32, so the cast goes through int32
    (a signed conversion; this module also runs inside the megakernel)."""
    return (x >> 8).astype(jnp.int32).astype(jnp.float32) * jnp.float32(
        1.0 / (1 << 24)
    )


def sobol_uniforms(
    pixel_seed: Array,
    sample_idx: Array,
    stream: Array,
    num: int,
    index_bits: int = 32,
) -> Array:
    """`num` Owen-scrambled Sobol uniforms per lane, shape (N, num).

    pixel_seed: (N,) uint32 per-pixel hash seeds; sample_idx: (N,) uint32
    index within the pixel's sample sequence; stream: scalar draw-group id
    (camera / bounce d). Draws are padded in 2D pairs; each pair shuffles
    the sample index (shuffle_index) and Owen-scrambles both dimensions,
    all keyed by hash(pixel_seed, stream, pair, role) -- Burley's padded
    Sobol construction. index_bits: the sample-index range is [0, 2^index_bits)
    (ceil-log2 of spp); the shuffle permutes exactly that range.
    """
    cols = []
    for pair in range((num + 1) // 2):
        u0, u1 = sobol_pair(pixel_seed, sample_idx, stream, pair, index_bits)
        cols.append(u0)
        if len(cols) < num:
            cols.append(u1)
    return jnp.stack(cols[:num], axis=-1)


def sobol_pair(
    pixel_seed: Array,
    sample_idx: Array,
    stream: Array,
    pair: int,
    index_bits: int = 32,
) -> tuple[Array, Array]:
    """One Owen-scrambled (0,2) draw pair, returned as two arrays of the
    lanes' shape (no stacking -- the form the Pallas megakernel consumes;
    sobol_uniforms is built on this, so the two backends draw BIT-IDENTICAL
    sobol numbers for the same (pixel_seed, sample, stream, pair))."""
    stream_u = jnp.asarray(stream).astype(_U32)
    seed = pixel_seed.astype(_U32)

    def group_key(role: int) -> Array:
        return hash32(seed ^ hash32(stream_u * _U32(8) + _U32(4 * pair + role)))

    idx = shuffle_index(sample_idx, index_bits, group_key(0))
    d0, d1 = sobol2d_bits(idx, index_bits)
    return (
        bits_to_unit_float(owen_scramble(d0, group_key(1))),
        bits_to_unit_float(owen_scramble(d1, group_key(2))),
    )
