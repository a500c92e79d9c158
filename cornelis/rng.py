"""Counter-based stateless RNG and hemisphere sampling.

The reference uses a stateful Xoshiro128+ generator with jump-ahead streams
per tile (include/cornelis/PRNG.hpp:11-37) to get deterministic, thread-safe
sampling. The replacement here is JAX's counter-based threefry: every
draw is keyed by (seed, ray_id, stream), so results are independent of
evaluation order, chunking, and device mesh shape -- the same determinism
guarantee the reference documents for tiles (Tiles.hpp:22-31), but strictly
stronger (shard-invariant by construction).

Hemisphere sampling reproduces the reference's exact mapping
(PRNG.hpp:39-55): (x1, x2) -> (cos(2 pi x2) b, sin(2 pi x2) b, x1) with
b = sqrt(1 - x1^2), and basis placement v0->B, v1->T, v2->N.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .math.vec import PI, Basis, Vec3

Array = jnp.ndarray

# Reference default seed (PRNG.hpp:12).
DEFAULT_SEED = 19791102

# Stream ids for the per-ray draw schedule. The reference consumes its
# per-tile stream in a fixed order (camera jitter 2 draws: Render.cpp:94-95;
# per bounce: 1 RR draw + 3 BSDF draws: Render.cpp:189,199). We key each
# logical draw group instead of relying on consumption order.
STREAM_CAMERA = 0
STREAM_BOUNCE_BASE = 1  # bounce d uses stream STREAM_BOUNCE_BASE + d


def make_key(seed: int = DEFAULT_SEED) -> Array:
    return jax.random.key(seed)


def ray_keys(root: Array, ray_ids: Array) -> Array:
    """Per-ray keys from global ray ids: fold_in vmapped over the batch."""
    return jax.vmap(jax.random.fold_in, in_axes=(None, 0))(root, ray_ids)


def ray_uniforms(ray_key: Array, stream: Array, num: int) -> Array:
    """Draw `num` uniforms in [0, 1) per ray for a given stream id.

    ray_key: (N,) key array; returns (N, num) float32.
    """

    def draw(k):
        return jax.random.uniform(jax.random.fold_in(k, stream), (num,))

    return jax.vmap(draw)(ray_key)


class RayStreams(NamedTuple):
    """Per-ray sampler state carried through the bounce loop.

    `key` drives the default threefry sampler; `pixel_seed` and `sample_idx`
    drive the Owen-scrambled Sobol sampler (sampling.py). All three are
    always populated -- which one a draw consumes is a *static* choice
    (the `sampler` name threaded through the integrator), so the loop carry
    has one fixed pytree structure for both modes.
    """

    key: Array  # (N,) threefry keys
    pixel_seed: Array  # (N,) uint32 per-pixel scramble seed
    sample_idx: Array  # (N,) uint32 sample index within the pixel


def pixel_sample_keys(root: Array, pixel_ids: Array, sample_idx: Array) -> Array:
    """Per-ray keys from (pixel, sample) coordinates: two fold_ins.

    Keying the two coordinates separately (instead of packing them into one
    uint32 ray id `pixel * spp_total + sample`) keeps the streams
    collision-free at any scale: the packed form wraps past 2^32 rays --
    1080p at >2070 spp -- silently reusing keys between distant pixels. Each
    fold_in is a full threefry block, so (p0, s0) != (p1, s1) implies
    distinct keys with cryptographic confidence, matching the reference's
    non-overlapping jump-ahead stream guarantee (PRNG.hpp:32-37) without any
    range limit. The Pallas megakernel packs (pixel, sample) into separate
    counter words (ops/threefry.py:77-88) -- the same structure.
    """

    def derive(p, s):
        return jax.random.fold_in(jax.random.fold_in(root, p), s)

    return jax.vmap(derive)(
        pixel_ids.astype(jnp.uint32), sample_idx.astype(jnp.uint32)
    )


def make_ray_streams(
    root: Array, pixel_ids: Array, sample_idx: Array, spp_total: int
) -> RayStreams:
    """Build per-ray sampler state from global (pixel, sample) coordinates.

    pixel_ids/sample_idx: (N,) parallel arrays (already broadcast over the
    wavefront). Keys depend only on the global (pixel, sample) pair, so any
    partition of pixels or samples (chunking, device sharding) draws
    identical numbers. `spp_total` is kept for API stability (it no longer
    affects the keys -- see pixel_sample_keys).
    """
    del spp_total  # keys are packing-free; see pixel_sample_keys
    from .sampling import hash32  # local import: sampling has no rng dep

    # One uint32 of root entropy mixed into the per-pixel Sobol seeds so a
    # different render seed reshuffles the scrambles too.
    root_bits = jax.random.bits(
        jax.random.fold_in(root, 0x50B0), (), jnp.uint32
    )
    return RayStreams(
        key=pixel_sample_keys(root, pixel_ids, sample_idx),
        pixel_seed=hash32(pixel_ids.astype(jnp.uint32) ^ hash32(root_bits)),
        sample_idx=sample_idx.astype(jnp.uint32),
    )


def stream_uniforms(
    streams: RayStreams,
    stream: Array,
    num: int,
    sampler: str = "uniform",
    index_bits: int = 32,
) -> Array:
    """Draw `num` uniforms per ray for a draw-group id, shape (N, num).

    sampler="uniform": counter-based threefry (matches the reference's
    pseudo-random sampling in distribution). sampler="sobol": Owen-scrambled
    (0,2)-sequence over the pixel's sample index (the reference's planned
    QMC milestone); index_bits = ceil-log2 of the pixel's sample budget.
    """
    if sampler == "uniform":
        return ray_uniforms(streams.key, stream, num)
    if sampler == "sobol":
        from .sampling import sobol_uniforms

        return sobol_uniforms(
            streams.pixel_seed, streams.sample_idx, stream, num, index_bits
        )
    raise ValueError(f"unknown sampler '{sampler}' (expected uniform|sobol)")


def hemisphere_sample(x1: Array, x2: Array) -> Vec3:
    """Uniform hemisphere direction in canonical frame (PRNG.hpp:39-46).

    z = x1 (uniform in [0,1) => uniform on the hemisphere), azimuth 2 pi x2.
    """
    a = 2.0 * PI * x2
    b = jnp.sqrt(jnp.maximum(1.0 - x1 * x1, 0.0))
    return Vec3(jnp.cos(a) * b, jnp.sin(a) * b, x1)


def hemisphere_sample_basis(x1: Array, x2: Array, basis: Basis) -> Vec3:
    """Hemisphere sample placed in a surface basis (PRNG.hpp:52-55).

    Reference places canonical v as v0*B + v1*T + v2*N (note: B first).
    """
    v = hemisphere_sample(x1, x2)
    return basis.b * v.x + basis.t * v.y + basis.n * v.z


def hemisphere_pdf() -> float:
    """Uniform hemisphere pdf = 1/(2 pi) (PRNG.hpp:62)."""
    return 1.0 / (2.0 * PI)
