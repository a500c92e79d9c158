"""Mesh-sharded render: the TBB tile loop (src/Render.cpp:335-354) as a
`shard_map` over a (tiles, samples) device mesh.

Mapping from the reference:

  * one TBB tile task          -> one shard of the pixel axis on one device;
  * dynamic work stealing      -> static equal split (wavefronts are
                                  uniform-cost by construction: fixed-shape
                                  masked bounce loop, no per-tile variance
                                  in dispatch size);
  * disjoint framebuffer tiles -> out_specs P('tiles') -- each device owns
                                  its pixel rows, gathered once at the end;
  * zero inter-tile comms      -> `psum` over the `samples` axis only when
                                  spp is sharded (pure tile-DP keeps the
                                  reference's zero-communication property).

Determinism: RNG keys depend only on global ray ids, so the rendered image
is invariant to the mesh shape (tested against the single-device renderer in
tests/test_parallel.py).
"""

from __future__ import annotations

import functools
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..integrator import integrate_pixel_samples
from ..scene.compile import SceneArrays
from .mesh import SAMPLE_AXIS, TILE_AXIS

Array = jnp.ndarray


def _check_divisible(value: int, by: int, what: str) -> None:
    if value % by != 0:
        raise ValueError(
            f"{what} ({value}) must be divisible by the mesh axis size {by}"
        )


@partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "width",
        "height",
        "spp_chunk",
        "spp_total",
        "max_depth",
        "unroll_bounces",
        "sampler",
        "tile_size",
        "mode",
        "nee_clamp",
        "detach_sampling",
    ),
)
def render_chunk_mesh(
    scene: SceneArrays,
    root_key: Array,
    sample_offset: Array,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    unroll_bounces: bool = False,
    sampler: str = "uniform",
    tile_size: int = 32,
    mode: str = "path",
    nee_clamp=None,
    detach_sampling: bool = False,
) -> Array:
    """Render one sample chunk over the mesh; returns (H, W, 3) radiance
    sums, identical (modulo float reduction order when spp is sharded) to
    `integrator.render_chunk`.

    Pixels are permuted tile-major (FrameTiling as the sharding spec: each
    device owns whole tile_size x tile_size image tiles, the reference's
    parallel grain, src/Render.cpp:327) and sharded over `tiles`; the
    chunk's samples over `samples`, with per-pixel partial sums psum'd over
    `samples`. RNG keys depend only on (pixel, sample) ids, so the image is
    invariant to both the mesh shape and the tile size. tile_size=0 falls
    back to flat row-band splitting.
    """
    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    num_pixels = width * height
    _check_divisible(num_pixels, n_tiles, "pixel count")
    _check_divisible(spp_chunk, n_samp, "spp chunk")

    if tile_size > 0:
        from ..math.tiles import tile_major_order

        perm = tile_major_order(width, height, tile_size, tile_size)
        pixel_ids = jnp.asarray(perm)  # static permutation, baked at trace
    else:
        pixel_ids = jnp.arange(num_pixels, dtype=jnp.uint32)
    sample_idx = sample_offset + jnp.arange(spp_chunk, dtype=jnp.uint32)

    def shard_fn(scene_rep, key_rep, px_shard, samp_shard):
        part = integrate_pixel_samples(
            scene_rep,
            key_rep,
            px_shard,
            samp_shard,
            width=width,
            height=height,
            spp_total=spp_total,
            max_depth=max_depth,
            unroll_bounces=unroll_bounces,
            sampler=sampler,
            mode=mode,
            nee_clamp=nee_clamp,
            detach_sampling=detach_sampling,
        )
        if n_samp > 1:
            part = jax.lax.psum(part, SAMPLE_AXIS)
        return part

    scene_spec = jax.tree.map(lambda _: P(), scene)
    # check_vma=False: the integrator's loop carries are initialized with
    # constants (replicated), which the varying-manual-axes checker rejects;
    # the psum over `samples` is the only cross-shard dependence and is
    # explicit above.
    img = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(scene_spec, P(), P(TILE_AXIS), P(SAMPLE_AXIS)),
        out_specs=P(TILE_AXIS, None),
        check_vma=False,
    )(scene, root_key, pixel_ids, sample_idx)
    if tile_size > 0:
        # Un-permute: row k of img is the radiance of pixel perm[k].
        import numpy as np

        inv = np.argsort(perm).astype(np.int32)
        img = img[inv]
    img = img.reshape(height, width, 3)
    # Keep the row ownership explicit for downstream consumers.
    return jax.lax.with_sharding_constraint(
        img, NamedSharding(mesh, P(TILE_AXIS, None, None))
        if height % n_tiles == 0
        else NamedSharding(mesh, P(None, None, None)),
    )


@functools.lru_cache(maxsize=32)
def _build_mesh_pallas_renderer(
    host,
    mesh: Mesh,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    sampler: str,
    tile_size: int,
    block: int,
    num_warps: int,
    interpret: bool,
    mode: str = "path",
    nee_clamp: float = None,
):
    """(root_key, sample_offset) -> (H, W, 3) over the mesh,
    with the Pallas megakernel as each device's body. Cached per static
    config (host scene tuples are hashable by construction)."""
    from ..ops.pallas_integrator import _build_renderer, _key_words

    import numpy as np

    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    num_pixels = width * height
    px_per_dev = num_pixels // n_tiles
    spp_per_dev = spp_chunk // n_samp
    n_dev_rays = px_per_dev * spp_per_dev
    n_pad = (n_dev_rays + block - 1) // block * block

    index_bits = max(1, (spp_total - 1).bit_length())
    renderer = _build_renderer(
        host, width, height, max_depth, n_dev_rays, block, num_warps,
        interpret, sampler, index_bits, mode, nee_clamp,
    )

    inv = None
    if tile_size > 0:
        from ..math.tiles import tile_major_order

        perm = tile_major_order(width, height, tile_size, tile_size)
        inv = np.argsort(perm).astype(np.int32)
    else:
        perm = np.arange(num_pixels, dtype=np.uint32)
    # The pixel order is host math over the whole frame (tens of ms at
    # 1080p): build it once per configuration.
    pixel_ids = jnp.asarray(perm)

    def shard_fn(key_rep, px_shard, samp_shard):
        px = jnp.repeat(px_shard, spp_per_dev)
        si = jnp.tile(samp_shard, px_per_dev)
        if n_pad != n_dev_rays:
            pad = jnp.zeros(n_pad - n_dev_rays, jnp.uint32)
            px = jnp.concatenate([px, pad])
            si = jnp.concatenate([si, pad])
        r, g, b = renderer(key_rep, px, si)
        part = jnp.stack(
            [r[:n_dev_rays], g[:n_dev_rays], b[:n_dev_rays]], axis=-1
        )
        part = part.reshape(px_per_dev, spp_per_dev, 3).sum(axis=1)
        if n_samp > 1:
            part = jax.lax.psum(part, SAMPLE_AXIS)
        return part

    @jax.jit
    def run_ids(root_key, pixel_ids, sample_offset):
        sample_idx = sample_offset + jnp.arange(spp_chunk, dtype=jnp.uint32)
        img = jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(), P(TILE_AXIS), P(SAMPLE_AXIS)),
            out_specs=P(TILE_AXIS, None),
            check_vma=False,
        )(_key_words(root_key), pixel_ids, sample_idx)
        if inv is not None:
            img = img[inv]
        return img.reshape(height, width, 3)

    return lambda root_key, offset: run_ids(root_key, pixel_ids, offset)


def render_chunk_mesh_pallas(
    scene: SceneArrays,
    root_key: Array,
    sample_offset,
    *,
    mesh: Mesh,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    sampler: str = "uniform",
    tile_size: int = 32,
    interpret: bool = False,
    mode: str = "path",
    nee_clamp: float = None,
) -> Array:
    """The Pallas megakernel under the device mesh: each device runs the
    register-resident bounce loop (ops/pallas_integrator.py) on its own
    pixel tiles and sample slice; per-pixel partial sums are psum'd over
    the `samples` axis. Per-ray results are identical to the single-device
    megakernel (keys depend only on (pixel, sample) ids).

    interpret=True runs the kernel in Pallas interpret mode (how the CPU
    tests exercise this composition on a virtual mesh).
    """
    from ..ops.pallas_integrator import (
        DEFAULT_BLOCK,
        DEFAULT_WARPS,
        _host_nee_clamp,
        scene_to_host,
    )

    n_tiles = mesh.shape[TILE_AXIS]
    n_samp = mesh.shape[SAMPLE_AXIS]
    num_pixels = width * height
    _check_divisible(num_pixels, n_tiles, "pixel count")
    _check_divisible(spp_chunk, n_samp, "spp chunk")

    host = scene_to_host(scene)
    if nee_clamp is None:
        nee_clamp = _host_nee_clamp(host)
    run = _build_mesh_pallas_renderer(
        host, mesh, width, height, spp_chunk, spp_total, max_depth,
        sampler, tile_size, DEFAULT_BLOCK, DEFAULT_WARPS, interpret, mode,
        float(nee_clamp),
    )
    img = run(root_key, jnp.asarray(sample_offset, jnp.uint32))
    # Keep the row ownership explicit for downstream consumers.
    return jax.lax.with_sharding_constraint(
        img, NamedSharding(mesh, P(TILE_AXIS, None, None))
        if height % n_tiles == 0
        else NamedSharding(mesh, P(None, None, None)),
    )
