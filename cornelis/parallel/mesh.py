"""Device-mesh construction and multi-host bring-up.

The reference's only parallelism is TBB work-stealing over 32x32 image tiles
inside one process (src/Render.cpp:327-354). The accelerator analog is a
`jax.sharding.Mesh` with two logical axes:

  * `tiles`   -- shards the pixel axis (the reference's tile decomposition,
                 Tiles.cpp:5-29, reinterpreted as a sharding spec);
  * `samples` -- shards samples-per-pixel; partial per-pixel sums are
                 combined with a `psum` over this axis (an actual
                 NCCL collective, unlike the reference's zero-communication
                 tiles).

Because the RNG is keyed by global ray id (rng.py), the image is invariant
to the mesh shape -- the determinism guarantee the reference documents for
its per-tile streams (Tiles.hpp:22-31), strengthened to cover resharding.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (tiles, samples) mesh over the given (default: all) devices.

    With no `shape`, all devices go to the `tiles` axis -- pure image-space
    data parallelism, the scaling-friendly default (zero collectives in the
    forward render). Pass e.g. ``shape=(4, 2)`` to also shard spp.
    """
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if shape is None:
        shape = (devices.size, 1)
    if math.prod(shape) != devices.size:
        raise ValueError(
            f"mesh shape {tuple(shape)} does not cover {devices.size} devices"
        )
    return Mesh(devices.reshape(shape), (TILE_AXIS, SAMPLE_AXIS))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host bring-up: `jax.distributed.initialize` with early, loud
    failure (SURVEY.md section 5: surface init failures before the render).

    On a single host this is a no-op. The same render program then runs
    under a global mesh spanning every host's devices; each host feeds and
    reads only its addressable shards of the framebuffer.
    """
    if coordinator_address is None:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except Exception as exc:  # pragma: no cover - needs multi-host
        raise RuntimeError(
            "jax.distributed.initialize failed -- check coordinator address "
            f"and that all {num_processes} processes are launched: {exc}"
        ) from exc
