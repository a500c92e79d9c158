"""Render options.

The reference exposes a single knob, samplesAA (default 256,
include/cornelis/RenderOptions.hpp:6-16), and hardcodes everything else:
512x512 resolution (Render.cpp:307), 32x32 tiles (Render.cpp:327), the
output path (Render.cpp:264). We lift all of those into configuration, with
the reference's values as defaults.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .rng import DEFAULT_SEED


@dataclass
class RenderOptions:
    # Reference knob + default (RenderOptions.hpp:7).
    samples_aa: int = 256
    # Hardcoded in the reference; lifted here with identical defaults.
    width: int = 512
    height: int = 512
    # Max bounce depth: the reference loops until RR kills every path
    # (Render.cpp:237-243); under jit we bound the while_loop. RR survival
    # after depth 3 is <= 0.55, so P(alive at 64) < 1e-16 -- the truncation
    # bias is far below MC noise.
    max_depth: int = 64
    seed: int = DEFAULT_SEED
    # Samples dispatched per device call (progress/abort/checkpoint grain).
    # 0 = auto-size to ~2M rays per dispatch.
    spp_chunk: int = 0
    # Output path; None = don't save. Reference hardcodes
    # "cornelisrender2.png" (Render.cpp:264).
    output: Optional[str] = "cornelisrender2.png"
    # Use the standard sRGB 12.92 linear slope instead of the reference's
    # 12.95 quirk (src/Color.cpp:47,68).
    standard_srgb: bool = False
    # Checkpoint file updated after every chunk; None disables.
    checkpoint: Optional[str] = None
    # Device-mesh shape (tiles, samples); None = single-device dispatch.
    # The accelerator replacement for the reference's TBB tile pool
    # (Render.cpp:335-354): pixels shard over `tiles`, spp over `samples`.
    mesh_shape: Optional[tuple] = None
    # Image-tile edge for the mesh pixel sharding (FrameTiling as a
    # sharding spec; the reference's 32x32 parallel grain, Render.cpp:327).
    # 0 = flat row-band split. Ignored without mesh_shape.
    tile_size: int = 32
    # Sample sequence: "uniform" (threefry; the reference's pseudo-random
    # sampling in distribution) or "sobol" (Owen-scrambled low-discrepancy;
    # the reference's planned QMC milestone, Sampling.hpp placeholder).
    sampler: str = "uniform"
    # Compute backend: "auto" follows the platform (resolve_backend);
    # "xla" / "pallas" force the XLA wavefront or the Pallas megakernel.
    backend: str = "auto"
    # Integrator estimator: "path" replicates the reference exactly
    # (emission at every hit, no light sampling, the quirky averaged
    # layered pdf -- required for golden match); "nee" is the corrected
    # extension (MIS-combined next-event estimation toward emissive
    # spheres AND rectangle planes + the true sampler density) --
    # unbiased apart from the bounded firefly clamp (see nee_clamp),
    # typically orders of magnitude lower variance for small lights.
    # Supported by both the XLA wavefront and the Pallas megakernel.
    integrator: str = "path"
    # NEE firefly clamp: per-channel ceiling on any single bounce's
    # radiance contribution in nee mode (depth-0 emitter sightings exempt).
    # None = scale-aware default, NEE_CLAMP_FACTOR (16) x the scene's
    # brightest emission channel (floored at 1) -- see
    # integrator.auto_nee_clamp. A float overrides with an absolute
    # ceiling; math.inf disables clamping (fully unbiased NEE, fireflies
    # included). Ignored in path mode (never clamped).
    nee_clamp: Optional[float] = None
    # Progressive mode: stop dispatching new sample chunks once this many
    # seconds have elapsed (the reference's planned "sample for x seconds",
    # README Milestone 4). The image normalizes by the samples actually
    # taken; combine with `checkpoint` to keep refining across runs.
    # 0 = no time budget (render all samples_aa).
    time_budget_s: float = 0.0

    def validate(self) -> None:
        if self.samples_aa <= 0:
            raise ValueError(f"AA Samples must be > 0 (not {self.samples_aa}).")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("Resolution must be positive.")
        if self.max_depth <= 0:
            raise ValueError("max_depth must be positive.")
        if self.tile_size < 0:
            raise ValueError("tile_size must be >= 0 (0 = flat split).")
        if self.time_budget_s < 0:
            raise ValueError("time_budget_s must be >= 0 (0 = unlimited).")
        if self.sampler not in ("uniform", "sobol"):
            raise ValueError(
                f"sampler must be 'uniform' or 'sobol' (not {self.sampler!r})."
            )
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(
                f"backend must be auto, xla, or pallas (not {self.backend!r})."
            )
        if self.integrator not in ("path", "nee"):
            raise ValueError(
                f"integrator must be 'path' or 'nee' (not {self.integrator!r})."
            )
        if self.nee_clamp is not None and not self.nee_clamp > 0:
            raise ValueError(
                f"nee_clamp must be > 0 (math.inf disables clamping; None "
                f"selects the scale-aware default), not {self.nee_clamp}."
            )

    def resolved_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        import jax

        return resolve_backend(jax.default_backend())

    def resolved_spp_chunk(self, devices: int = 1) -> int:
        """Samples per dispatched chunk; `devices` is the mesh size (each
        device gets about CHUNK_RAYS rays per chunk)."""
        if self.spp_chunk > 0:
            return min(self.spp_chunk, self.samples_aa)
        # Auto chunk size: big enough to amortize dispatch overhead, small
        # enough for responsive progress/abort (CHUNK_RAYS).
        import jax

        platform = jax.default_backend()
        resolve_backend(platform)  # unknown platforms raise here
        rays = CHUNK_RAYS[platform] * devices
        chunk = max(1, rays // (self.width * self.height))
        return min(chunk, self.samples_aa)


# Rays per auto-sized chunk and device. GPU: 8M rays are ~2.5 ms of
# megakernel time on an H100 -- fine-grained progress/abort, while async
# dispatch keeps the card fed -- and 1.6 GB of XLA-wavefront temporaries
# of the ~64 GB a process may use (PERF.md).
CHUNK_RAYS = {"cpu": 2 * 1024 * 1024, "gpu": 8 * 1024 * 1024}

# Backend per platform: the XLA wavefront on the CPU, the Pallas (Triton)
# megakernel on the GPU (PERF.md has the H100 comparison behind it).
PLATFORM_BACKENDS = {"cpu": "xla", "gpu": "pallas"}


def resolve_backend(platform: str) -> str:
    """The backend for a JAX platform name; unknown platforms are an error."""
    try:
        return PLATFORM_BACKENDS[platform]
    except KeyError:
        raise RuntimeError(
            f"no render backend for JAX platform {platform!r} "
            f"(supported: {', '.join(sorted(PLATFORM_BACKENDS))})"
        ) from None
