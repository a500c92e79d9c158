"""Benchmark: Cornell primary-ray throughput and the inverse-rendering step,
on the GPU.

    python bench.py

Prints ONE JSON line. Every record names the device it ran on (platform,
device_kind, device count, and the power limit nvidia-smi reports); with
no GPU the script fails instead of printing CPU numbers.

  metric/value/unit/vs_baseline : 512x512 Cornell Mrays/s (primary) on the
                                  session's backend for this platform,
                                  against the reference's 36 M primary
                                  paths/s anchor (BASELINE.md);
  mrays_1080p / spp_per_s_1080p : 1080p Cornell primary Mrays/s and
                                  samples-per-pixel per second;
  mrays_512_nee / _sobol        : the extension estimator and sampler;
  backend                       : which backend was timed;
  *_spread                      : (max - min) / min over the REPEATS
                                  chained repeats behind each rate;
  diff_* / diff_nee_*           : the InverseRenderer Adam step
                                  (value_and_grad through the wavefront).

Baseline anchor: the reference's best recorded Cornell run, 512x512 @ 16k
spp in 2 minutes on an unknown developer CPU ~= 36 M primary paths/s
(secondary bounce rays excluded on both sides). vs_baseline = ours / 36e6.
"""

from __future__ import annotations

import json
import subprocess
import time

BASELINE_PRIMARY_RAYS_PER_S = 36e6
MAX_DEPTH = 64
TIMED_CHUNKS = 4
REPEATS = 3


def require_gpu() -> None:
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX's platform is "
            f"{jax.default_backend()!r}"
        )


def device_record() -> dict:
    import jax

    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
    ).stdout.strip().splitlines()
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "power_limit": smi[0].split(",")[-1].strip() if smi else "unknown",
    }


def chunk_renderer(backend, scene, key, width, height, spp_chunk, spp_total,
                   sampler="uniform", mode="path", max_depth=MAX_DEPTH):
    """offset -> (H, W, 3) chunk sums on `backend` ("pallas" or "xla")."""
    import jax.numpy as jnp
    import numpy as np

    from cornelis.integrator import render_chunk
    from cornelis.ops.pallas_integrator import render_chunk_pallas

    fn = render_chunk_pallas if backend == "pallas" else render_chunk
    kw = dict(width=width, height=height, spp_chunk=spp_chunk,
              spp_total=spp_total, max_depth=max_depth, sampler=sampler,
              mode=mode)
    return lambda offset: fn(scene, key, jnp.asarray(np.uint32(offset)), **kw)


def measure_render(backend: str, width: int, height: int, spp_chunk: int,
                   sampler: str = "uniform", mode: str = "path",
                   scene=None) -> tuple:
    """(best primary rays/s, relative spread) over REPEATS repeats, each
    TIMED_CHUNKS chunk dispatches chained with one barrier at the end;
    compiling the chunk and the accumulating sum is untimed."""
    import jax

    from cornelis.rng import make_key
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import cornell_box

    scene = compile_scene(cornell_box()) if scene is None else scene
    chunk = chunk_renderer(
        backend, scene, make_key(), width, height, spp_chunk,
        spp_chunk * (TIMED_CHUNKS + 1), sampler, mode,
    )
    first = chunk(0)
    jax.block_until_ready(first + first)  # compile the kernel and the sum
    rates = []
    for _ in range(REPEATS):
        start = time.perf_counter()
        acc = None
        for i in range(TIMED_CHUNKS):
            out = chunk((i + 1) * spp_chunk)
            acc = out if acc is None else acc + out
        jax.block_until_ready(acc)
        elapsed = time.perf_counter() - start
        rates.append(width * height * spp_chunk * TIMED_CHUNKS / elapsed)
    best = max(rates)
    return best, (best - min(rates)) / min(rates)


def measure_diff(width: int = 256, height: int = 256, spp: int = 32,
                 max_depth: int = 16, mode: str = "path",
                 prefix: str = "diff") -> dict:
    """The InverseRenderer Adam step (albedo + roughness, dual-buffer MSE =
    2 renders per step) on Cornell: steps/s over chained steps with one
    barrier, and forward+backward primary Mrays/s."""
    import jax
    import jax.numpy as jnp

    from cornelis.diff.inverse import InverseRenderer
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import cornell_box

    inv = InverseRenderer(
        compile_scene(cornell_box()),
        jnp.zeros((height, width, 3), jnp.float32),
        fields=("mat_albedo", "mat_roughness"),
        width=width, height=height, spp=spp, max_depth=max_depth, mode=mode,
    )
    inv.step()  # compile + execute once
    steps = 8
    dt = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(inv.advance(steps))
        dt = min(dt, (time.perf_counter() - t0) / steps)
    rays_per_step = width * height * spp * 2
    return {
        f"{prefix}_shape": f"{width}x{height}x{spp}spp_d{max_depth}",
        f"{prefix}_steps_per_s": round(1.0 / dt, 3),
        f"{prefix}_fwd_bwd_mrays": round(rays_per_step / dt / 1e6, 3),
    }


def main() -> None:
    from cornelis.options import RenderOptions
    from cornelis.utils.cache import enable_persistent_cache

    require_gpu()
    enable_persistent_cache()
    backend = RenderOptions().resolved_backend()

    rays_512, spread_512 = measure_render(backend, 512, 512, 32)
    rays_1080p, spread_1080p = measure_render(backend, 1920, 1080, 4)
    rays_nee, spread_nee = measure_render(backend, 512, 512, 32, mode="nee")
    rays_sobol, spread_sobol = measure_render(
        backend, 512, 512, 32, sampler="sobol"
    )
    record = {
        "metric": "cornell_primary_rays",
        "value": round(rays_512 / 1e6, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(rays_512 / BASELINE_PRIMARY_RAYS_PER_S, 3),
        "backend": backend,
        "value_spread": round(spread_512, 3),
        "mrays_1080p": round(rays_1080p / 1e6, 3),
        "mrays_1080p_spread": round(spread_1080p, 3),
        "spp_per_s_1080p": round(rays_1080p / (1920 * 1080), 3),
        "mrays_512_nee": round(rays_nee / 1e6, 3),
        "mrays_512_nee_spread": round(spread_nee, 3),
        "mrays_512_sobol": round(rays_sobol / 1e6, 3),
        "mrays_512_sobol_spread": round(spread_sobol, 3),
        **measure_diff(),
        **measure_diff(mode="nee", prefix="diff_nee"),
        **device_record(),
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
