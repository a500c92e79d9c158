"""Measured path-length histogram (PERF.md section 3 upgrade).

PERF.md's "~4.3 segments per camera ray" was the Russian-roulette
EXPECTATION, not a measurement; the roofline in section 4 multiplies it by
an ops/segment hand count, so its uncertainty propagates straight into the
"fraction of peak" claim. This tool MEASURES the distribution: it
re-runs the real integrator bounce loop (integrator._bounce -- same
physics, draws, RR decisions as a render with the same seed) and counts
live rays at every depth on-device. mean segments/ray = sum(alive_d)/N.

Runs on CPU or GPU (the distribution is backend-invariant for the uniform
sampler in distribution; a fixed seed gives a deterministic count here).

  python benchmarks/path_length.py [scene] [spp]
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

W = H = 256
MAX_DEPTH = 64


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cornelis.camera import generate_rays
    from cornelis.integrator import PathState, _bounce
    from cornelis.math.vec import RGB, Vec3
    from cornelis.rng import STREAM_CAMERA, make_key, make_ray_streams, stream_uniforms
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import BUILTIN_SCENES

    scene_name = sys.argv[1] if len(sys.argv) > 1 else "cornell"
    spp = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    scene = compile_scene(BUILTIN_SCENES[scene_name]())

    @jax.jit
    def alive_counts(key):
        num_px = W * H
        pixel_ids = jnp.arange(num_px, dtype=jnp.uint32)
        px = jnp.repeat(pixel_ids, spp)
        si = jnp.tile(jnp.arange(spp, dtype=jnp.uint32), num_px)
        streams = make_ray_streams(key, px, si, spp)
        cam_u = stream_uniforms(streams, STREAM_CAMERA, 2, "uniform", 32)
        i = (px % W).astype(jnp.float32)
        j = (px // W).astype(jnp.float32)
        x = (i + cam_u[:, 0]) * (1.0 / W)
        y = (j + cam_u[:, 1]) * (1.0 / H)
        origin, direction = generate_rays(scene.camera, x, y)
        ones = jnp.ones_like(origin.x)
        zeros = jnp.zeros_like(origin.x)
        state = PathState(
            origin=origin,
            direction=direction,
            throughput=RGB(ones, ones, ones),
            radiance=RGB(zeros, zeros, zeros),
            active=ones.astype(bool),
            depth=jnp.zeros((), jnp.int32),
            streams=streams,
            prev_pdf=ones,
        )

        def body(d, carry):
            state, counts = carry
            counts = counts.at[d].set(jnp.sum(state.active))
            state = _bounce(scene, state)
            return state, counts

        _, counts = jax.lax.fori_loop(
            0, MAX_DEPTH, body, (state, jnp.zeros(MAX_DEPTH, jnp.int32))
        )
        return counts

    counts = np.asarray(alive_counts(make_key()))
    n = W * H * spp
    mean_segments = counts.sum() / n
    # alive_d counts rays entering bounce d, i.e. rays that trace segment d.
    record = {
        "scene": scene_name,
        "rays": int(n),
        "mean_segments_per_ray": round(float(mean_segments), 4),
        "p50_depth": int(np.searchsorted(-counts, -n // 2)),
        "max_observed_depth": int(np.max(np.nonzero(counts)[0])) if counts.any() else 0,
        "alive_by_depth_frac": [round(float(c) / n, 6) for c in counts[:24]],
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
