"""Command-line interface.

The reference ships a `cornelis` binary with NO argument parsing -- main()
ignores argv and renders the hard-coded Cornell box at 4096 spp to
"cornelisrender2.png" (src/cornelis.cpp:76-79, src/Render.cpp:264,307). We
keep that as the zero-argument default and lift every hardcoded knob into a
flag (SURVEY §5 "Config / flag system").

Usage:
    python -m cornelis                         # reference default render
    python -m cornelis --scene sphere-plane --spp 64 -o out.png
    python -m cornelis --scene my_scene.json --width 1024 --height 1024
    python -m cornelis --list-scenes
    python -m cornelis --dump-scene cornell    # emit builtin as JSON
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .options import RenderOptions
from .rng import DEFAULT_SEED
from .scene.description import SceneDescription
from .scene.library import BUILTIN_SCENES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cornelis",
        description="Differentiable Monte Carlo path tracer (JAX, GPU).",
    )
    p.add_argument(
        "--scene",
        default="cornell",
        help="Builtin scene name (see --list-scenes) or path to a scene "
        "JSON file. Default: cornell (the reference's shipped scene, "
        "src/cornelis.cpp:6-74).",
    )
    p.add_argument(
        "--spp",
        type=int,
        default=4096,
        help="Samples per pixel (reference main() uses 4096, "
        "src/cornelis.cpp:77).",
    )
    p.add_argument("--width", type=int, default=512, help="Image width (default 512).")
    p.add_argument("--height", type=int, default=512, help="Image height (default 512).")
    p.add_argument(
        "--max-depth",
        type=int,
        default=64,
        help="Bounce-depth safety bound on the RR-terminated path loop.",
    )
    p.add_argument("--seed", type=int, default=DEFAULT_SEED, help="RNG seed.")
    p.add_argument(
        "--spp-chunk",
        type=int,
        default=0,
        help="Samples per device dispatch (progress/abort/checkpoint grain); "
        "0 = auto (~2M rays per dispatch).",
    )
    p.add_argument(
        "-o",
        "--output",
        default="cornelisrender2.png",
        help="Output PNG path (reference hardcodes cornelisrender2.png, "
        "src/Render.cpp:264).",
    )
    p.add_argument(
        "--checkpoint",
        default=None,
        help="Checkpoint file: saved after every chunk, resumed from if it "
        "exists. Enables kill-and-resume progressive renders.",
    )
    p.add_argument(
        "--mesh",
        default=None,
        help="Device mesh shape 'TILESxSAMPLES' (e.g. 4x2): shard pixels "
        "over the tiles axis and spp over the samples axis. Default: "
        "single-device dispatch.",
    )
    p.add_argument(
        "--integrator",
        choices=("path", "nee"),
        default="path",
        help="Estimator: 'path' replicates the reference exactly "
        "(emission-at-every-hit, no light sampling); 'nee' adds next-event "
        "estimation toward emissive spheres and rectangle planes + the "
        "corrected sampler "
        "density -- far lower variance for small lights, unbiased apart "
        "from the per-bounce firefly clamp (see --nee-clamp; extension; "
        "runs on both the XLA and Pallas backends).",
    )
    p.add_argument(
        "--nee-clamp",
        type=float,
        default=None,
        metavar="RADIANCE",
        help="NEE firefly clamp: per-channel ceiling on any single "
        "bounce's radiance contribution in nee mode (depth-0 emitter "
        "sightings exempt). Default: scale-aware, 16x the scene's "
        "brightest emission channel. 'inf' disables clamping (fully "
        "unbiased NEE, fireflies included). Ignored in path mode.",
    )
    p.add_argument(
        "--time-budget",
        type=float,
        default=0.0,
        metavar="SECONDS",
        help="Progressive mode: stop after this many seconds (the "
        "reference's planned 'sample for x seconds', README Milestone 4); "
        "the image uses the samples actually taken. 0 = render all --spp.",
    )
    p.add_argument(
        "--tile-size",
        type=int,
        default=32,
        help="Image-tile edge for mesh pixel sharding (reference grain "
        "32x32, src/Render.cpp:327); 0 = flat row-band split. Only with "
        "--mesh.",
    )
    p.add_argument(
        "--backend",
        choices=("auto", "xla", "pallas"),
        default="auto",
        help="Compute backend: 'auto' follows the platform (XLA wavefront "
        "on the CPU, Pallas megakernel on the GPU); 'xla'/'pallas' force "
        "one path.",
    )
    p.add_argument(
        "--coordinator",
        default=None,
        metavar="HOST:PORT",
        help="Multi-host bring-up: jax.distributed coordinator address. "
        "Launch one process per host with identical flags except "
        "--process-id; the render then runs under a global mesh spanning "
        "every host's devices.",
    )
    p.add_argument(
        "--num-processes",
        type=int,
        default=None,
        help="Total number of processes in the multi-host job "
        "(with --coordinator).",
    )
    p.add_argument(
        "--process-id",
        type=int,
        default=None,
        help="This process's index in the multi-host job "
        "(with --coordinator).",
    )
    p.add_argument(
        "--standard-srgb",
        action="store_true",
        help="Use the standard sRGB 12.92 linear slope instead of the "
        "reference's 12.95 quirk (src/Color.cpp:47,68).",
    )
    p.add_argument(
        "--sampler",
        choices=("uniform", "sobol"),
        default="uniform",
        help="Sample sequence: 'uniform' (threefry, matches the reference's "
        "pseudo-random sampling in distribution) or 'sobol' "
        "(Owen-scrambled low-discrepancy; the reference's planned "
        "Milestone 5).",
    )
    p.add_argument(
        "--profile-dir",
        default=None,
        help="Write a jax.profiler trace of the render to this directory "
        "(view with TensorBoard / Perfetto).",
    )
    p.add_argument("--list-scenes", action="store_true", help="List builtin scenes and exit.")
    p.add_argument(
        "--dump-scene",
        metavar="NAME",
        default=None,
        help="Print a builtin scene as JSON (a starting point for custom "
        "scene files) and exit.",
    )
    p.add_argument("-q", "--quiet", action="store_true", help="Suppress progress logging.")
    return p


def load_scene(spec: str) -> SceneDescription:
    """Resolve a --scene argument: builtin name or JSON file path."""
    if spec in BUILTIN_SCENES:
        return BUILTIN_SCENES[spec]()
    if os.path.exists(spec):
        return SceneDescription.load(spec)
    raise SystemExit(
        f"error: unknown scene '{spec}' (not a builtin -- "
        f"{', '.join(sorted(BUILTIN_SCENES))} -- and no such file)"
    )


def parse_mesh(spec: Optional[str]) -> Optional[tuple]:
    if spec is None:
        return None
    try:
        parts = tuple(int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"error: bad --mesh '{spec}' (expected e.g. 4x2)")
    if len(parts) == 1:
        parts = (parts[0], 1)
    if len(parts) != 2 or any(x <= 0 for x in parts):
        raise SystemExit(f"error: bad --mesh '{spec}' (expected e.g. 4x2)")
    return parts


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_scenes:
        for name in sorted(BUILTIN_SCENES):
            print(name)
        return 0
    if args.dump_scene is not None:
        if args.dump_scene not in BUILTIN_SCENES:
            raise SystemExit(f"error: unknown builtin scene '{args.dump_scene}'")
        print(BUILTIN_SCENES[args.dump_scene]().to_json())
        return 0

    if args.quiet:
        from .utils.logging import logger

        logger.setLevel("WARNING")

    # Multi-host bring-up MUST precede any device query (jax.devices() in
    # make_mesh / backend init); initialize_distributed fails loudly on a
    # bad coordinator rather than hanging in the first collective.
    if args.coordinator is not None:
        from .parallel import initialize_distributed

        initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    scene = load_scene(args.scene)
    options = RenderOptions(
        samples_aa=args.spp,
        width=args.width,
        height=args.height,
        max_depth=args.max_depth,
        seed=args.seed,
        spp_chunk=args.spp_chunk,
        output=args.output,
        standard_srgb=args.standard_srgb,
        checkpoint=args.checkpoint,
        mesh_shape=parse_mesh(args.mesh),
        tile_size=args.tile_size,
        sampler=args.sampler,
        backend=args.backend,
        integrator=args.integrator,
        nee_clamp=args.nee_clamp,
        time_budget_s=args.time_budget,
    )
    options.validate()

    from .render import RenderSession, RenderStatus

    session = RenderSession(scene, options)

    if args.profile_dir:
        import jax

        with jax.profiler.trace(args.profile_dir):
            result = session.render()
    else:
        result = session.render()

    return 0 if result.status == RenderStatus.DONE else 1


if __name__ == "__main__":
    sys.exit(main())
