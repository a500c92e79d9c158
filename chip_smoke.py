#!/usr/bin/env python3
"""Smoke test on the GPU: the renderer and its trainer, end to end, on one
card (or, with --four, the mesh paths on four).

    python3 chip_smoke.py           # one card
    python3 chip_smoke.py --four    # only the 4-card mesh render + sharded step

One process drives the card; no child process imports JAX. Each phase
prints one line; any failed phase fails the run. With no GPU the script
exits non-zero before doing anything. The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Single-card phases:
  card / device      nvidia-smi's name + power limit; what JAX reports
  cold_start         megakernel compile (compile cache off) and its first
                     execution, timed apart
  rate_*             megakernel and XLA wavefront Mrays/s on the bench cells
  parity_*           megakernel vs wavefront on shared sobol draws (512^2)
  session_path       RenderSession, Cornell 512^2 x 4096 spp, path/uniform,
                     vs the committed goldens region by region
  cli_nee_sobol      python -m cornelis's main(), same frame, nee/sobol
  session_1080p      one 1080p frame
  train_path/_nee    InverseRenderer Adam steps, 256^2 material recovery
  grad_fd            one step's gradient vs a central finite difference
  memory             compiled memory of an 8M-ray chunk, peak bytes in use
  gpu_tests          the tests marked `gpu`, run in this process
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
FAILED: list = []


def say(name: str, ok: bool = True, **fields) -> None:
    vals = " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in fields.items()
    )
    print(f"{name}: {'ok' if ok else 'FAIL'} {vals}".rstrip(), flush=True)
    if not ok:
        FAILED.append(name)


def phase(name: str, fn) -> None:
    """Run one phase; an exception fails it (and the run) with its trace."""
    try:
        fn()
    except Exception:
        say(name, False, error=traceback.format_exc(limit=6).replace("\n", " | "))


def check(name: str, ok: bool, **fields) -> None:
    say(name, bool(ok), **fields)


# -- shared helpers ---------------------------------------------------------


def block_means(img, grid):
    h, w, c = img.shape
    return img.reshape(grid, h // grid, grid, w // grid, c).mean(axis=(1, 3))


def golden_regions(srgb8):
    """GOLDEN_512.md's method: linearize the 8-bit images through the
    reference's 12.95-variant sRGB decode, compare 16x16 region means on
    the regions where the reference golden does not clip."""
    import jax.numpy as jnp
    import numpy as np

    from cornelis.math.color import srgb_decode
    from cornelis.utils.png import read_png

    def linear(raw8):
        return np.asarray(
            srgb_decode(jnp.asarray(raw8.astype(np.float32) / 255.0), standard=False)
        )

    gdir = os.path.join(HERE, "tests", "golden")
    ref8 = read_png(os.path.join(gdir, "reference_cornell_512.png"))
    ours_golden = linear(read_png(os.path.join(gdir, "ours_cornell_512.png")))
    grid = 16
    gh = 512 // grid
    clean = (ref8.max(axis=-1) >= 250).reshape(grid, gh, grid, gh).mean(axis=(1, 3)) < 0.001
    live = block_means(linear(srgb8), grid)
    vs_ref = live - block_means(linear(ref8), grid)
    vs_ours = live - block_means(ours_golden, grid)
    return (
        float(np.abs(vs_ref).max(axis=-1)[clean].max()),
        vs_ref[clean].mean(axis=0),
        float(np.abs(vs_ours).max(axis=-1)[clean].max()),
        int(clean.sum()),
    )


def sobol_parity(scene, mode, width=512, spp=8):
    """Megakernel vs XLA wavefront on identical sobol draws: per-channel
    image means, the median per-pixel relative difference, and the share
    of pixels whose sums differ by more than 1e-3 relative."""
    import jax
    import numpy as np

    from bench import chunk_renderer
    from cornelis.rng import make_key

    key = make_key(9)
    args = (scene, key, width, width, spp, spp, "sobol", mode)
    with jax.default_matmul_precision("highest"):
        a = np.asarray(chunk_renderer("pallas", *args)(0))
        b = np.asarray(chunk_renderer("xla", *args)(0))
    rel = np.abs(a - b) / (np.abs(b) + 1.0)
    mean_rel = float(
        np.max(np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1))) / b.mean(axis=(0, 1)))
    )
    return (
        bool(np.isfinite(a).all()),
        mean_rel,
        float(np.median(rel)),
        float((rel.max(axis=-1) > 1e-3).mean()),
    )


# -- single-card phases -----------------------------------------------------


def phase_cold_start():
    import jax
    import numpy as np

    from cornelis.ops import pallas_integrator as pk
    from cornelis.rng import make_key
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import cornell_box

    host = pk.scene_to_host(compile_scene(cornell_box()))
    fn = pk._build_chunk_fn(
        host, 512, 512, 64, 32, pk.DEFAULT_BLOCK, pk.DEFAULT_WARPS, False,
        "uniform", 12, "path", pk._host_nee_clamp(host),
    )
    key, off = make_key(), np.uint32(0)
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        t0 = time.perf_counter()
        compiled = fn.lower(key, off).compile()
        t_compile = time.perf_counter() - t0
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(key, off))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(compiled(key, np.uint32(32)))
    t_second = time.perf_counter() - t0
    check("cold_start", True, kernel="cornell_512x512x32_path",
          compile_s=t_compile, first_exec_s=t_first, second_exec_s=t_second)


def phase_rates(kind):
    from bench import measure_render

    cells = {
        "512_path": (512, 512, 32, "uniform", "path"),
        "512_nee": (512, 512, 32, "uniform", "nee"),
        "512_sobol": (512, 512, 32, "sobol", "path"),
        "1080p_path": (1920, 1080, 4, "uniform", "path"),
    }
    for cell, (w, h, spp, sampler, mode) in cells.items():
        def run(cell=cell, w=w, h=h, spp=spp, sampler=sampler, mode=mode):
            k, ks = measure_render("pallas", w, h, spp, sampler, mode)
            x, xs = measure_render("xla", w, h, spp, sampler, mode)
            check(f"rate_{cell}", k > 0 and x > 0, card=kind,
                  kernel_mrays=k / 1e6, kernel_spread=ks,
                  xla_mrays=x / 1e6, xla_spread=xs, kernel_over_xla=k / x)
        phase(f"rate_{cell}", run)


def phase_parity():
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import cornell_box, sdf_gallery

    # Tolerances: both backends run sampling.py's sobol pipeline on the
    # same (pixel, sample, stream) keys, so paths are identical until a
    # knife-edge decision (RR, closest hit, lobe choice) lands within the
    # ulp-level gap between Triton's (libdevice) and XLA's lowerings. Those
    # paths then decorrelate, so agreement is: the typical pixel matches
    # to float precision (median), each channel's image mean within 0.5%
    # (the heavy-tailed MC noise of the decorrelated share: path mode's
    # fireflies move one 8-spp pixel sum by up to ~160x), and a bounded
    # share of pixels carries a decorrelated path (measured on the H100:
    # path 0.6%, sdf_gallery 0.006%, nee 11%).
    cases = {
        "path": (cornell_box, "path", 0.02),
        "nee": (cornell_box, "nee", 0.25),
        "sdf_gallery": (sdf_gallery, "path", 0.02),
    }
    for name, (maker, mode, max_share) in cases.items():
        def run(maker=maker, mode=mode, max_share=max_share, name=name):
            finite, mean_rel, med, share = sobol_parity(compile_scene(maker()), mode)
            check(f"parity_{name}", finite and mean_rel < 5e-3 and med < 1e-5
                  and share < max_share, mean_rel=mean_rel, median_rel=med,
                  share_px_gt_1e3=share, max_share=max_share)
        phase(f"parity_{name}", run)


def phase_session_path():
    import numpy as np

    from cornelis.options import RenderOptions
    from cornelis.render import RenderSession, RenderStatus
    from cornelis.scene.library import cornell_box

    opts = RenderOptions(samples_aa=4096, output=os.path.join(OUT_DIR, "smoke_path_512.png"))
    t0 = time.perf_counter()
    res = RenderSession(cornell_box(), opts).render()
    dt = time.perf_counter() - t0
    img = res.image
    ref_max, bias, ours_max, n_clean = golden_regions(res.film.to_srgb8())
    # Bounds from GOLDEN_512.md / tests/test_golden_512.py: vs the reference
    # binary, clean regions within 0.085 and a mean signed offset in
    # (-0.005, 0.03) (its known self-intersection energy loss); vs our own
    # 16k-spp golden, MC noise only.
    ok = (res.status == RenderStatus.DONE and img.shape == (512, 512, 3)
          and np.isfinite(img).all() and ref_max < 0.085
          and bool(np.all(bias > -0.005) and np.all(bias < 0.03))
          and ours_max < 0.03)
    check("session_path", ok, backend=res.backend, seconds=dt,
          mrays_primary=512 * 512 * 4096 / dt / 1e6, clean_regions=n_clean,
          max_diff_vs_reference=ref_max, bias_vs_reference=np.round(bias, 4).tolist(),
          max_diff_vs_ours_16k=ours_max)


def phase_cli():
    import numpy as np

    from cornelis.cli import main as cli_main
    from cornelis.utils.png import read_png

    out = os.path.join(OUT_DIR, "smoke_nee_sobol_512.png")
    t0 = time.perf_counter()
    rc = cli_main(["--spp", "4096", "--integrator", "nee", "--sampler", "sobol",
                   "-o", out, "--quiet"])
    dt = time.perf_counter() - t0
    px = read_png(out)
    check("cli_nee_sobol", rc == 0 and px.shape == (512, 512, 3) and px.mean() > 10,
          seconds=dt, png_mean=float(px.mean()))


def phase_1080p():
    import numpy as np

    from cornelis.options import RenderOptions
    from cornelis.render import RenderSession, RenderStatus
    from cornelis.scene.library import cornell_box

    opts = RenderOptions(samples_aa=1024, width=1920, height=1080,
                         output=os.path.join(OUT_DIR, "smoke_1080p.png"))
    t0 = time.perf_counter()
    res = RenderSession(cornell_box(), opts).render()
    dt = time.perf_counter() - t0
    check("session_1080p", res.status == RenderStatus.DONE
          and np.isfinite(res.image).all() and res.image.mean() > 0.1,
          backend=res.backend, seconds=dt,
          mrays_primary=1920 * 1080 * 1024 / dt / 1e6)


def phase_train(mode):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cornelis.diff import InverseRenderer, render_diff
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import cornell_box

    # PERF.md's material recovery: the true Cornell albedos render the
    # target; training starts from flat grey albedo.
    truth = compile_scene(cornell_box())
    kw = dict(width=256, height=256, max_depth=16, mode=mode)
    target = render_diff(truth, jax.random.key(123), spp=256, **kw)
    grey = truth.mat_albedo._replace(
        **{c: jnp.full_like(getattr(truth.mat_albedo, c), 0.5) for c in "xyz"}
    )
    start = truth._replace(mat_albedo=grey)
    inv = InverseRenderer(start, target, fields=("mat_albedo", "mat_roughness"),
                          spp=32, **kw)

    def albedo_err(scene):
        a = scene.mat_albedo
        t = truth.mat_albedo
        return float(np.mean([np.abs(np.asarray(getattr(a, c)) - np.asarray(getattr(t, c))).mean()
                              for c in "xyz"]))

    err0 = albedo_err(inv.scene())
    t0 = time.perf_counter()
    first = inv.step()
    t_first = time.perf_counter() - t0
    steps = 10
    t0 = time.perf_counter()
    last = float(inv.advance(steps))
    dt = (time.perf_counter() - t0) / steps
    err = albedo_err(inv.scene())
    check(f"train_{mode}", np.isfinite(first) and np.isfinite(last) and err < err0,
          first_step_s=t_first, step_ms=dt * 1e3, loss_first=first,
          loss_last=last, albedo_mae_start=err0, albedo_mae_after=err)


def phase_grad_fd():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cornelis.diff import render_diff
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import cornell_box

    # tests/test_diff.py's finite-difference check, on the card: the
    # estimator is deterministic given the key, so a central difference
    # with the same key checks the gradient to O(eps^2) plus f32 noise.
    # Depth 4 keeps RR kill boundaries out of the FD window; 5% is that
    # test's tolerance for the same reason.
    scene = compile_scene(cornell_box())
    key = jax.random.key(5)

    def mean_img(albedo_x):
        sc = scene._replace(mat_albedo=scene.mat_albedo._replace(x=albedo_x))
        return jnp.mean(render_diff(sc, key, width=64, height=64, spp=16, max_depth=4))

    x0 = scene.mat_albedo.x
    with jax.default_matmul_precision("highest"):
        g = float(jax.grad(mean_img)(x0)[1])
        eps = 1e-2
        fd = float((mean_img(x0.at[1].add(eps)) - mean_img(x0.at[1].add(-eps))) / (2 * eps))
    rel = abs(g - fd) / max(abs(fd), 1e-6)
    check("grad_fd", np.isfinite(g) and rel < 0.05, grad=g, fd=fd, rel_err=rel)


def phase_memory():
    import jax
    import numpy as np

    from cornelis.integrator import render_chunk
    from cornelis.ops import pallas_integrator as pk
    from cornelis.rng import make_key
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import cornell_box

    scene = compile_scene(cornell_box())
    key, off = make_key(), np.uint32(0)
    xla = jax.jit(lambda k, o: render_chunk(
        scene, k, o, width=512, height=512, spp_chunk=32, spp_total=4096,
        max_depth=64)).lower(key, off).compile().memory_analysis()
    host = pk.scene_to_host(scene)
    kern = pk._build_chunk_fn(
        host, 512, 512, 64, 32, pk.DEFAULT_BLOCK, pk.DEFAULT_WARPS, False,
        "uniform", 12, "path", pk._host_nee_clamp(host),
    ).lower(key, off).compile().memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    check("memory", True, chunk_rays=512 * 512 * 32,
          xla_temp_bytes=xla.temp_size_in_bytes,
          kernel_temp_bytes=kern.temp_size_in_bytes,
          bytes_limit=stats.get("bytes_limit", -1),
          peak_bytes_in_use=stats.get("peak_bytes_in_use", -1))


def phase_gpu_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")])
    check("gpu_tests", rc == 0, pytest_rc=int(rc))


# -- four-card phases -------------------------------------------------------


def phase_four_mesh(frame=(512, 512, 64), scaling=(1920, 1080, 1024)):
    import jax
    import numpy as np

    from cornelis.options import RenderOptions
    from cornelis.render import RenderSession
    from cornelis.scene.library import cornell_box

    def render(mesh_shape, width, height, spp, spp_chunk=0):
        opts = RenderOptions(samples_aa=spp, spp_chunk=spp_chunk, width=width,
                             height=height, sampler="sobol", output=None,
                             mesh_shape=mesh_shape)
        session = RenderSession(cornell_box(), opts)
        session.render()  # compile
        t0 = time.perf_counter()
        res = session.render()
        return res.image, time.perf_counter() - t0

    one, _ = render(None, *frame, spp_chunk=frame[2])
    for shape in ((4, 1), (2, 2)):
        img, _ = render(shape, *frame, spp_chunk=frame[2])
        # Same kernel, same (pixel, sample)-keyed draws on every card; only
        # the samples-axis psum reorders float sums.
        err = float(np.max(np.abs(img - one) / (np.abs(one) + 1.0)))
        check(f"mesh_{shape[0]}x{shape[1]}", err < 1e-5, max_rel_vs_1card=err)
    # Scaling of a whole session render with default chunking (each card
    # gets ~8M rays per chunk).
    _, t1 = render(None, *scaling)
    _, t4 = render((4, 1), *scaling)
    rays = scaling[0] * scaling[1] * scaling[2]
    check("mesh_scaling", True, frame="x".join(map(str, scaling)),
          cards=len(jax.devices()), mrays_1card=rays / t1 / 1e6,
          mrays_4cards=rays / t4 / 1e6, speedup=t1 / t4)


def phase_four_sharded_step(size=128):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from cornelis.diff.inverse import extract_params
    from cornelis.diff.sharded import make_sharded_train_step
    from cornelis.parallel import make_mesh
    from cornelis.rng import make_key
    from cornelis.scene.compile import compile_scene
    from cornelis.scene.library import cornell_box

    scene = compile_scene(cornell_box())
    kw = dict(width=size, height=size, spp=16, max_depth=8)
    target = jnp.zeros((size, size, 3), jnp.float32)
    opt = optax.adam(1e-2)
    params = extract_params(scene, ("mat_albedo", "mat_roughness"))

    def step(shape):
        mesh = make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])
        fn = make_sharded_train_step(scene, target, mesh, opt, **kw)
        new, _, loss = fn(params, opt.init(params), make_key(0))
        return [np.asarray(x) for x in jax.tree.leaves(new)], float(loss)

    with jax.default_matmul_precision("highest"):
        ref, ref_loss = step((1, 1))
        for shape in ((4, 1), (2, 2)):
            got, loss = step(shape)
            err = max(float(np.max(np.abs(a - b))) for a, b in zip(got, ref))
            check(f"sharded_step_{shape[0]}x{shape[1]}",
                  abs(loss - ref_loss) <= 1e-4 * abs(ref_loss) + 1e-6 and err < 1e-5,
                  loss=loss, loss_1card=ref_loss, max_param_diff=err)


# -- driver -----------------------------------------------------------------


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card mesh render and sharded step")
    args = parser.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(jax.devices()) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(jax.devices())}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, HERE)
    from cornelis.utils.cache import enable_persistent_cache

    os.makedirs(OUT_DIR, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = jax.devices()[0]
    say("device", platform=dev.platform, kind=dev.device_kind.replace(" ", "_"),
        count=len(jax.devices()), compile_cache=enable_persistent_cache())

    if args.four:
        phase("mesh", phase_four_mesh)
        phase("sharded_step", phase_four_sharded_step)
    else:
        phase("cold_start", phase_cold_start)
        phase_rates(dev.device_kind.replace(" ", "_"))
        phase_parity()
        phase("session_path", phase_session_path)
        phase("cli_nee_sobol", phase_cli)
        phase("session_1080p", phase_1080p)
        phase("train_path", lambda: phase_train("path"))
        phase("train_nee", lambda: phase_train("nee"))
        phase("grad_fd", phase_grad_fd)
        phase("memory", phase_memory)
        phase("gpu_tests", phase_gpu_tests)

    if FAILED:
        print(f"chip_smoke: FAILED phases: {', '.join(FAILED)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
