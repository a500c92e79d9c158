"""Pallas megakernel for the GPU: the whole path-trace bounce loop per ray
block, with every ray's state in registers.

Why: the XLA wavefront's `lax.while_loop` carries the full path state
(~70 B/ray) through device memory on every bounce, and every bounce runs
until the single longest path in the whole dispatch has ended. This kernel
gives each program one small block of rays (Triton, `backend="triton"`)
that lives in registers for its entire path life: device-memory traffic
collapses to the 8 B/ray of (pixel, sample) ids in and 12 B/ray of
radiance out. Two further structural wins:

  * per-block early exit -- each program's while_loop ends when ITS rays
    die, so the long tail of the path-length distribution no longer
    stalls the whole wavefront;
  * scene tables and camera are baked in as compile-time constants (one
    recompile per scene, amortized over every chunk of a session) -- the
    object loop unrolls to straight-line code with no gathers.

The physics code is shared with the XLA path: geometry.sphere_candidate /
plane_candidate, materials.layered_sample, math.vec -- all elementwise jnp
that traces identically inside the kernel. Only RNG differs mechanically:
jax.random's key machinery doesn't exist in-kernel, so uniform draws come
from an explicit Threefry-2x32 (ops/threefry.py) keyed by (root key,
pixel, sample, stream) -- same determinism guarantee (chunk/shard/order-
invariant), same [0,1) quantization, different bits; renders agree with
the XLA path in distribution (tests/test_pallas.py). Sobol draws are
bit-identical to the XLA path's.

Reference mapping: this is the accelerator form of the reference's hot
loop (src/Render.cpp:220-255 integrateTile + src/Geometry.cpp kernels),
where a program's ray block plays the role of the reference's per-thread
tile (SURVEY §7).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..camera import Camera, generate_rays
from ..geometry import plane_candidate, sdf_candidate
from ..integrator import (
    BOUNCE_EPSILON,
    NEE_CLAMP_FACTOR,
    nee_clamp_at_depth,
    russian_roulette_probability,
)
from ..materials import (
    MaterialParams,
    layered_eval,
    layered_pdf_true,
    layered_sample,
)
from ..math.vec import PI, RGB, Vec3, construct_basis, dot, normalize, ray_at
from ..scene.compile import SceneArrays
from .threefry import pair_uniforms

Array = jnp.ndarray

# Rays per program and warps per program: one ray per thread, one warp per
# program -- the finest per-program early exit (H100 sweep in PERF.md:
# Cornell path 3534 Mrays/s at 32/1, 3305 at 64/2, 3021 at 128/4, 2753 at
# 256/8; NEE, sphere_grid(64) and sdf_gallery fall the same way).
DEFAULT_BLOCK = 32
DEFAULT_WARPS = 1


class HostScene(NamedTuple):
    """Scene tables as hashable host tuples (compile-time kernel constants)."""

    camera: tuple  # (eye, corner, u, v) each an (x, y, z) float tuple
    spheres: tuple  # rows (cx, cy, cz, radius, material_id)
    planes: tuple  # rows (nx, ny, nz, px, py, pz, width, height, material_id)
    materials: tuple  # rows (albedo3, emission3, tint3, roughness, ior)
    sdfs: tuple = ()  # rows (kind, cx, cy, cz, (p0, p1, p2, p3), material_id)


# scene_to_host memo: a session dispatches many chunks of one scene, and
# each would otherwise fetch and convert the tables again. Keyed by object
# identity; the stored strong reference keeps the id from being reused
# while the entry lives.
_HOST_SCENE_MEMO: dict[int, tuple] = {}


def host_scene_from_description(descr) -> "HostScene":
    """Kernel scene tables straight from a SceneDescription, compiled on the
    CPU backend (no device round-trip)."""
    from ..scene.compile import compile_scene

    # local_devices, NOT jax.devices(): in a multi-process job the global
    # device list starts with rank 0's devices.
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        return _to_host_tables(jax.device_get(compile_scene(descr)))


def scene_to_host(scene: SceneArrays) -> HostScene:
    memo = _HOST_SCENE_MEMO.get(id(scene))
    if memo is not None and memo[0] is scene:
        return memo[1]
    # ONE bulk device_get of the whole pytree: one transfer, not one per
    # leaf.
    host = _to_host_tables(jax.device_get(scene))
    while len(_HOST_SCENE_MEMO) >= 16:
        _HOST_SCENE_MEMO.pop(next(iter(_HOST_SCENE_MEMO)))  # oldest first
    _HOST_SCENE_MEMO[id(scene)] = (scene, host)
    return host


def _to_host_tables(scene) -> HostScene:
    """Host pytree (numpy leaves) -> hashable HostScene tuples."""
    g = lambda a: np.asarray(a)

    def v3(v) -> tuple:
        return (float(g(v.x)), float(g(v.y)), float(g(v.z)))

    cam = (v3(scene.camera.eye), v3(scene.camera.corner), v3(scene.camera.u), v3(scene.camera.v))
    sph = tuple(
        (
            float(g(scene.sphere_center.x)[i]),
            float(g(scene.sphere_center.y)[i]),
            float(g(scene.sphere_center.z)[i]),
            float(g(scene.sphere_radius)[i]),
            int(g(scene.sphere_material)[i]),
        )
        for i in range(scene.num_spheres)
    )
    pln = tuple(
        (
            float(g(scene.plane_normal.x)[i]),
            float(g(scene.plane_normal.y)[i]),
            float(g(scene.plane_normal.z)[i]),
            float(g(scene.plane_point.x)[i]),
            float(g(scene.plane_point.y)[i]),
            float(g(scene.plane_point.z)[i]),
            float(g(scene.plane_width)[i]),
            float(g(scene.plane_height)[i]),
            int(g(scene.plane_material)[i]),
        )
        for i in range(scene.num_planes)
    )
    mats = tuple(
        (
            (float(g(scene.mat_albedo.x)[i]), float(g(scene.mat_albedo.y)[i]), float(g(scene.mat_albedo.z)[i])),
            (float(g(scene.mat_emission.x)[i]), float(g(scene.mat_emission.y)[i]), float(g(scene.mat_emission.z)[i])),
            (float(g(scene.mat_tint.x)[i]), float(g(scene.mat_tint.y)[i]), float(g(scene.mat_tint.z)[i])),
            float(g(scene.mat_roughness)[i]),
            float(g(scene.mat_ior)[i]),
        )
        for i in range(scene.num_materials)
    )
    sdfs = tuple(
        (
            int(g(scene.sdf_kind)[i]),
            float(g(scene.sdf_center.x)[i]),
            float(g(scene.sdf_center.y)[i]),
            float(g(scene.sdf_center.z)[i]),
            tuple(float(v) for v in g(scene.sdf_params)[i]),
            int(g(scene.sdf_material)[i]),
            tuple(tuple(float(v) for v in row) for row in g(scene.sdf_rot)[i]),
            float(g(scene.sdf_scale)[i]),
        )
        for i in range(scene.num_sdfs)
    )
    return HostScene(camera=cam, spheres=sph, planes=pln, materials=mats, sdfs=sdfs)


def _const_camera(cam: tuple) -> Camera:
    # Plain Python floats: they embed as jaxpr literals (Pallas rejects
    # kernels that capture concrete jnp arrays).
    eye, corner, u, v = cam
    mk = lambda t: Vec3(float(t[0]), float(t[1]), float(t[2]))
    return Camera(eye=mk(eye), corner=mk(corner), u=mk(u), v=mk(v))


def _splat(v: tuple, like: Array) -> Vec3:
    """A baked constant vector as per-ray arrays. The plane basis
    (construct_basis) selects on its normal; Triton's lowering mistypes a
    0-d select between literals, so constant normals enter as vectors
    (the compiler folds the splat arithmetic back to constants)."""
    return Vec3(*(jnp.full_like(like, c) for c in v))


def _intersect_const(scene: HostScene, o: Vec3, d: Vec3):
    """Closest hit against the baked scene tables: fully unrolled object
    loop (spheres then planes, strict best_t > t update -- the semantics of
    geometry._update_closest / src/Render.cpp:110-150). Also tracks the
    UNIFIED emitter-candidate index of the closest hit (sphere i -> i,
    plane j -> S + j, SDFs/miss -> -1), aligned with _light_table row
    order -- the NEE mode's MIS weights key off it."""
    from ..geometry import min_hit_t

    zero = jnp.zeros_like(o.x)
    tmin = min_hit_t(o, d)  # hoisted out of the unrolled object loop
    best_t = jnp.full_like(o.x, jnp.inf)
    hit_any = zero.astype(bool)
    bp = Vec3(zero, zero, zero)
    bn = Vec3(zero, zero, zero)
    bm = zero.astype(jnp.int32)
    bs = jnp.full_like(bm, -1)

    def update(best, cand, sphere_idx=-1):
        best_t, hit_any, bp, bn, bm, bs = best
        t, p, n, valid, mid = cand
        closer = valid & (best_t > t)
        sel = lambda a, b: jnp.where(closer, a, b)
        return (
            sel(t, best_t),
            hit_any | closer,
            Vec3(sel(p.x, bp.x), sel(p.y, bp.y), sel(p.z, bp.z)),
            Vec3(sel(n.x, bn.x), sel(n.y, bn.y), sel(n.z, bn.z)),
            jnp.where(closer, mid, bm),
            jnp.where(closer, sphere_idx, bs),
        )

    # SPHERES: two-phase scan. Phase 1 tracks only (best_t, best index) --
    # sphere_candidate_t is bitwise-equal to sphere_candidate's root --
    # and phase 2 materializes the winning sphere's position/normal/
    # material ONCE via masked constant-FMA accumulation, instead of a
    # ray_at + normalize + 6-wide select chain per candidate. The index
    # rides in f32 (exact to 2^24).
    from ..geometry import _degenerate, sphere_candidate_t
    from ..math.vec import mag2

    # Per-RAY quantities hoisted out of the unrolled object loop (same
    # expressions -> bitwise-identical; saves ~8 ops x n_spheres per
    # bounce where the kernel lowering does not CSE across the unroll).
    deg = _degenerate(d)
    a = jnp.where(deg, 1.0, mag2(d))

    s_best_t = best_t
    s_best = jnp.full_like(o.x, -1.0)
    for s_idx, (cx, cy, cz, rad, _mid) in enumerate(scene.spheres):
        t, valid = sphere_candidate_t(
            o, d, Vec3(cx, cy, cz), rad, tmin=tmin, pre=(deg, a)
        )
        closer = valid & (s_best_t > t)
        s_best_t = jnp.where(closer, t, s_best_t)
        s_best = jnp.where(closer, float(s_idx), s_best)

    if scene.spheres:
        sp_hit = s_best >= 0.0
        g_cx = zero
        g_cy = zero
        g_cz = zero
        g_mid = zero
        for s_idx, (cx, cy, cz, _rad, mid) in enumerate(scene.spheres):
            mf = (s_best == float(s_idx)).astype(jnp.float32)
            g_cx = g_cx + mf * cx
            g_cy = g_cy + mf * cy
            g_cz = g_cz + mf * cz
            g_mid = g_mid + mf * float(mid)
        p = ray_at(o, d, jnp.where(sp_hit, s_best_t, 0.0))
        # Mask BEFORE normalize: miss lanes would normalize the zero
        # vector (p - center = 0) into NaN.
        rel = Vec3(
            jnp.where(sp_hit, p.x - g_cx, 1.0),
            jnp.where(sp_hit, p.y - g_cy, 0.0),
            jnp.where(sp_hit, p.z - g_cz, 0.0),
        )
        n = normalize(rel)
        sel = lambda a, b: jnp.where(sp_hit, a, b)
        state = (
            s_best_t,
            sp_hit,
            Vec3(sel(p.x, zero), sel(p.y, zero), sel(p.z, zero)),
            Vec3(sel(n.x, zero), sel(n.y, zero), sel(n.z, zero)),
            jnp.where(sp_hit, g_mid, 0.0).astype(jnp.int32),
            jnp.where(sp_hit, s_best, -1.0).astype(jnp.int32),
        )
    else:
        state = (best_t, hit_any, bp, bn, bm, bs)
    n_sph = len(scene.spheres)
    for p_idx, (nx, ny, nz, px, py, pz, w, h, mid) in enumerate(scene.planes):
        normal = _splat((nx, ny, nz), o.x)
        point = Vec3(px, py, pz)
        t, p, n, valid = plane_candidate(o, d, normal, point, w, h, tmin=tmin)
        # Unified prim index: spheres 0..S-1, planes S..S+P-1 -- aligned
        # with _light_table row order (the NEE MIS weights key off it).
        state = update(state, (t, p, n, valid, mid), n_sph + p_idx)
    for kind, cx, cy, cz, params, mid, rot, scale in scene.sdfs:
        # Shared sphere-trace with the XLA path (geometry.sdf_candidate);
        # kind/params/rot/scale embed as literals, the march's fori_loop
        # stays a loop (not unrolled) in the kernel.
        t, p, n, valid = sdf_candidate(
            o, d, kind, Vec3(cx, cy, cz), params, rot=rot, scale=scale
        )
        state = update(state, (t, p, n, valid, mid))
    best_t, hit_any, bp, bn, bm, bs = state
    return best_t, bp, bn, bm, hit_any, bs


def _occluded_const(scene: HostScene, o: Vec3, d: Vec3, t_max):
    """ANY-hit-within-distance over the baked tables (geometry.occluded's
    kernel twin): the NEE shadow ray needs only a boolean, so this skips
    the position/normal/material/prim best-hit select chain per object --
    and the per-candidate hit-point/normal math entirely via
    sphere_candidate_t with the per-ray (deg, a) hoisted."""
    from ..geometry import _degenerate, min_hit_t, sphere_candidate_t
    from ..math.vec import mag2

    tmin = min_hit_t(o, d)
    deg = _degenerate(d)
    a = jnp.where(deg, 1.0, mag2(d))
    occ = jnp.zeros_like(o.x, dtype=bool)
    for cx, cy, cz, rad, _mid in scene.spheres:
        t, valid = sphere_candidate_t(
            o, d, Vec3(cx, cy, cz), rad, tmin=tmin, pre=(deg, a)
        )
        occ = occ | (valid & (t < t_max))
    for nx, ny, nz, px, py, pz, w, h, _mid in scene.planes:
        t, _p, _n, valid = plane_candidate(
            o, d, _splat((nx, ny, nz), o.x), Vec3(px, py, pz), w, h, tmin=tmin
        )
        occ = occ | (valid & (t < t_max))
    for kind, cx, cy, cz, params, _mid, rot, scale in scene.sdfs:
        t, _p, _n, valid = sdf_candidate(
            o, d, kind, Vec3(cx, cy, cz), params, rot=rot, scale=scale
        )
        occ = occ | (valid & (t < t_max))
    return occ


def _light_table(scene: HostScene):
    """Host-side power-proportional light-selection table over ALL baked
    area emitters -- spheres first, then rectangle planes, index-aligned
    with _intersect_const's unified prim index -- or None when nothing
    emits. Rows (prob, cumulative, kind, prim, (g0..g7), (r, g, b) L_e):
    kind 0 = sphere with g = (cx, cy, cz, radius, 0...), kind 1 = plane
    with g = (nx, ny, nz, px, py, pz, width, height); `prim` is the
    unified _intersect_const index (sphere i -> i, plane j -> S + j) the
    MIS pickup weights compare against. Zero-power rows are DROPPED --
    they can never be selected and their pickup density is 0, but kept in
    the table they cost unrolled per-bounce work (Cornell's table is 1
    emitter out of 9 prims).
    Weights are luminance x area (sphere 4 pi r^2, plane w x h), matching
    integrator._light_probs. Pure Python floats -> kernel literals."""
    import math

    rows = []
    total = 0.0
    n_sph = len(scene.spheres)
    for i, (cx, cy, cz, rad, mid) in enumerate(scene.spheres):
        le = scene.materials[mid][1]
        lum = 0.2126 * le[0] + 0.7152 * le[1] + 0.0722 * le[2]
        power = lum * 4.0 * math.pi * rad * rad
        rows.append([power, 0, i, (cx, cy, cz, rad, 0.0, 0.0, 0.0, 0.0), le])
        total += power
    for j, (nx, ny, nz, px, py, pz, w, h, mid) in enumerate(scene.planes):
        le = scene.materials[mid][1]
        lum = 0.2126 * le[0] + 0.7152 * le[1] + 0.0722 * le[2]
        power = lum * w * h
        rows.append([power, 1, n_sph + j, (nx, ny, nz, px, py, pz, w, h), le])
        total += power
    if total <= 0.0:
        return None
    out = []
    cum = 0.0
    for power, kind, prim, geom, le in rows:
        if power <= 0.0:
            continue
        prob = power / total
        cum += prob
        out.append((prob, cum, kind, prim, geom, le))
    return tuple(out)


def _gather_materials_const(materials: tuple, ids: Array) -> MaterialParams:
    """Material gather as an unrolled select chain over the (small) baked
    table -- no dynamic gather inside the kernel."""

    def pick(field_idx, sub=None):
        acc = None
        for m, row in enumerate(materials):
            val = row[field_idx] if sub is None else row[field_idx][sub]
            if acc is None:
                acc = jnp.full_like(ids, val, dtype=jnp.float32)
            else:
                acc = jnp.where(ids == m, val, acc)
        return acc

    rgb = lambda fi: RGB(pick(fi, 0), pick(fi, 1), pick(fi, 2))
    return MaterialParams(
        albedo=rgb(0),
        emission=rgb(1),
        tint=rgb(2),
        roughness=pick(3),
        ior=pick(4),
    )


def _host_nee_clamp(scene: HostScene) -> float:
    """Scale-aware per-bounce NEE ceiling from the baked host tables --
    the megakernel counterpart of integrator.auto_nee_clamp (the tables
    carry emission on the host, so the value becomes a kernel constant)."""
    max_e = max(
        (max(m[1]) for m in scene.materials), default=0.0
    )
    return NEE_CLAMP_FACTOR * max(float(max_e), 1.0)


def _make_kernel(
    scene: HostScene,
    width: int,
    height: int,
    max_depth: int,
    sampler: str = "uniform",
    index_bits: int = 32,
    mode: str = "path",
    nee_clamp: float = None,
    block: int = 256,
    n_rays: int = 0,
):
    cam = _const_camera(scene.camera)
    nee = mode == "nee"
    lights = _light_table(scene) if nee else None
    clamp_val = nee_clamp if nee_clamp is not None else _host_nee_clamp(scene)

    def kernel(key_ref, px_ref, si_ref, r_ref, g_ref, b_ref):
        # Key words [k0, k1, hash32(sobol root), 0]: one (4,) block read
        # whole and split by masked reductions (Triton has no scalar
        # extraction from a loaded vector).
        words = key_ref[...]
        lane = jax.lax.broadcasted_iota(jnp.int32, words.shape, 0)
        word = lambda i: jnp.sum(jnp.where(lane == i, words, np.uint32(0)))
        k0, k1 = word(0), word(1)
        px = px_ref[...]
        si = si_ref[...]
        ray = pl.program_id(0) * block + jax.lax.broadcasted_iota(
            jnp.int32, px.shape, 0
        )

        if sampler == "sobol":
            # Same per-pixel scramble seed derivation as the XLA path
            # (rng.make_ray_streams): hash32(pixel ^ hash32(root_bits)),
            # so draws are BIT-IDENTICAL across backends.
            from ..sampling import hash32, sobol_pair

            seed = hash32(px ^ word(2))

            def draw_pair(stream, pair):
                return sobol_pair(seed, si, stream, pair, index_bits)

        else:

            def draw_pair(stream, pair):
                return pair_uniforms(k0, k1, px, si, stream, pair)

        # Camera jitter + ray generation (stream 0).
        u0, u1 = draw_pair(np.uint32(0), 0)
        fi = (px % np.uint32(width)).astype(jnp.int32).astype(jnp.float32)
        fj = (px // np.uint32(width)).astype(jnp.int32).astype(jnp.float32)
        x = (fi + u0) * (1.0 / width)
        y = (fj + u1) * (1.0 / height)
        o, d = generate_rays(cam, x, y)

        ones = jnp.ones_like(x)
        zeros = jnp.zeros_like(x)

        def bounce(carry):
            # `active` is carried as a float mask (1.0 / 0.0); the loop
            # condition is its block max. `prev_pdf` carries the previous
            # vertex's true direction density (MIS).
            o, d, thru, rad, active_f, prev_pdf, depth = carry
            t, p, n, mid, hit, sph_idx = _intersect_const(scene, o, d)
            active = (active_f > 0.0) & hit

            params = _gather_materials_const(scene.materials, mid)

            contrib = thru * params.emission
            if nee and lights is not None:
                # MIS weight for reaching a light-sampled emitter (sphere
                # OR rectangle plane) by BSDF sampling:
                # prev_pdf / (prev_pdf + p_nee(hit)). Weight 1 at depth 0
                # and for SDF emitters (not light-sampled: p_nee = 0).
                p_light = jnp.zeros_like(t)
                for pr, _, lkind, lprim, g, _le in lights:
                    if lkind == 0:
                        lcx, lcy, lcz, lrad = g[0], g[1], g[2], g[3]
                        d2 = (
                            (lcx - o.x) ** 2
                            + (lcy - o.y) ** 2
                            + (lcz - o.z) ** 2
                        )
                        sin2max = jnp.clip(
                            lrad * lrad / jnp.maximum(d2, 1e-12), 0.0, 1.0
                        )
                        cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2max, 0.0))
                        cand = pr / (
                            2.0 * PI * jnp.maximum(1.0 - cos_max, 1e-9)
                        )
                        cand = jnp.where(
                            d2 > (lrad * lrad) * 1.0002, cand, 0.0
                        )
                    else:
                        # Area->solid-angle Jacobian at the hit distance:
                        # pr * t^2 / (A |cos(d . n_plane)|).
                        lnx, lny, lnz = g[0], g[1], g[2]
                        area = max(g[6] * g[7], 1e-12)
                        cos_l = jnp.abs(
                            d.x * lnx + d.y * lny + d.z * lnz
                        )
                        cand = (
                            pr * t * t / (area * jnp.maximum(cos_l, 1e-6))
                        )
                    p_light = jnp.where(sph_idx == lprim, cand, p_light)
                w_emis = jnp.where(
                    depth > 0,
                    prev_pdf / jnp.maximum(prev_pdf + p_light, 1e-12),
                    1.0,
                )
                # Indirect clamp (integrator.NEE_CLAMP_FACTOR, with the
                # depth-aware RR growth); depth 0 (camera sees the
                # emitter) never clamped.
                cl_d = nee_clamp_at_depth(clamp_val, depth)
                cl = jnp.where(depth > 0, cl_d, jnp.inf)
                contrib = RGB(
                    jnp.minimum(contrib.x * w_emis, cl),
                    jnp.minimum(contrib.y * w_emis, cl),
                    jnp.minimum(contrib.z * w_emis, cl),
                )
            rad = RGB(
                rad.x + jnp.where(active, contrib.x, 0.0),
                rad.y + jnp.where(active, contrib.y, 0.0),
                rad.z + jnp.where(active, contrib.z, 0.0),
            )

            # Draw schedule mirrors integrator._bounce: pair 0 = BSDF lobe
            # (x0, x1); pair 1 = (x2 layer choice, RR); nee adds pair 2 =
            # (light select, cone u1) and pair 3 = (cone u2, spare).
            stream = (depth + 1).astype(jnp.uint32)
            x0, x1 = draw_pair(stream, 0)
            x2, u_rr = draw_pair(stream, 1)

            prob = russian_roulette_probability(thru, depth)
            survive = u_rr <= prob

            basis = construct_basis(n)
            w_out = -d

            if nee and lights is not None:
                u_sel, ul1 = draw_pair(stream, 2)
                ul2, _spare = draw_pair(stream, 3)
                # Select an emitter by the cumulative table (literals):
                # rows (prob, cum, kind, prim, g0..g7, le) -- kind 0
                # sphere g = (cx, cy, cz, rad, ...), kind 1 plane
                # g = (nx, ny, nz, px, py, pz, w, h).
                def lit_select(field):
                    acc = jnp.full_like(t, field(lights[0]))
                    for row, prev in zip(lights[1:], lights[:-1]):
                        acc = jnp.where(u_sel > prev[1], field(row), acc)
                    return acc

                lg = [lit_select(lambda r, i=i: r[4][i]) for i in range(8)]
                lpr = lit_select(lambda r: r[0])
                ler = lit_select(lambda r: r[5][0])
                leg = lit_select(lambda r: r[5][1])
                leb = lit_select(lambda r: r[5][2])
                # The table's kinds are known at kernel-build time: emit
                # each sampling branch only when a row of that kind
                # exists, and skip the per-lane kind select entirely for
                # single-kind tables (with a traced is_pln predicate, a
                # sphere-only Cornell would pay the whole dead plane
                # branch per bounce).
                has_sph = any(r[2] == 0 for r in lights)
                has_pln = any(r[2] == 1 for r in lights)

                if has_sph:
                    # --- sphere branch: uniform cone -------------------
                    lcx, lcy, lcz, lrad = lg[0], lg[1], lg[2], lg[3]
                    to_c = Vec3(lcx - p.x, lcy - p.y, lcz - p.z)
                    d2 = to_c.x**2 + to_c.y**2 + to_c.z**2
                    dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
                    outside = dist > lrad * 1.0001
                    sin2max = jnp.clip(
                        lrad * lrad / jnp.maximum(d2, 1e-12), 0.0, 1.0
                    )
                    cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2max, 0.0))
                    one_minus = jnp.maximum(1.0 - cos_max, 1e-9)
                    cos_t = 1.0 - ul1 * one_minus
                    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
                    phi = 2.0 * PI * ul2
                    laxis = Vec3(to_c.x / dist, to_c.y / dist, to_c.z / dist)
                    lbasis = construct_basis(laxis)
                    wi_s = (
                        lbasis.t * (sin_t * jnp.cos(phi))
                        + lbasis.b * (sin_t * jnp.sin(phi))
                        + lbasis.n * cos_t
                    )
                    t_s = dist * cos_t - jnp.sqrt(
                        jnp.maximum(
                            lrad * lrad - d2 * (1.0 - cos_t * cos_t), 0.0
                        )
                    )
                    pdf_s = lpr / (2.0 * PI * one_minus)
                    valid_s = outside & (t_s > 0.0)

                if has_pln:
                    # --- plane branch: uniform area, t^2/(A cos) -------
                    lnrm = Vec3(lg[0], lg[1], lg[2])
                    lanchor = Vec3(lg[3], lg[4], lg[5])
                    lw, lh = lg[6], lg[7]
                    pl_basis = construct_basis(lnrm)
                    q = (
                        lanchor
                        + pl_basis.t * ((ul1 - 0.5) * lw)
                        + pl_basis.b * ((ul2 - 0.5) * lh)
                    )
                    to_q = Vec3(q.x - p.x, q.y - p.y, q.z - p.z)
                    d2q = to_q.x**2 + to_q.y**2 + to_q.z**2
                    dq = jnp.sqrt(jnp.maximum(d2q, 1e-12))
                    wi_p = Vec3(to_q.x / dq, to_q.y / dq, to_q.z / dq)
                    cos_lp = jnp.abs(dot(wi_p, lnrm))  # two-sided emitter
                    area = jnp.maximum(lw * lh, 1e-12)
                    pdf_p = lpr * d2q / (area * jnp.maximum(cos_lp, 1e-6))
                    valid_p = (cos_lp > 1e-6) & (dq > 1e-6)

                if has_sph and has_pln:
                    is_pln = lit_select(lambda r: float(r[2])) > 0.5
                    wi_l = Vec3(
                        jnp.where(is_pln, wi_p.x, wi_s.x),
                        jnp.where(is_pln, wi_p.y, wi_s.y),
                        jnp.where(is_pln, wi_p.z, wi_s.z),
                    )
                    t_light = jnp.where(is_pln, dq, t_s)
                    pdf_l = jnp.maximum(
                        jnp.where(is_pln, pdf_p, pdf_s), 1e-12
                    )
                    # Boolean select via logic ops.
                    valid_l = (is_pln & valid_p) | (~is_pln & valid_s)
                elif has_pln:
                    wi_l, t_light, valid_l = wi_p, dq, valid_p
                    pdf_l = jnp.maximum(pdf_p, 1e-12)
                else:
                    wi_l, t_light, valid_l = wi_s, t_s, valid_s
                    pdf_l = jnp.maximum(pdf_s, 1e-12)
                cos_surf = dot(wi_l, n)
                shadow_o = p + wi_l * BOUNCE_EPSILON
                pre_mask = active & valid_l & (cos_surf > 0.0)
                visible = ~_occluded_const(
                    scene, shadow_o, wi_l, t_light * (1.0 - 1e-3)
                )
                f_l = layered_eval(wi_l, w_out, n, params)
                p_bsdf_l = layered_pdf_true(wi_l, w_out, n, params)
                mis_l = pdf_l / jnp.maximum(pdf_l + p_bsdf_l, 1e-12)
                nee_mask = pre_mask & visible
                nee_scale = jnp.where(nee_mask, mis_l * cos_surf / pdf_l, 0.0)
                # Indirect clamp (integrator.NEE_CLAMP_FACTOR,
                # depth-aware).
                cl2 = nee_clamp_at_depth(clamp_val, depth)
                rad = RGB(
                    rad.x + jnp.minimum(thru.x * f_l.x * ler * nee_scale, cl2),
                    rad.y + jnp.minimum(thru.y * f_l.y * leg * nee_scale, cl2),
                    rad.z + jnp.minimum(thru.z * f_l.z * leb * nee_scale, cl2),
                )

            wi, pdf, f = layered_sample(w_out, x0, x1, x2, basis, params)
            if nee:
                pdf = layered_pdf_true(wi, w_out, n, params)

            new_o = p + wi * BOUNCE_EPSILON
            scale = jnp.abs(dot(wi, n)) / (pdf * prob)
            new_thru = thru * f * scale

            active = active & survive
            sel = lambda a, b: jnp.where(active, a, b)
            return (
                Vec3(sel(new_o.x, o.x), sel(new_o.y, o.y), sel(new_o.z, o.z)),
                Vec3(sel(wi.x, d.x), sel(wi.y, d.y), sel(wi.z, d.z)),
                RGB(sel(new_thru.x, thru.x), sel(new_thru.y, thru.y), sel(new_thru.z, thru.z)),
                rad,
                jnp.where(active, 1.0, 0.0).astype(jnp.float32),
                sel(pdf, prev_pdf) if nee else prev_pdf,
                depth + 1,
            )

        # Pad lanes (ray id >= n_rays) start dead and never trace.
        alive = jnp.where(ray < n_rays, 1.0, 0.0).astype(jnp.float32)
        carry = (
            o,
            d,
            RGB(ones, ones, ones),
            RGB(zeros, zeros, zeros),
            alive,  # active mask as f32 (see bounce)
            ones,  # prev_pdf (MIS carry; unused in path mode)
            jnp.int32(0),
        )
        carry = jax.lax.while_loop(
            lambda c: (c[6] < max_depth) & (jnp.max(c[4]) > 0.0),
            bounce,
            carry,
        )
        rad = carry[3]
        r_ref[...] = rad.x
        g_ref[...] = rad.y
        b_ref[...] = rad.z

    return kernel


@functools.lru_cache(maxsize=32)
def _build_renderer(
    scene: HostScene,
    width: int,
    height: int,
    max_depth: int,
    n_rays: int,
    block: int,
    num_warps: int,
    interpret: bool,
    sampler: str,
    index_bits: int,
    mode: str = "path",
    nee_clamp: float = None,
):
    """Jitted (key4, px, si) -> (r, g, b): per-ray radiance for `n_rays`
    rays padded up to whole blocks. px / si are (n_pad,) uint32 pixel and
    sample ids; key4 is (4,) uint32 [k0, k1, hash32(sobol root), 0]."""
    kernel = _make_kernel(
        scene, width, height, max_depth, sampler, index_bits, mode,
        nee_clamp, block, n_rays,
    )
    num_blocks = pl.cdiv(n_rays, block)
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    out_shape = jax.ShapeDtypeStruct((num_blocks * block,), jnp.float32)
    call = pl.pallas_call(
        kernel,
        grid=(num_blocks,),
        in_specs=[pl.BlockSpec((4,), lambda i: (0,)), ray_spec, ray_spec],
        out_specs=(ray_spec, ray_spec, ray_spec),
        out_shape=(out_shape, out_shape, out_shape),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="cornelis_megakernel",
    )
    return jax.jit(call)


def _key_words(root_key: Array) -> Array:
    """(4,) uint32 kernel key operand: the threefry key words, the hashed
    Sobol root (same derivation as rng.make_ray_streams, so sobol draws
    match the XLA path bitwise) and a zero pad word."""
    from ..sampling import hash32

    key_words = jax.random.key_data(root_key).astype(jnp.uint32).reshape(2)
    sobol_root = hash32(
        jax.random.bits(jax.random.fold_in(root_key, 0x50B0), (), jnp.uint32)
    )
    return jnp.concatenate(
        [key_words, sobol_root.reshape(1), jnp.zeros((1,), jnp.uint32)]
    )


@functools.lru_cache(maxsize=32)
def _build_chunk_fn(
    host: HostScene,
    width: int,
    height: int,
    max_depth: int,
    spp_chunk: int,
    block: int,
    num_warps: int,
    interpret: bool,
    sampler: str,
    index_bits: int,
    mode: str,
    nee_clamp: float = None,
):
    """Jitted (root_key, sample_offset) -> (H, W, 3) chunk radiance sums.

    Ray k of the chunk is (pixel k // spp_chunk, sample offset +
    k % spp_chunk) in scanline pixel order: a block holds every sample of
    a few neighbouring pixels, coherent enough that a tile-major pixel
    order measured no faster on the H100 (PERF.md)."""
    num_px = width * height
    n = num_px * spp_chunk
    renderer = _build_renderer(
        host, width, height, max_depth, n, block, num_warps, interpret,
        sampler, index_bits, mode, nee_clamp,
    )
    n_pad = pl.cdiv(n, block) * block

    @jax.jit
    def chunk_fn(root_key, sample_offset):
        k = jax.lax.iota(jnp.uint32, n_pad)
        # Pad rays (k >= n) start dead in the kernel; clamp their ids.
        p = jnp.minimum(k // np.uint32(spp_chunk), np.uint32(num_px - 1))
        si = jnp.asarray(sample_offset, jnp.uint32) + k % np.uint32(spp_chunk)
        r, g, b = renderer(_key_words(root_key), p, si)
        img = jnp.stack([r[:n], g[:n], b[:n]], axis=-1)
        img = img.reshape(num_px, spp_chunk, 3).sum(axis=1)
        return img.reshape(height, width, 3)

    return chunk_fn


def render_chunk_pallas(
    scene: SceneArrays,
    root_key: Array,
    sample_offset,
    *,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    block: int = DEFAULT_BLOCK,
    num_warps: int = DEFAULT_WARPS,
    interpret: bool = False,
    sampler: str = "uniform",
    mode: str = "path",
    nee_clamp: float = None,
) -> Array:
    """Drop-in counterpart of integrator.render_chunk on the megakernel.

    Returns (H, W, 3) radiance *sums* over the chunk's spp. Same determinism
    contract (results depend only on (seed, pixel, sample)). sampler
    "uniform" draws bit-different numbers from the XLA path (explicit
    threefry vs jax.random), identical distribution; "sobol" shares
    sampling.py's draw pipeline with the XLA path bit-for-bit. Even with
    identical draws, pixel-exact agreement holds only in interpret mode:
    compiled for the GPU, Triton's (libdevice) and XLA's transcendental
    lowerings differ by ulps, and knife-edge path decisions (RR, closest
    hit) amplify those into a sparse set of divergent paths.

    mode="nee" runs the corrected estimator (NEE + MIS; see
    integrator._bounce) entirely in-kernel, with the light table baked as
    constants. Not differentiable: gradients use the XLA wavefront.
    """
    host = scene_to_host(scene)
    index_bits = max(1, (spp_total - 1).bit_length())
    # Resolve the scale-aware default HERE so the lru_cache key is a
    # concrete float (None would alias distinct effective clamps).
    if nee_clamp is None:
        nee_clamp = _host_nee_clamp(host)
    chunk_fn = _build_chunk_fn(
        host, width, height, max_depth, spp_chunk, block, num_warps,
        interpret, sampler, index_bits, mode, float(nee_clamp),
    )
    return chunk_fn(root_key, jnp.asarray(sample_offset, jnp.uint32))
