"""Ray-scene intersection kernels (the hot loop).

The reference iterates scene objects in an outer loop and rays in an inner
scalar loop with an active-index list (src/Geometry.cpp:34-178,
src/Render.cpp:110-150). Accelerator inversion: rays are the vectorized
dimension (the whole wavefront advances at once), objects are a
compile-time-unrolled scan carrying the running closest hit, and the active
list becomes a boolean mask (stream compaction is an anti-pattern under XLA's
static shapes).

Quirk-compatibility notes (each biases results and is reproduced):
  * degenerate rays (|d| componentwise < RayEpsilon) never hit
    (Geometry.cpp:67-70,145-148);
  * closest-hit updates on a strict `best_t > t` comparison
    (Geometry.cpp:97,169), spheres tested before planes (Render.cpp:115-140);
  * negative roots are mapped to +inf before the near/far min
    (Geometry.cpp:91-95);
  * plane rays parallel to the plane miss (Geometry.cpp:154-159; the
    reference's "origin exactly at the anchor hits at t = 0" corner is now
    rejected by the self-intersection guard -- see min_hit_t / COMPAT R10);
  * finite plane extents are tested against the tangent basis of the plane
    normal: |(p - anchor) . T| * 2 > width => miss (Geometry.cpp:165-168).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .math.vec import (
    Vec3,
    construct_basis,
    dot,
    is_almost_zero,
    mag2,
    normalize,
    ray_at,
)
from .scene.compile import SceneArrays

Array = jnp.ndarray

INF = jnp.inf


# Primitive kinds recorded in Hit.kind (the NEE integrator needs to know
# whether an emitter hit is a light-sampled sphere or a path-sampled
# plane/SDF; the plain integrator ignores it).
KIND_NONE = -1
KIND_SPHERE = 0
KIND_PLANE = 1
KIND_SDF = 2


class Hit(NamedTuple):
    """Closest-hit record for a wavefront of rays (IntersectionData analog,
    Geometry.hpp:7-19): t, position, shading normal, material id, hit mask,
    primitive kind."""

    t: Array
    position: Vec3
    normal: Vec3
    material: Array
    hit: Array  # bool: t < inf
    kind: Array  # int32: KIND_* of the closest primitive (-1 on miss)
    prim: Array  # int32: index within the kind's table (-1 on miss)


def _empty_hit(like: Array) -> Hit:
    """All-miss hit record (t = inf, Geometry.cpp:7-12).

    Built with *_like on a wavefront array rather than jnp.zeros(shape) so
    that under shard_map the record inherits the rays' varying manual axes
    -- a replicated-constant init would fail the scan carry check.
    """
    zeros = jnp.zeros_like(like)
    return Hit(
        t=jnp.full_like(like, INF),
        position=Vec3(zeros, zeros, zeros),
        normal=Vec3(zeros, zeros, zeros),
        material=zeros.astype(jnp.int32),
        hit=zeros.astype(bool),
        kind=jnp.full_like(like, KIND_NONE).astype(jnp.int32),
        prim=jnp.full_like(like, -1).astype(jnp.int32),
    )


def _degenerate(d: Vec3) -> Array:
    """The reference's bogus-ray guard: every component almost zero."""
    return is_almost_zero(d.x) & is_almost_zero(d.y) & is_almost_zero(d.z)


def _update_closest(
    best: Hit, t: Array, p: Vec3, n: Vec3, material: Array, valid: Array,
    kind: int = KIND_NONE, prim: Array = -1,
) -> Hit:
    closer = valid & (best.t > t)
    return Hit(
        t=jnp.where(closer, t, best.t),
        position=Vec3(
            jnp.where(closer, p.x, best.position.x),
            jnp.where(closer, p.y, best.position.y),
            jnp.where(closer, p.z, best.position.z),
        ),
        normal=Vec3(
            jnp.where(closer, n.x, best.normal.x),
            jnp.where(closer, n.y, best.normal.y),
            jnp.where(closer, n.z, best.normal.z),
        ),
        material=jnp.where(closer, material, best.material),
        hit=best.hit | closer,
        kind=jnp.where(closer, kind, best.kind),
        prim=jnp.where(closer, prim, best.prim),
    )


# Scale-aware self-intersection guard. The reference rejects t < 0 and
# relies on the 1e-4 bounce-origin offset (Render.cpp:207) to escape the
# surface -- an ABSOLUTE epsilon, smaller than float32 hit-POSITION
# rounding once coordinates or ray lengths pass ~1000 (ulp(1375) = 1.2e-4):
# the computed hit point can land BEHIND its surface by more than the
# offset, and the next closest-hit finds the same surface at t ~ 0.
# Measured on a backend whose divide/fma rounding overshoots where x86's
# happens to land short): 27% of the Cornell back wall's first-bounce
# light-cone rays self-intersected, carving concentric iso-rounding rings
# into the wall and losing ~15% of the region's radiance vs the reference
# renderer (round-3 investigation; f64 transcription of the reference
# agrees with the reference, not with the un-guarded f32 render).
# The guard: accept hits only at t >= T_MIN_SCALE * (1 + |o|_inf) -- a few
# float32 ulps of the origin's coordinate magnitude, far below any real
# geometry spacing. Deviation from the reference documented in COMPAT.md.
T_MIN_SCALE = 4e-6


def min_hit_t(o: Vec3, d: Vec3 | None = None) -> Array:
    """Minimum accepted hit distance for rays from origin `o` (see
    T_MIN_SCALE), in WORLD units; pass the direction `d` to convert into
    the ray's own parameterization (t_world = t * |d|) for non-normalized
    directions. Side effect recorded in COMPAT.md R10: the reference's
    "parallel ray starting exactly at the plane anchor hits at t = 0"
    corner (Geometry.cpp:154-159, quirk #17) is now a miss -- a t = 0 hit
    at the ray's own origin is precisely the self-intersection class the
    guard exists to reject."""
    mag = jnp.maximum(jnp.maximum(jnp.abs(o.x), jnp.abs(o.y)), jnp.abs(o.z))
    tmin = T_MIN_SCALE * (1.0 + mag)
    if d is not None:
        deg = _degenerate(d)
        tmin = tmin / jnp.sqrt(jnp.where(deg, 1.0, mag2(d)))
    return tmin


def sphere_candidate(o: Vec3, d: Vec3, center: Vec3, radius: Array, tmin=None):
    """Ray/sphere quadratic (Geometry.cpp:50-106): nearest positive root.

    Supports non-normalized directions (A = d.d). Returns (t, p, n, valid)
    where t = +inf on miss. Roots below the scale-aware minimum distance
    (min_hit_t) are treated as misses -- the self-intersection guard.
    `tmin` may be passed precomputed (it depends only on the ray, so
    callers scanning many objects hoist it out of the loop).
    """
    rel = o - center
    deg = _degenerate(d)
    # Dead paths carry d = 0 (the glossy below-horizon kill writes a zero
    # direction); guard the divisor or 0/0 NaNs poison reverse-mode even
    # though `valid` masks the lane in the primal.
    a = jnp.where(deg, 1.0, mag2(d))
    b = dot(rel, d)
    c = mag2(rel)

    u = 2.0 * b / a
    v = (c - radius * radius) / a

    disc = -v + (u * u) / 4.0
    has_root = disc >= 0.0
    # 1e-12 floor: sqrt'(0) = inf at exactly-tangent rays would leak NaN
    # through the miss-masked where in reverse mode.
    shift = jnp.sqrt(jnp.maximum(disc, 1e-12))
    t0 = -u / 2.0 - shift
    t1 = -u / 2.0 + shift
    if tmin is None:
        tmin = min_hit_t(o, d)
    t0 = jnp.where(t0 < tmin, INF, t0)
    t1 = jnp.where(t1 < tmin, INF, t1)
    t = jnp.minimum(t0, t1)

    valid = has_root & ~deg & jnp.isfinite(t)
    t = jnp.where(valid, t, INF)
    p = ray_at(o, d, jnp.where(valid, t, 0.0))
    n = normalize(p - center)
    return t, p, n, valid


def sphere_candidate_t(o: Vec3, d: Vec3, center: Vec3, radius, tmin, pre=None):
    """sphere_candidate's (t, valid) ONLY -- the identical op sequence for
    the root (bitwise-equal t), without materializing the hit position and
    normal. The megakernel's closest-hit scan (ops/pallas_integrator.
    _intersect_const) runs this per object and defers p/n/material to ONE
    post-scan masked fetch of the winning sphere: at 514 objects the
    per-candidate ray_at + normalize + 6-wide select chain was ~half the
    scan's work.

    `pre` optionally carries the per-RAY quantities (deg, a) hoisted out
    of a many-object loop -- the same values this function would compute
    (bitwise-identical results; it only saves recomputation where the
    lowering's CSE doesn't)."""
    if pre is None:
        deg = _degenerate(d)
        a = jnp.where(deg, 1.0, mag2(d))
    else:
        deg, a = pre
    rel = o - center
    b = dot(rel, d)
    c = mag2(rel)

    u = 2.0 * b / a
    v = (c - radius * radius) / a

    disc = -v + (u * u) / 4.0
    has_root = disc >= 0.0
    shift = jnp.sqrt(jnp.maximum(disc, 1e-12))
    t0 = -u / 2.0 - shift
    t1 = -u / 2.0 + shift
    t0 = jnp.where(t0 < tmin, INF, t0)
    t1 = jnp.where(t1 < tmin, INF, t1)
    t = jnp.minimum(t0, t1)

    valid = has_root & ~deg & jnp.isfinite(t)
    t = jnp.where(valid, t, INF)
    return t, valid


def plane_candidate(
    o: Vec3, d: Vec3, normal: Vec3, point: Vec3, width: Array, height: Array,
    tmin=None,
):
    """Ray/finite-rectangle intersection (Geometry.cpp:128-176). `tmin` as
    in sphere_candidate."""
    diff = o - point
    a = -dot(diff, normal)
    b = dot(d, normal)

    origin_on_anchor = (diff.x == 0.0) & (diff.y == 0.0) & (diff.z == 0.0)
    b_zero = is_almost_zero(b)
    # Parallel ray away from the anchor point: miss (Geometry.cpp:154).
    parallel_miss = ~origin_on_anchor & b_zero

    safe_b = jnp.where(b_zero, 1.0, b)
    t = jnp.where(b_zero, 0.0, a / safe_b)
    if tmin is None:
        tmin = min_hit_t(o, d)
    backward = t < tmin  # self-intersection guard (see T_MIN_SCALE)

    p = ray_at(o, d, t)
    basis = construct_basis(normal)
    in_plane = p - point
    outside = (jnp.abs(dot(in_plane, basis.t)) * 2.0 > width) | (
        jnp.abs(dot(in_plane, basis.b)) * 2.0 > height
    )

    valid = ~_degenerate(d) & ~parallel_miss & ~backward & ~outside
    t = jnp.where(valid, t, INF)
    return t, p, normal, valid


# -- Implicit (SDF / level-set) surfaces ------------------------------------
#
# The reference vendors NanoVDB for future level-set surfaces (README
# Milestone 6; the grid machinery is unused, SURVEY §2 #18). Our
# equivalent: analytic signed-distance primitives sphere-traced by the whole
# wavefront in lockstep -- a fixed-trip fori_loop of elementwise ops, with
# per-lane convergence masks instead of early exit.

SDF_KIND_SPHERE = 0
SDF_KIND_BOX = 1
SDF_KIND_TORUS = 2

SPHERE_TRACE_STEPS = 128
# Hit tolerance grows linearly with distance (constant *relative* resolution,
# like a pixel cone); the floor sits above the integrator's 1e-4 bounce
# offset so secondary rays don't immediately re-converge onto their origin
# surface (min-t guard below handles grazing cases).
SDF_EPS = 1e-4
SDF_MIN_T = 1e-3
SDF_MAX_T = 1e6


def sdf_distance(kind: Array, params: Array, q: Vec3) -> Array:
    """Signed distance of local point q for a primitive of `kind`.

    params: (4,) scalars broadcast over the wavefront. All three candidate
    distances are evaluated and selected by kind -- branch-free.
    """
    # Sphere: |q| - r.
    d_sphere = jnp.sqrt(jnp.maximum(mag2(q), 1e-20)) - params[0]

    # Box: |max(|q| - b, 0)| + min(max-component, 0).
    ax = jnp.abs(q.x) - params[0]
    ay = jnp.abs(q.y) - params[1]
    az = jnp.abs(q.z) - params[2]
    outside = jnp.sqrt(
        jnp.maximum(ax, 0.0) ** 2 + jnp.maximum(ay, 0.0) ** 2 + jnp.maximum(az, 0.0) ** 2
    )
    inside = jnp.minimum(jnp.maximum(ax, jnp.maximum(ay, az)), 0.0)
    d_box = outside + inside

    # Torus (axis = local y): |(|q.xz| - R, q.y)| - r.
    ring = jnp.sqrt(jnp.maximum(q.x * q.x + q.z * q.z, 1e-20)) - params[0]
    d_torus = jnp.sqrt(jnp.maximum(ring * ring + q.y * q.y, 1e-20)) - params[1]

    return jnp.where(
        kind == SDF_KIND_SPHERE,
        d_sphere,
        jnp.where(kind == SDF_KIND_BOX, d_box, d_torus),
    )


def sdf_normal(kind: Array, params: Array, q: Vec3, h: Array) -> Vec3:
    """Surface normal by the 4-tap tetrahedron gradient estimate."""

    def tap(sx, sy, sz):
        return sdf_distance(kind, params, Vec3(q.x + sx * h, q.y + sy * h, q.z + sz * h))

    t0 = tap(1.0, -1.0, -1.0)
    t1 = tap(-1.0, -1.0, 1.0)
    t2 = tap(-1.0, 1.0, -1.0)
    t3 = tap(1.0, 1.0, 1.0)
    g = Vec3(t0 - t1 - t2 + t3, -t0 - t1 + t2 + t3, -t0 + t1 - t2 + t3)
    return normalize(g)


def _rot3(rot, v: Vec3) -> Vec3:
    """Apply a 3x3 rotation given as a doubly-indexable row-major table
    (a (3, 3) jnp array slice or a nested tuple of Python floats -- the
    latter is how the Pallas megakernel bakes it)."""
    return Vec3(
        rot[0][0] * v.x + rot[0][1] * v.y + rot[0][2] * v.z,
        rot[1][0] * v.x + rot[1][1] * v.y + rot[1][2] * v.z,
        rot[2][0] * v.x + rot[2][1] * v.y + rot[2][2] * v.z,
    )


def _rot3_t(rot, v: Vec3) -> Vec3:
    """Apply the transpose (inverse) of the rotation in _rot3."""
    return Vec3(
        rot[0][0] * v.x + rot[1][0] * v.y + rot[2][0] * v.z,
        rot[0][1] * v.x + rot[1][1] * v.y + rot[2][1] * v.z,
        rot[0][2] * v.x + rot[1][2] * v.y + rot[2][2] * v.z,
    )


def sdf_candidate(
    o: Vec3,
    d: Vec3,
    kind: Array,
    center: Array,
    params: Array,
    rot=None,
    scale=None,
):
    """Sphere-trace one SDF primitive for the whole wavefront.

    Returns (t, p, n, valid) with t in the ray's own parameterization
    (supports non-normalized directions like the analytic kernels). The
    march runs a fixed SPHERE_TRACE_STEPS trips; converged/escaped lanes
    freeze their t via masks.

    rot/scale (optional): baked object transform -- `rot` is the
    world-to-local rotation (row-major 3x3), `scale` the uniform object
    scale. Query points rotate into the object frame and distances scale
    back to world: d_world(p) = s * d_local(R_wl (p - c) / s). Normals
    come from the local gradient rotated back to world.
    """
    deg = _degenerate(d)
    dlen = jnp.sqrt(jnp.where(deg, 1.0, mag2(d)))
    dn = Vec3(d.x / dlen, d.y / dlen, d.z / dlen)

    def to_local(qw: Vec3) -> Vec3:
        q = _rot3(rot, qw) if rot is not None else qw
        if scale is not None:
            inv = 1.0 / scale
            q = Vec3(q.x * inv, q.y * inv, q.z * inv)
        return q

    def world_dist(qw: Vec3) -> Array:
        dist = sdf_distance(kind, params, to_local(qw))
        return dist * scale if scale is not None else dist

    def step(_, carry):
        # `done` is carried as a float mask (1.0 / 0.0); the march also
        # runs inside the Pallas megakernel.
        t, done_f = carry
        p = ray_at(o, dn, t)
        dist = world_dist(p - center)
        eps = SDF_EPS * jnp.maximum(1.0, t)
        hit = jnp.abs(dist) < eps
        escaped = t > SDF_MAX_T
        done_now = (done_f > 0.0) | hit | escaped
        # Unconverged lanes advance by the (safe, positive-clamped) distance.
        t_next = t + jnp.maximum(dist, 0.5 * eps)
        return (
            jnp.where(done_now, t, t_next),
            jnp.where(done_now, 1.0, 0.0).astype(jnp.float32),
        )

    zeros = jnp.zeros_like(o.x)
    t_world, _ = jax.lax.fori_loop(
        0, SPHERE_TRACE_STEPS, step, (zeros, zeros)
    )

    p = ray_at(o, dn, t_world)
    final_dist = world_dist(p - center)
    eps = SDF_EPS * jnp.maximum(1.0, t_world)
    valid = (
        ~deg
        & (jnp.abs(final_dist) < eps)
        & (t_world > jnp.maximum(SDF_MIN_T, min_hit_t(o)))  # world units: t_world is pre-division
        & (t_world <= SDF_MAX_T)
    )
    # Gradient in the object frame, rotated back to world (uniform scale
    # cancels under normalize). Tap spacing converts to local units.
    h_local = eps / scale if scale is not None else eps
    n_local = sdf_normal(kind, params, to_local(p - center), h_local)
    n = _rot3_t(rot, n_local) if rot is not None else n_local
    # Convert world-space march distance to the ray's parameterization.
    t = jnp.where(valid, t_world / dlen, INF)
    return t, p, n, valid


def intersect_scene(scene: SceneArrays, o: Vec3, d: Vec3) -> Hit:
    """Closest hit against all spheres then all planes (Render.cpp:110-150).

    Object loops are unrolled lax.scans over the stacked tables: each step is
    pure elementwise work over the whole wavefront, carrying the running
    best hit. Zero-length tables scan zero times (empty scenes are legal,
    matching tests/test_Scene.cpp:24-31).
    """
    shape = o.x.shape
    best = _empty_hit(o.x)
    tmin = min_hit_t(o, d)  # per-ray; hoisted out of the object scans

    # SPHERES: two-phase scan (mirroring the megakernel's
    # _intersect_const). Phase 1 carries only (best_t, best index) through
    # a t-only candidate scan -- sphere_candidate_t shares the root's
    # exact op sequence, so the winning t is bitwise-equal to a
    # full-candidate scan. Phase 2 materializes the winning sphere's
    # position/normal/material ONCE: p/n from the identical t, the
    # center/material via _take_rows (whose diff-mode transpose is a
    # matmul reduction, not a scatter). This drops the per-candidate
    # ray_at + normalize + 7-wide select chain, which was ~half the
    # scan's work -- on both the forward wavefront and the diff mode's
    # backward recompute.
    if scene.num_spheres:
        from .materials import _take_rows

        deg = _degenerate(d)
        a = jnp.where(deg, 1.0, mag2(d))

        def sphere_t_step(carry, params):
            best_t, best_idx = carry
            cx, cy, cz, radius, idx = params
            t, valid = sphere_candidate_t(
                o, d, Vec3(cx, cy, cz), radius, tmin, pre=(deg, a)
            )
            closer = valid & (best_t > t)
            return (
                jnp.where(closer, t, best_t),
                jnp.where(closer, idx, best_idx),
            ), None

        (s_t, s_idx), _ = jax.lax.scan(
            sphere_t_step,
            (best.t, best.prim),
            (
                scene.sphere_center.x,
                scene.sphere_center.y,
                scene.sphere_center.z,
                scene.sphere_radius,
                jnp.arange(scene.num_spheres, dtype=jnp.int32),
            ),
            unroll=True,
        )
        sp_hit = s_idx >= 0
        gi = jnp.maximum(s_idx, 0)
        g_cx = _take_rows(scene.sphere_center.x, gi)
        g_cy = _take_rows(scene.sphere_center.y, gi)
        g_cz = _take_rows(scene.sphere_center.z, gi)
        g_mat = jnp.take(scene.sphere_material, gi)  # int: no gradient path
        p = ray_at(o, d, jnp.where(sp_hit, s_t, 0.0))
        # Mask BEFORE normalize: miss lanes would otherwise normalize a
        # zero vector into NaN.
        rel = Vec3(
            jnp.where(sp_hit, p.x - g_cx, 1.0),
            jnp.where(sp_hit, p.y - g_cy, 0.0),
            jnp.where(sp_hit, p.z - g_cz, 0.0),
        )
        n = normalize(rel)
        zero = jnp.zeros_like(o.x)
        sel = lambda x: jnp.where(sp_hit, x, zero)
        best = Hit(
            t=s_t,
            position=Vec3(sel(p.x), sel(p.y), sel(p.z)),
            normal=Vec3(sel(n.x), sel(n.y), sel(n.z)),
            material=jnp.where(sp_hit, g_mat, 0),
            hit=sp_hit,
            kind=jnp.where(
                sp_hit, KIND_SPHERE, jnp.full_like(best.kind, KIND_NONE)
            ),
            prim=s_idx,
        )

    def plane_step(best: Hit, params):
        nx, ny, nz, px, py, pz, width, height, material, idx = params
        normal = Vec3(nx, ny, nz)
        point = Vec3(px, py, pz)
        t, p, n, valid = plane_candidate(
            o, d, normal, point, width, height, tmin=tmin
        )
        # n is the scalar per-plane normal; broadcast to the wavefront shape.
        n = Vec3(
            jnp.broadcast_to(n.x, shape),
            jnp.broadcast_to(n.y, shape),
            jnp.broadcast_to(n.z, shape),
        )
        return (
            _update_closest(best, t, p, n, material, valid, KIND_PLANE, idx),
            None,
        )

    best, _ = jax.lax.scan(
        plane_step,
        best,
        (
            scene.plane_normal.x,
            scene.plane_normal.y,
            scene.plane_normal.z,
            scene.plane_point.x,
            scene.plane_point.y,
            scene.plane_point.z,
            scene.plane_width,
            scene.plane_height,
            scene.plane_material,
            jnp.arange(scene.num_planes, dtype=jnp.int32),
        ),
        unroll=True,
    )

    def sdf_step(best: Hit, obj):
        kind, cx, cy, cz, params, material, rot, scale = obj
        t, p, n, valid = sdf_candidate(
            o, d, kind, Vec3(cx, cy, cz), params, rot=rot, scale=scale
        )
        return _update_closest(best, t, p, n, material, valid, KIND_SDF), None

    best, _ = jax.lax.scan(
        sdf_step,
        best,
        (
            scene.sdf_kind,
            scene.sdf_center.x,
            scene.sdf_center.y,
            scene.sdf_center.z,
            scene.sdf_params,
            scene.sdf_material,
            scene.sdf_rot,
            scene.sdf_scale,
        ),
        unroll=True,
    )

    return best


def occluded(scene: SceneArrays, o: Vec3, d: Vec3, t_max) -> "Array":
    """ANY-hit-within-distance test for shadow rays: True where some
    primitive lies along d closer than `t_max`.

    Semantically identical to `intersect_scene(...).t < t_max` but skips
    everything a shadow ray never reads -- position, normal, material,
    prim index, and the 6-way running-best select chain per object. NEE
    fires one of these per bounce per ray (the estimator's second full
    intersection pass), so the savings land on the hot path of both
    backends (the megakernel mirrors this as _occluded_const).
    """
    shape = o.x.shape
    occ = jnp.zeros(shape, bool)
    tmin = min_hit_t(o, d)
    deg = _degenerate(d)
    a = jnp.where(deg, 1.0, mag2(d))

    def sphere_step(occ, params):
        cx, cy, cz, radius = params
        t, valid = sphere_candidate_t(
            o, d, Vec3(cx, cy, cz), radius, tmin, pre=(deg, a)
        )
        return occ | (valid & (t < t_max)), None

    occ, _ = jax.lax.scan(
        sphere_step,
        occ,
        (
            scene.sphere_center.x,
            scene.sphere_center.y,
            scene.sphere_center.z,
            scene.sphere_radius,
        ),
        unroll=True,
    )

    def plane_step(occ, params):
        nx, ny, nz, px, py, pz, width, height = params
        t, _p, _n, valid = plane_candidate(
            o, d, Vec3(nx, ny, nz), Vec3(px, py, pz), width, height, tmin=tmin
        )
        return occ | (valid & (t < t_max)), None

    occ, _ = jax.lax.scan(
        plane_step,
        occ,
        (
            scene.plane_normal.x,
            scene.plane_normal.y,
            scene.plane_normal.z,
            scene.plane_point.x,
            scene.plane_point.y,
            scene.plane_point.z,
            scene.plane_width,
            scene.plane_height,
        ),
        unroll=True,
    )

    def sdf_step(occ, obj):
        kind, cx, cy, cz, params, rot, scale = obj
        t, _p, _n, valid = sdf_candidate(
            o, d, kind, Vec3(cx, cy, cz), params, rot=rot, scale=scale
        )
        return occ | (valid & (t < t_max)), None

    occ, _ = jax.lax.scan(
        sdf_step,
        occ,
        (
            scene.sdf_kind,
            scene.sdf_center.x,
            scene.sdf_center.y,
            scene.sdf_center.z,
            scene.sdf_params,
            scene.sdf_rot,
            scene.sdf_scale,
        ),
        unroll=True,
    )

    return occ
