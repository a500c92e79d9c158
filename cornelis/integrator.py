"""Wavefront path-tracing integrator.

The reference's per-pixel bounce loop (src/Render.cpp:220-255) -- RayBatch
SoA, active-index compaction, unbounded Russian-roulette-terminated depth --
becomes a single `lax.while_loop` over the whole wavefront with a boolean
active mask and a max-depth safety bound. Dead lanes are masked, not
compacted: XLA wants static shapes, and RR (aggressive after depth 3,
Render.cpp:153-165) keeps the wasted-lane fraction small.

Replicated integrator semantics (each affects the image mean):
  * emission is accumulated at *every* hit, weighted by throughput -- there
    is no next-event estimation / light sampling / MIS (Render.cpp:187);
  * rays that miss everything die without any environment contribution
    (activeList rebuild on t < inf, Render.cpp:143-149);
  * Russian roulette: survival 0.99 for depth < 3, else
    0.55 * clamp(mag2(throughput), 0.05/0.55, 0.99); the kill test draws one
    uniform and kills when prob < u (Render.cpp:153-165,189);
  * bounce origin offset: P + wi * 1e-4 (Render.cpp:207);
  * throughput *= f * |wi . N| / (pdf * prob) with the layered-averaged pdf
    (Render.cpp:210-213);
  * pixel estimate = mean of per-sample radiance (0.5-radius box filter,
    Render.cpp:245-251).

RNG: stateless, keyed by global ray id + bounce stream -- results are
invariant to chunking and device mesh shape (see rng.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .camera import generate_rays
from .geometry import KIND_PLANE, KIND_SPHERE, intersect_scene, occluded
from .materials import (
    emission,
    gather_materials,
    layered_eval,
    layered_pdf_true,
    layered_sample,
)
from .math.vec import PI, RGB, Vec3, construct_basis, dot, mag2, ray_at, where
from .rng import (
    STREAM_BOUNCE_BASE,
    STREAM_CAMERA,
    RayStreams,
    make_ray_streams,
    stream_uniforms,
)
from .scene.compile import SceneArrays

Array = jnp.ndarray

# Russian-roulette constants (Render.cpp:153-165).
RR_BASE = 0.55
RR_YOUNG_SURVIVAL = 0.99
RR_YOUNG_DEPTH = 3
RR_CLAMP_LO = 0.05 / RR_BASE
RR_CLAMP_HI = 0.99

# Bounce-origin offset (Render.cpp:207).
BOUNCE_EPSILON = 1e-4


class PathState(NamedTuple):
    """Wavefront state carried through the bounce loop (RayBatch analog,
    Render.cpp:47-82, plus the loop counter)."""

    origin: Vec3
    direction: Vec3
    throughput: RGB
    radiance: RGB
    active: Array
    depth: Array  # int32 scalar bounce counter
    streams: RayStreams  # per-ray sampler state
    # True mixture density of the direction sampled at the previous vertex
    # (MIS balance weights in nee mode; carried as 1.0 and ignored in the
    # replicated path mode).
    prev_pdf: Array


# Per-channel ceiling on any single bounce's radiance contribution in NEE
# mode (production "indirect clamp"). The replicated reference BRDF quirks
# (almost-zero-alpha D = 1.0, 5e-5 grazing-cosine guards) allow double-
# grazing bounces on low-roughness materials to multiply throughput by
# ~1e4-1e5; unlucky-but-deterministic sobol draws then put a ~1e6-radiance
# firefly in one pixel (measured at 512^2: one pixel at 4.4e6, Cornell
# nee+sobol). The ceiling is shaped by what a NON-pathological path can
# legitimately contribute:
#
#   * SCALE-AWARE base: NEE_CLAMP_FACTOR x the scene's brightest emission
#     channel (floored at 1 so lightless scenes keep a finite ceiling) --
#     the same lesson as the scale-aware min_hit_t guard (COMPAT R10): an
#     absolute threshold silently darkens bright scenes (a close-up
#     emission-1e4 area light legitimately contributes thousands per
#     bounce) and protects nothing in dim ones. Shallow-bounce throughput
#     in the library scenes stays under ~5, so 16 x L_e truncates only the
#     >1e3 x L_e pathological tail there.
#   * DEPTH-AWARE growth: Russian-roulette survivors are reweighted by
#     1/prob per bounce past RR_YOUNG_DEPTH. prob = RR_BASE x
#     clip(mag2(throughput), lo, hi), so the instantaneous reweight ranges from
#     1/(RR_BASE x RR_CLAMP_HI) ~= 1.84x up to 1/0.05 = 20x -- but large
#     reweights only occur when throughput is already small, and in an
#     enclosure the product settles near the fixed point |t| ~
#     1/(RR_BASE |t|): measured single-sample furnace radiance reaches
#     ~135 x L_e by depth ~16 and drifts ~1.01x/bounce thereafter. The
#     ceiling grows by (1/RR_BASE)^(d-3), which tracks that measured
#     envelope (a flat ceiling was measured to bias the furnace mean by
#     0.4%) while the grazing-quirk fireflies -- whose 1e4-1e5 blowup
#     happens in a couple of SHALLOW bounces where the ceiling is still
#     ~16 x L_e -- stay suppressed.
#
# The furnace-invariance claim is EMPIRICAL over the tested depth range,
# not a strict majorization: the ceiling's (1/RR_BASE)^excess growth does
# not bound the worst-case 1/prob inflation, so at depths far beyond the
# tested max_depth 64 a legitimate furnace path could in principle graze
# the ceiling (~1.01x/bounce drift vs the ceiling's 1.818x/bounce growth
# makes that take hundreds of bounces). tests/test_nee.py asserts
# clamp-on == clamp-off BITWISE for the shipped depth range, and the
# clamp-on vs clamp-off Cornell energy delta is pinned there. Path mode
# is NOT clamped -- it replicates the reference estimator exactly,
# fireflies included (the reference's own renders show the same
# speckles).
NEE_CLAMP_FACTOR = 16.0


def auto_nee_clamp(scene: SceneArrays):
    """Scale-aware BASE of the per-bounce NEE radiance ceiling for a
    compiled scene (traced; a tiny max-reduction XLA folds into the
    render). The depth-aware RR growth is applied at the clamp site
    (nee_clamp_at_depth)."""
    e = scene.mat_emission
    max_e = jnp.max(jnp.stack([e.x, e.y, e.z]))
    return NEE_CLAMP_FACTOR * jnp.maximum(max_e, 1.0)


def nee_clamp_at_depth(base, depth: Array):
    """Per-bounce ceiling at `depth`: base x (1/RR_BASE)^max(d - 3, 0),
    matching the Russian-roulette survivor reweighting that legitimately
    inflates deep-path throughput (see NEE_CLAMP_FACTOR block). exp/log
    form (not jnp.power) so the same code lowers inside the Pallas
    megakernel."""
    import math

    excess = jnp.maximum(depth - RR_YOUNG_DEPTH, 0).astype(jnp.float32)
    return base * jnp.exp(excess * jnp.float32(math.log(1.0 / RR_BASE)))


def russian_roulette_probability(throughput: RGB, depth: Array) -> Array:
    """Survival probability (Render.cpp:153-165). mag2 treats the RGB triple
    as a 3-vector."""
    power = jnp.clip(mag2(throughput), RR_CLAMP_LO, RR_CLAMP_HI)
    return jnp.where(depth < RR_YOUNG_DEPTH, RR_YOUNG_SURVIVAL, RR_BASE * power)


def _luminance(c: RGB) -> Array:
    return 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z


def _emitter_luminance(scene: SceneArrays, mid) -> Array:
    return _luminance(
        RGB(
            scene.mat_emission.x[mid],
            scene.mat_emission.y[mid],
            scene.mat_emission.z[mid],
        )
    )


def _light_probs(scene: SceneArrays):
    """Power-proportional selection distribution over ALL area emitters --
    spheres first, then finite-rectangle planes -- as (S + P,) probs plus
    a has-light flag. Weights are luminance(L_e) x surface area (sphere
    4 pi r^2, plane w x h), so a dim huge panel and a bright small bulb
    are picked in proportion to emitted power. (Round 4 extension: planes
    were previously not light-sampled at all -- plane-lit scenes got no
    NEE benefit.)"""
    weights = []
    for s in range(scene.num_spheres):
        weights.append(
            _emitter_luminance(scene, scene.sphere_material[s])
            * (4.0 * PI)
            * scene.sphere_radius[s] ** 2
        )
    for p in range(scene.num_planes):
        weights.append(
            _emitter_luminance(scene, scene.plane_material[p])
            * scene.plane_width[p]
            * scene.plane_height[p]
        )
    w = jnp.stack(weights)
    total = jnp.sum(w)
    has_light = total > 0.0
    return w / jnp.where(has_light, total, 1.0), has_light


def _grad_safe_sqrt(x: Array) -> Array:
    """sqrt(max(x, 0)) with a FINITE gradient at the boundary.

    d/dx sqrt(x) -> inf as x -> 0+, and reverse-mode turns the masked
    inf * 0 into NaN -- the fully-attached NEE estimator (detach=False FD
    tests) hits exactly that when a cone draw lands on cos_t = 1 or a
    query point grazes d = r. Forward values are bit-identical to
    jnp.sqrt(jnp.maximum(x, 0.0)) for every reachable x (the branches
    differ only on 0 < x < 1e-20, below any reachable f32 product here);
    the backward sees sqrt(max(x, 1e-20)) whose gradient saturates to 0
    at the boundary instead of inf."""
    return jnp.where(x > 0.0, jnp.sqrt(jnp.maximum(x, 1e-20)), 0.0)


def _cone_pdf(d2: Array, radius: Array) -> Array:
    """Uniform-cone solid-angle density toward a sphere at squared
    distance d2 (0 where the query point is inside the sphere)."""
    sin2max = jnp.clip(radius * radius / jnp.maximum(d2, 1e-12), 0.0, 1.0)
    cos_max = _grad_safe_sqrt(1.0 - sin2max)
    one_minus = jnp.maximum(1.0 - cos_max, 1e-9)
    pdf = 1.0 / (2.0 * PI * one_minus)
    outside = d2 > (radius * radius) * (1.0001**2)
    return jnp.where(outside, pdf, 0.0)


def _light_pdf_for_hit(scene: SceneArrays, probs: Array, from_p: Vec3, hit) -> Array:
    """Joint NEE density of having sampled, from `from_p`, the direction
    that produced `hit` -- the counter-strategy pdf for MIS at a
    BSDF-sampled emitter hit. Sphere hits: selection x uniform-cone solid
    angle. Plane hits: selection x area->solid-angle Jacobian
    t^2 / (A |cos theta_l|) at the hit point. Zero for misses, SDF hits
    (not light-sampled), and zero-probability emitters -- so the MIS
    weight prev_pdf / (prev_pdf + this) degrades to 1 exactly where NEE
    has no counter-strategy."""
    idx = jnp.maximum(hit.prim, 0)
    zeros = jnp.zeros_like(from_p.x)

    if scene.num_spheres:
        sidx = idx % scene.num_spheres
        cx = scene.sphere_center.x[sidx]
        cy = scene.sphere_center.y[sidx]
        cz = scene.sphere_center.z[sidx]
        radius = scene.sphere_radius[sidx]
        d2 = (cx - from_p.x) ** 2 + (cy - from_p.y) ** 2 + (cz - from_p.z) ** 2
        p_sph = probs[sidx] * _cone_pdf(d2, radius)
    else:
        p_sph = zeros

    if scene.num_planes:
        pidx = idx % scene.num_planes
        area = jnp.maximum(
            scene.plane_width[pidx] * scene.plane_height[pidx], 1e-12
        )
        nrm = Vec3(
            scene.plane_normal.x[pidx],
            scene.plane_normal.y[pidx],
            scene.plane_normal.z[pidx],
        )
        # The hit carries no ray direction; reconstruct it from the hit
        # point (the direction NEE would have had to sample).
        to_hit = hit.position - from_p
        d_hit = jnp.sqrt(jnp.maximum(mag2(to_hit), 1e-12))
        wi = Vec3(to_hit.x / d_hit, to_hit.y / d_hit, to_hit.z / d_hit)
        cos_l = jnp.abs(dot(wi, nrm))
        p_pln = (
            probs[scene.num_spheres + pidx]
            * d_hit
            * d_hit
            / (area * jnp.maximum(cos_l, 1e-6))
        )
    else:
        p_pln = zeros

    pdf = jnp.where(hit.kind == KIND_SPHERE, p_sph, 0.0)
    pdf = jnp.where(hit.kind == KIND_PLANE, p_pln, pdf)
    return jnp.where(hit.prim >= 0, pdf, 0.0)


def _sample_light(scene: SceneArrays, p: Vec3, u_sel, u1, u2):
    """Pick one emitter (power-proportional over spheres + rectangle
    planes, _light_probs order) and sample a direction toward it from p:
    uniform-cone for spheres, uniform-area with the t^2/(A cos) Jacobian
    for planes (two-sided, matching emission-on-any-hit).

    Returns (wi, t_light, pdf, radiance, valid): pdf is the joint
    selection x solid-angle density; valid is False where no light
    exists, p is inside the chosen sphere, or the geometry degenerates.
    All unrolled selects over the (small, static) tables -- branch-free
    elementwise work.
    """
    n_sph = scene.num_spheres
    n_pln = scene.num_planes
    n_all = n_sph + n_pln
    zeros = jnp.zeros_like(p.x)
    if n_all == 0:
        z3 = Vec3(zeros, zeros, zeros)
        return z3, zeros, jnp.ones_like(p.x), RGB(zeros, zeros, zeros), zeros.astype(bool)

    probs, has_light = _light_probs(scene)

    # Categorical draw via the cumulative distribution (unrolled; small).
    cum = jnp.cumsum(probs)
    sel = jnp.zeros_like(p.x, dtype=jnp.int32)
    for s in range(n_all - 1):
        sel = jnp.where(u_sel > cum[s], s + 1, sel)

    def pick(vals):
        out = jnp.broadcast_to(vals[0], p.x.shape)
        for s in range(1, len(vals)):
            out = jnp.where(sel == s, vals[s], out)
        return out

    p_sel = pick([probs[i] for i in range(n_all)])
    mids = [scene.sphere_material[s] for s in range(n_sph)] + [
        scene.plane_material[q] for q in range(n_pln)
    ]
    mid = pick([m.astype(jnp.float32) for m in mids]).astype(jnp.int32)
    params = gather_materials(scene, mid)
    radiance = params.emission
    is_plane = sel >= n_sph

    # --- sphere branch (uniform cone) -----------------------------------
    # pick over sphere-only tables: clamp sel into the sphere range.
    ssel = jnp.minimum(sel, max(n_sph - 1, 0))

    def pick_s(arr):
        out = jnp.broadcast_to(arr[0], p.x.shape) if n_sph else zeros
        for s in range(1, n_sph):
            out = jnp.where(ssel == s, arr[s], out)
        return out

    if n_sph:
        cx, cy, cz = (
            pick_s(scene.sphere_center.x),
            pick_s(scene.sphere_center.y),
            pick_s(scene.sphere_center.z),
        )
        radius = pick_s(scene.sphere_radius)
        to_c = Vec3(cx - p.x, cy - p.y, cz - p.z)
        d2 = mag2(to_c)
        d = jnp.sqrt(jnp.maximum(d2, 1e-12))
        outside = d > radius * 1.0001

        sin2max = jnp.clip(radius * radius / jnp.maximum(d2, 1e-12), 0.0, 1.0)
        cos_max = _grad_safe_sqrt(1.0 - sin2max)
        one_minus = jnp.maximum(1.0 - cos_max, 1e-9)

        cos_t = 1.0 - u1 * one_minus
        sin_t = _grad_safe_sqrt(1.0 - cos_t * cos_t)
        phi = 2.0 * PI * u2

        axis = Vec3(to_c.x / d, to_c.y / d, to_c.z / d)
        basis = construct_basis(axis)
        wi_s = (
            basis.t * (sin_t * jnp.cos(phi))
            + basis.b * (sin_t * jnp.sin(phi))
            + basis.n * cos_t
        )
        # Hit distance along wi (the near root of the sphere quadratic).
        t_s = d * cos_t - _grad_safe_sqrt(
            radius * radius - d2 * (1.0 - cos_t * cos_t)
        )
        pdf_s = p_sel / (2.0 * PI * one_minus)
        valid_s = outside & (t_s > 0.0)
    else:
        wi_s = Vec3(zeros, zeros, zeros)
        t_s = zeros
        pdf_s = jnp.ones_like(zeros)
        valid_s = zeros.astype(bool)

    # --- plane branch (uniform area on the rect) ------------------------
    psel = jnp.maximum(sel - n_sph, 0)

    def pick_p(arr):
        out = jnp.broadcast_to(arr[0], p.x.shape) if n_pln else zeros
        for s in range(1, n_pln):
            out = jnp.where(psel == s, arr[s], out)
        return out

    if n_pln:
        nrm = Vec3(
            pick_p(scene.plane_normal.x),
            pick_p(scene.plane_normal.y),
            pick_p(scene.plane_normal.z),
        )
        anchor = Vec3(
            pick_p(scene.plane_point.x),
            pick_p(scene.plane_point.y),
            pick_p(scene.plane_point.z),
        )
        w = pick_p(scene.plane_width)
        h = pick_p(scene.plane_height)
        pbasis = construct_basis(nrm)
        q = (
            anchor
            + pbasis.t * ((u1 - 0.5) * w)
            + pbasis.b * ((u2 - 0.5) * h)
        )
        to_q = q - p
        d2q = mag2(to_q)
        dq = jnp.sqrt(jnp.maximum(d2q, 1e-12))
        wi_p = Vec3(to_q.x / dq, to_q.y / dq, to_q.z / dq)
        cos_l = jnp.abs(dot(wi_p, nrm))  # two-sided emitter
        area = jnp.maximum(w * h, 1e-12)
        pdf_p = p_sel * d2q / (area * jnp.maximum(cos_l, 1e-6))
        valid_p = (cos_l > 1e-6) & (dq > 1e-6)
    else:
        wi_p = Vec3(zeros, zeros, zeros)
        dq = zeros
        pdf_p = jnp.ones_like(zeros)
        valid_p = zeros.astype(bool)

    wi = where(is_plane, wi_p, wi_s)
    t_light = jnp.where(is_plane, dq, t_s)
    pdf = jnp.where(is_plane, pdf_p, pdf_s)
    valid = has_light & (p_sel > 0.0) & jnp.where(is_plane, valid_p, valid_s)
    return wi, t_light, jnp.maximum(pdf, 1e-12), radiance, valid


def _bounce(
    scene: SceneArrays,
    state: PathState,
    detach_sampling: bool = False,
    sampler: str = "uniform",
    index_bits: int = 32,
    mode: str = "path",
    nee_clamp=None,
) -> PathState:
    """One wavefront bounce: intersect -> accumulate emission -> RR ->
    sample BRDF -> spawn continuation rays (Render.cpp:110-218).

    detach_sampling=True applies the detached-sampling estimator for the
    differentiable mode: sampled directions, pdfs, and RR probabilities are
    wrapped in stop_gradient so parameter gradients flow only through the
    BRDF/emission evaluations (reparameterizing through the peaked GGX
    inverse-CDF is high-variance; detaching is the standard choice, cf.
    Mitsuba's detached estimators).

    mode="path" replicates the reference estimator exactly (emission at
    every hit, the quirky averaged layered pdf). mode="nee" is the
    corrected-estimator extension: next-event estimation toward a
    power-selected emitter -- cone-sampled spheres or area-sampled
    rectangle planes (round-4 extension; SDF emitters stay path-sampled
    with MIS weight 1) -- plus a shadow ray, with the continuation weight
    divided by the sampler's TRUE mixture density (layered_pdf_true)
    instead of the reference's half-weighted quirk -- unbiased apart from
    the bounded firefly clamp, typically orders of magnitude lower
    variance for small lights. Both strategies are MIS-combined with the balance heuristic:
    BSDF-sampled emitter hits carry the previous vertex's true direction
    density (state.prev_pdf) and are weighted against the NEE density of
    the same hit; NEE samples are weighted against the BSDF density of the
    same direction -- sharp glossy reflections of small lights converge at
    BSDF-sampling speed, soft shadows at light-sampling speed (Veach 95)."""
    nee = mode == "nee"
    hit = intersect_scene(scene, state.origin, state.direction)
    active = state.active & hit.hit

    params = gather_materials(scene, hit.material)

    # Emission pickup. path: L += throughput * L_e at every hit (no NEE;
    # Render.cpp:187). nee: sphere- AND plane-emitter hits are
    # MIS-weighted against the light-sampling strategy (weight 1 at depth
    # 0 and for emitter kinds NEE cannot sample -- SDFs;
    # _light_pdf_for_hit returns 0 exactly there, so one formula covers
    # every case).
    contrib = state.throughput * emission(params)
    if nee:
        emis_w = jnp.ones_like(state.prev_pdf)
        if scene.num_spheres + scene.num_planes:
            light_probs, _ = _light_probs(scene)
            p_light_hit = _light_pdf_for_hit(
                scene, light_probs, state.origin, hit
            )
            mis_emis = state.prev_pdf / jnp.maximum(
                state.prev_pdf + p_light_hit, 1e-12
            )
            emis_w = jnp.where(state.depth > 0, mis_emis, emis_w)
        contrib = RGB(contrib.x * emis_w, contrib.y * emis_w, contrib.z * emis_w)
        # Indirect clamp (see NEE_CLAMP_FACTOR); depth 0 = the camera
        # looking straight at an emitter, never clamped.
        clamp_base = nee_clamp if nee_clamp is not None else auto_nee_clamp(scene)
        clamp_val = nee_clamp_at_depth(clamp_base, state.depth)
        cl = jnp.where(state.depth > 0, clamp_val, jnp.inf)
        contrib = RGB(
            jnp.minimum(contrib.x, cl),
            jnp.minimum(contrib.y, cl),
            jnp.minimum(contrib.z, cl),
        )
    count_emission = active
    radiance = RGB(
        state.radiance.x + jnp.where(count_emission, contrib.x, 0.0),
        state.radiance.y + jnp.where(count_emission, contrib.y, 0.0),
        state.radiance.z + jnp.where(count_emission, contrib.z, 0.0),
    )

    # Per-bounce draws (Render.cpp:189,199). Column order is QMC-aware: the
    # BSDF's 2D lobe draw (x0, x1) occupies a Sobol pair, (x2 layer choice,
    # RR) the next; NEE adds (light select, cone u1) and (cone u2, spare)
    # pairs -- in uniform mode columns are iid so order is free.
    num_draws = 8 if nee else 4
    u = stream_uniforms(
        state.streams,
        STREAM_BOUNCE_BASE + state.depth,
        num_draws,
        sampler,
        index_bits,
    )
    prob = russian_roulette_probability(state.throughput, state.depth)
    survive = u[:, 3] <= prob  # killed when prob < u (Render.cpp:189)

    basis = construct_basis(hit.normal)
    w_out = -state.direction

    if nee:
        # Next-event estimation: one shadow ray toward a power-selected
        # emitter (cone-sampled sphere or area-sampled rectangle plane).
        wi_l, t_light, pdf_l, light_le, valid_l = _sample_light(
            scene, hit.position, u[:, 4], u[:, 5], u[:, 6]
        )
        if detach_sampling:
            # Detached NEE (round 5): the light-sample direction, distance,
            # and selection x solid-angle density are SAMPLER outputs --
            # stop_gradient them so parameter gradients flow only through
            # the integrand factors f_l, L_e, cos_l, and the MIS weights
            # (visibility is boolean, no gradient by construction). Without
            # this, gradients also flow through the cone/area-sampling
            # reparameterization, which is exactly the high-variance term
            # detached sampling exists to drop (diff/render.py docstring).
            sg = jax.lax.stop_gradient
            wi_l = Vec3(sg(wi_l.x), sg(wi_l.y), sg(wi_l.z))
            t_light = sg(t_light)
            pdf_l = sg(pdf_l)
        cos_l = dot(wi_l, hit.normal)
        shadow_origin = hit.position + wi_l * BOUNCE_EPSILON
        # ANY-hit test (geometry.occluded): the shadow ray only needs a
        # boolean, not the closest hit's position/normal/material.
        visible = ~occluded(
            scene, shadow_origin, wi_l, t_light * (1.0 - 1e-3)
        )
        f_l = layered_eval(wi_l, w_out, hit.normal, params)
        # Balance-heuristic weight vs the BSDF strategy for this direction.
        p_bsdf_l = layered_pdf_true(wi_l, w_out, hit.normal, params)
        mis_l = pdf_l / jnp.maximum(pdf_l + p_bsdf_l, 1e-12)
        nee_mask = active & valid_l & visible & (cos_l > 0.0)
        nee_scale = jnp.where(nee_mask, mis_l * cos_l / pdf_l, 0.0)
        nee_contrib = state.throughput * f_l * light_le * nee_scale
        # Indirect clamp on the light-sample term (see NEE_CLAMP_FACTOR).
        nee_contrib = RGB(
            jnp.minimum(nee_contrib.x, clamp_val),
            jnp.minimum(nee_contrib.y, clamp_val),
            jnp.minimum(nee_contrib.z, clamp_val),
        )
        radiance = RGB(
            radiance.x + jnp.where(nee_mask, nee_contrib.x, 0.0),
            radiance.y + jnp.where(nee_mask, nee_contrib.y, 0.0),
            radiance.z + jnp.where(nee_mask, nee_contrib.z, 0.0),
        )

    wi, pdf, f = layered_sample(w_out, u[:, 0], u[:, 1], u[:, 2], basis, params)
    if nee:
        # Corrected continuation weight: divide by the actual mixture
        # density, not the reference's half-weighted glossy pdf.
        pdf = layered_pdf_true(wi, w_out, hit.normal, params)

    if detach_sampling:
        sg = jax.lax.stop_gradient
        wi = Vec3(sg(wi.x), sg(wi.y), sg(wi.z))
        pdf = sg(pdf)
        prob = sg(prob)
        # Re-evaluate f at the detached direction: layered_sample's f was
        # computed before wi was detached, so its gradient still flows
        # through the sampler's inverse-CDF; this one doesn't.
        f = layered_eval(wi, w_out, hit.normal, params)

    new_origin = hit.position + wi * BOUNCE_EPSILON
    scale = jnp.abs(dot(wi, hit.normal)) / (pdf * prob)
    new_throughput = state.throughput * f * scale

    active = active & survive

    return PathState(
        origin=where(active, new_origin, state.origin),
        direction=where(active, wi, state.direction),
        throughput=where(active, new_throughput, state.throughput),
        radiance=radiance,
        active=active,
        depth=state.depth + 1,
        streams=state.streams,
        prev_pdf=jnp.where(active, pdf, state.prev_pdf)
        if nee
        else state.prev_pdf,
    )


def trace_paths(
    scene: SceneArrays,
    origin: Vec3,
    direction: Vec3,
    keys,
    max_depth: int,
    unroll_bounces: bool = False,
    detach_sampling: bool = False,
    sampler: str = "uniform",
    index_bits: int = 32,
    mode: str = "path",
    nee_clamp=None,
) -> RGB:
    """Trace a wavefront to completion; returns per-ray radiance.

    The loop exits early once every path has died (any(active) in the cond),
    mirroring the reference's bounce-until-empty (Render.cpp:237-243) with a
    max_depth bound for compile-time safety. With unroll_bounces=True a
    reverse-differentiable fori_loop of exactly max_depth steps is used
    instead (while_loop has no reverse-mode rule) -- the diff mode's path.
    """
    # *_like inits (not jnp.ones(n)) so the loop carry inherits the rays'
    # varying manual axes under shard_map (see geometry._empty_hit).
    ones = jnp.ones_like(origin.x)
    zeros = jnp.zeros_like(origin.x)
    if not isinstance(keys, RayStreams):
        # Raw key array (tests, ad-hoc tracing): wrap; Sobol needs real
        # (pixel, sample) coordinates, so only the uniform sampler is legal.
        if sampler != "uniform":
            raise ValueError("sampler != 'uniform' requires RayStreams input")
        u0 = zeros.astype(jnp.uint32)
        keys = RayStreams(key=keys, pixel_seed=u0, sample_idx=u0)
    state = PathState(
        origin=origin,
        direction=direction,
        throughput=RGB(ones, ones, ones),
        radiance=RGB(zeros, zeros, zeros),
        active=ones.astype(bool),
        depth=jnp.zeros((), jnp.int32),
        streams=keys,
        prev_pdf=ones,
    )

    if unroll_bounces:
        # jax.checkpoint on the bounce body: reverse-mode through
        # max_depth bounces otherwise stores every bounce's full
        # intermediate set; recomputing the bounce forward during the
        # backward sweep trades that memory traffic for arithmetic. The
        # loop stays a loop (a trace-time Python unroll compiles max_depth
        # copies of the bounce graph).
        bounce_ckpt = jax.checkpoint(
            lambda sc, s: _bounce(
                sc, s, detach_sampling, sampler, index_bits, mode, nee_clamp
            )
        )
        state = jax.lax.fori_loop(
            0,
            max_depth,
            lambda _, s: bounce_ckpt(scene, s),
            state,
        )
    else:
        state = jax.lax.while_loop(
            lambda s: (s.depth < max_depth) & jnp.any(s.active),
            lambda s: _bounce(
                scene, s, detach_sampling, sampler, index_bits, mode, nee_clamp
            ),
            state,
        )
    return state.radiance


def integrate_pixel_samples(
    scene: SceneArrays,
    root_key: Array,
    pixel_ids: Array,
    sample_idx: Array,
    *,
    width: int,
    height: int,
    spp_total: int,
    max_depth: int,
    unroll_bounces: bool = False,
    detach_sampling: bool = False,
    sampler: str = "uniform",
    mode: str = "path",
    nee_clamp=None,
) -> Array:
    """Core wavefront dispatch: trace every (pixel, sample) pair in the
    cartesian product of `pixel_ids` x `sample_idx` and return per-pixel
    radiance *sums* over those samples, shape (len(pixel_ids), 3).

    Ray ids are global -- pixel * spp_total + sample index -- so any
    partition of pixels or samples (chunking, device sharding) produces the
    same set of per-ray keys and hence the same image. This is the unit both
    the single-device chunk renderer and the mesh-sharded renderer
    (parallel/render.py) are built from.
    """
    num_px = pixel_ids.shape[0]
    spp = sample_idx.shape[0]
    i = (pixel_ids % width).astype(jnp.float32)
    j = (pixel_ids // width).astype(jnp.float32)

    # Wavefront layout: pixel-major, sample-minor.
    px_flat = jnp.repeat(pixel_ids.astype(jnp.uint32), spp)
    samp_flat = jnp.tile(sample_idx.astype(jnp.uint32), num_px)
    streams = make_ray_streams(root_key, px_flat, samp_flat, spp_total)

    # Sobol index range: ceil-log2 of the per-pixel sample budget.
    index_bits = max(1, (spp_total - 1).bit_length())

    # Camera jitter within the pixel footprint (Render.cpp:85-100).
    cam_u = stream_uniforms(streams, STREAM_CAMERA, 2, sampler, index_bits)
    x = (jnp.repeat(i, spp) + cam_u[:, 0]) * (1.0 / width)
    y = (jnp.repeat(j, spp) + cam_u[:, 1]) * (1.0 / height)

    origin, direction = generate_rays(scene.camera, x, y)
    radiance = trace_paths(
        scene,
        origin,
        direction,
        streams,
        max_depth,
        unroll_bounces,
        detach_sampling,
        sampler,
        index_bits,
        mode,
        nee_clamp,
    )

    def pixel_sum(channel: Array) -> Array:
        return channel.reshape(num_px, spp).sum(axis=1)

    return jnp.stack(
        [pixel_sum(radiance.x), pixel_sum(radiance.y), pixel_sum(radiance.z)],
        axis=-1,
    )


@partial(
    jax.jit,
    static_argnames=(
        "width",
        "height",
        "spp_chunk",
        "spp_total",
        "max_depth",
        "sampler",
        "mode",
        "nee_clamp",
    ),
)
def render_chunk(
    scene: SceneArrays,
    root_key: Array,
    sample_offset: Array,
    *,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    sampler: str = "uniform",
    mode: str = "path",
    nee_clamp=None,
) -> Array:
    """Render one sample chunk of the full frame; returns (H, W, 3) radiance
    *sums* over the chunk's spp (caller accumulates and divides -- the
    accumulate-(sum,count) design doubles as progressive mode + checkpoint).
    """
    num_pixels = width * height
    pixel_ids = jnp.arange(num_pixels, dtype=jnp.uint32)
    sample_idx = sample_offset + jnp.arange(spp_chunk, dtype=jnp.uint32)
    img = integrate_pixel_samples(
        scene,
        root_key,
        pixel_ids,
        sample_idx,
        width=width,
        height=height,
        spp_total=spp_total,
        max_depth=max_depth,
        sampler=sampler,
        mode=mode,
        nee_clamp=nee_clamp,
    )
    return img.reshape(height, width, 3)
