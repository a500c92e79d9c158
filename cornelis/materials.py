"""Material models: microfacet distributions, Oren-Nayar, layered BRDF.

Pure batched jnp functions over the wavefront (SoA Vec3 directions). The
reference's virtual BRDF hierarchy (Materials.hpp:59-323) collapses: every
scene material is a StandardMaterial = emission + LayeredBRDF (Oren-Nayar
diffuse base + GGX glossy coat, Materials.hpp:325-338), so shading is one
dense parameter gather + straight-line math -- no dispatch.

Replicated quirks (each biases the image mean, required for golden match):
  * GTR2/GTR3p2 use a 1/(2 pi) normalization (src/Materials.cpp:10,22) and
    return 1.0 when alpha^2 is almost zero (Materials.cpp:7,19);
  * Oren-Nayar evaluates cos(theta) as the *world* z component even though
    it is called with world-space directions (Materials.hpp:216-227 called
    from LayeredBRDF: the frame bug). `on_frame="world"` reproduces this;
    `on_frame="local"` evaluates in the tangent frame (the fix);
  * C++ std::max(0.0f, NaN) returns 0, so Oren-Nayar's cos(phi_i - phi_o)
    term silently becomes 0 whenever acos would have produced NaN; we guard
    explicitly (jnp.maximum would propagate the NaN);
  * the layered pdf is the 0.5-weighted *average* of layer pdfs rather than
    the chosen layer's pdf (variance rationale in Materials.hpp:265-277);
  * Burley remaps: glossy alpha = r^2, diffuse sigma = 0.5 r^2
    (Materials.hpp:296-302);
  * the glossy sampler leaves wi = 0 when the sampled half-vector falls
    below the hemisphere (Materials.hpp:169-170 + the zero-init at
    Render.cpp:198), which kills the path on the next bounce;
  * the glossy pdf is HALF the sampler's true density: the half-vector
    inversion cos(theta_h) = sqrt((1-x1)/(1+(a^2-1)x1)) (Materials.hpp:
    159-162) is the CDF inverse for the standard 1/pi-normalized GGX NDF,
    i.e. true p_h = 2 D_ref cos(theta_h) for the reference's 1/(2 pi)-
    normalized D, but pdf() returns D_ref cos(theta_h)/(4 wi.h)
    (Materials.hpp:177-188). The reference is therefore biased bright on
    glossy lobes; we replicate (see glossy_sampler_density for the true
    density, used by tests and the debiased mode).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .math.vec import (
    PI,
    RGB,
    Basis,
    Vec3,
    dot,
    is_almost_zero,
    mag2,
    normalize,
)
from .rng import hemisphere_pdf, hemisphere_sample_basis

Array = jnp.ndarray


class MaterialParams(NamedTuple):
    """Per-ray gathered StandardMaterial parameters."""

    albedo: RGB
    emission: RGB
    tint: RGB
    roughness: Array
    ior: Array


@jax.custom_vjp
def _take_rows(table: Array, ids: Array) -> Array:
    """jnp.take with a matmul transpose (the diff mode's backward).

    The standard VJP of a gather is a scatter-add of N ray cotangents into
    M table slots -- on the GPU, N atomic adds into a handful of addresses.
    The backward here instead builds the (N, M) one-hot of `ids` and
    reduces the cotangents with one dense f32 matmul (exact: each column
    sums the identical float terms the scatter would have added, modulo
    addition order), at full f32 precision rather than TF32. Measured on
    an H100 (PERF.md): 56 vs 321 ms per 256^2 Adam step in path mode. The
    forward is UNCHANGED jnp.take -- zero cost and bitwise identity for
    every non-diff render path."""
    return jnp.take(table, ids, axis=0)


def _take_rows_fwd(table, ids):
    return jnp.take(table, ids, axis=0), (ids, table.shape[0])


def _take_rows_bwd(res, ct):
    import numpy as np

    ids, n = res
    onehot = (
        ids[:, None] == jnp.arange(n, dtype=ids.dtype)[None, :]
    ).astype(ct.dtype)
    grad = jnp.dot(ct, onehot, precision=jax.lax.Precision.HIGHEST)
    # int ids carry no gradient: float0 cotangent by JAX convention.
    return grad, np.zeros(ids.shape, dtype=jax.dtypes.float0)


_take_rows.defvjp(_take_rows_fwd, _take_rows_bwd)


def gather_materials(scene, material_ids: Array) -> MaterialParams:
    """Gather material rows by per-ray id (replaces scene.materials[id]
    virtual lookup, Render.cpp:180). Uses the matmul-transpose gather
    (_take_rows) so the diff mode's backward never scatters."""
    take = lambda a: _take_rows(a, material_ids)
    return MaterialParams(
        albedo=RGB(take(scene.mat_albedo.x), take(scene.mat_albedo.y), take(scene.mat_albedo.z)),
        emission=RGB(
            take(scene.mat_emission.x), take(scene.mat_emission.y), take(scene.mat_emission.z)
        ),
        tint=RGB(take(scene.mat_tint.x), take(scene.mat_tint.y), take(scene.mat_tint.z)),
        roughness=take(scene.mat_roughness),
        ior=take(scene.mat_ior),
    )


# -- Burley roughness remaps (Materials.hpp:296-302) -----------------------


def glossy_alpha(roughness: Array) -> Array:
    return roughness * roughness


def diffuse_sigma(roughness: Array) -> Array:
    return jnp.abs(0.5 * roughness * roughness)


# -- Microfacet building blocks (src/Materials.cpp:4-42) --------------------


def distribution_gtr2(cos_theta_h: Array, alpha: Array) -> Array:
    """GGX / Trowbridge-Reitz NDF, gamma=2 (Materials.cpp:16-26)."""
    alpha2 = alpha * alpha
    c2 = cos_theta_h * cos_theta_h
    # (1 - c2) + alpha2 c2, not 1 + (alpha2 - 1) c2: the latter cancels to
    # exactly 0 in float32 at the c2 = 1 peak (alpha2 - 1 rounds to -1),
    # which made D infinite and its reverse-mode partial NaN. The
    # cancellation-free form evaluates to exactly alpha2 at the peak. The
    # 1e-18 floor (square still float32-normal -- a 1e-20 floor's square
    # flushes to zero and resurrects the NaN) guards c2 > 1 float spill.
    denom = (1.0 - c2) + alpha2 * c2
    d = (alpha2 / (2.0 * PI)) / jnp.maximum(denom * denom, 1e-18)
    return jnp.where(is_almost_zero(alpha2), 1.0, d)


def distribution_gtr3p2(cos_theta_h: Array, alpha: Array) -> Array:
    """Burley's GTR with gamma=1.5 (Materials.cpp:4-13)."""
    alpha2 = alpha * alpha
    c2 = cos_theta_h * cos_theta_h
    # Cancellation-free base + a floor whose ^3 stays float32-normal in the
    # division's reverse mode (see distribution_gtr2).
    base = (1.0 - c2) + alpha2 * c2
    d = ((alpha2 + alpha) / (2.0 * PI)) / jnp.power(jnp.maximum(base, 1e-8), 1.5)
    return jnp.where(is_almost_zero(alpha2), 1.0, d)


def lambda_tr(tan_theta: Array, alpha: Array) -> Array:
    """Smith lambda for Trowbridge-Reitz (Materials.cpp:28-32)."""
    # Grad-safe: zero the infinite-tangent lanes *before* squaring, so no
    # inf enters the sqrt (0 * inf = NaN in reverse mode otherwise).
    at = jnp.where(jnp.isinf(tan_theta), 0.0, jnp.abs(tan_theta) * alpha)
    lam = (-1.0 + jnp.sqrt(1.0 + at * at)) * 0.5
    return jnp.where(jnp.isinf(tan_theta), 0.0, lam)


def shadow_masking_tr(tan_theta_i: Array, tan_theta_o: Array, alpha: Array) -> Array:
    """Smith height-correlated-ish G (Materials.cpp:34-36)."""
    return 1.0 / (1.0 + lambda_tr(tan_theta_i, alpha) + lambda_tr(tan_theta_o, alpha))


def schlick(cos_theta: Array, refidx1, refidx2) -> Array:
    """Schlick Fresnel approximation (Materials.cpp:38-42)."""
    r0 = (refidx1 - refidx2) / (refidx1 + refidx2)
    r0 = r0 * r0
    m = 1.0 - cos_theta
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


# -- Glossy (GGX) layer (Materials.hpp:120-198) -----------------------------


def glossy_eval(wi: Vec3, wo: Vec3, n: Vec3, tint: RGB, alpha: Array, ior: Array) -> RGB:
    """GGX eval: tint * F D G / (4 cosO cosI), black when either cosine is
    almost zero or the half-vector degenerates (Materials.hpp:130-154)."""
    cos_o = jnp.maximum(0.0, dot(wo, n))
    cos_i = jnp.maximum(0.0, dot(wi, n))
    dead = is_almost_zero(cos_o) | is_almost_zero(cos_i)

    sin_o = jnp.sqrt(jnp.maximum(1.0 - cos_o * cos_o, 1e-12))
    sin_i = jnp.sqrt(jnp.maximum(1.0 - cos_i * cos_i, 1e-12))

    h = normalize(wi + wo)
    h_zero = is_almost_zero(h.x) & is_almost_zero(h.y) & is_almost_zero(h.z)
    cos_h = jnp.maximum(0.0, dot(h, n))

    safe_cos_o = jnp.where(dead, 1.0, cos_o)
    safe_cos_i = jnp.where(dead, 1.0, cos_i)

    d = distribution_gtr2(cos_h, alpha)
    g = shadow_masking_tr(sin_i / safe_cos_i, sin_o / safe_cos_o, alpha)
    f = schlick(cos_h, 1.0, ior)

    scale = jnp.where(dead | h_zero, 0.0, f * d * g / (4.0 * safe_cos_o * safe_cos_i))
    return tint * scale


def glossy_sample(wo: Vec3, x0: Array, x1: Array, basis: Basis, alpha: Array) -> Vec3:
    """GGX half-vector importance sampling (Materials.hpp:156-175).

    cos(theta_h) = sqrt((1 - x1) / (1 + (alpha^2 - 1) x1)), azimuth 2 pi x0,
    half-vector placed as sin cos(phi) B + sin sin(phi) T + cos N, reflected:
    wi = normalize(2 (wo.h) h - wo). When h falls below the surface the
    reference leaves wi zero-initialized -- we return the zero vector, which
    kills the path at the next intersection (degenerate-ray guard).
    """
    alpha2 = alpha * alpha
    a = 1.0 - x1
    b = 1.0 + (alpha2 - 1.0) * x1
    # max with a tiny floor keeps sqrt' finite at x1 = 1 (attached-gradient
    # mode differentiates through this inverse CDF).
    cos_h = jnp.sqrt(jnp.maximum(a / b, 1e-12))
    sin_h = jnp.sqrt(jnp.maximum(1.0 - cos_h * cos_h, 1e-12))
    phi = 2.0 * PI * x0

    h = normalize(
        basis.b * (sin_h * jnp.cos(phi))
        + basis.t * (sin_h * jnp.sin(phi))
        + basis.n * cos_h
    )
    below = dot(h, basis.n) < 0.0
    wi = normalize(h * (2.0 * dot(wo, h)) - wo)
    zero = jnp.zeros_like(wi.x)
    return Vec3(
        jnp.where(below, zero, wi.x),
        jnp.where(below, zero, wi.y),
        jnp.where(below, zero, wi.z),
    )


def glossy_pdf(wi: Vec3, wo: Vec3, n: Vec3, alpha: Array) -> Array:
    """GGX sample pdf = D |cos(theta_h)| / (4 wi.h), with the reference's
    fallbacks: 1 when cos(theta_h) ~ 0, D|cos| when wi.h ~ 0
    (Materials.hpp:177-188)."""
    h = normalize(wi + wo)
    cos_h = jnp.maximum(0.0, dot(h, n))
    d = distribution_gtr2(cos_h, alpha)
    pdf_h = d * jnp.abs(cos_h)
    wi_dot_h = dot(wi, h)
    safe = jnp.where(is_almost_zero(wi_dot_h), 1.0, wi_dot_h)
    pdf = jnp.where(is_almost_zero(wi_dot_h), pdf_h, pdf_h / (4.0 * safe))
    return jnp.where(is_almost_zero(cos_h), 1.0, pdf)


def glossy_sampler_density(wi: Vec3, wo: Vec3, n: Vec3, alpha: Array) -> Array:
    """TRUE density of glossy_sample in wi-space: 2x the reference pdf
    (see module docstring). Used by statistical tests and debiased mode."""
    return 2.0 * glossy_pdf(wi, wo, n, alpha)


# -- Oren-Nayar diffuse layer (Materials.hpp:200-237) ------------------------


def oren_nayar_ab(sigma: Array):
    """Precompute the A/B terms from sigma (Materials.hpp:206-209)."""
    sigma2 = sigma * sigma
    a = 1.0 - (sigma2 / (2.0 * (sigma2 + 0.333)))
    b = 0.45 * sigma2 / (sigma2 + 0.09)
    return a, b


def oren_nayar_eval(
    wi: Vec3, wo: Vec3, albedo: RGB, sigma: Array, frame_basis: Basis | None = None
) -> RGB:
    """Qualitative Oren-Nayar (Materials.hpp:211-228).

    The reference computes cos(theta) as the direction's z component,
    assuming a local frame, but is *called* with world-space directions
    (via LayeredBRDF, Render.cpp:200) -- the frame bug. Pass
    frame_basis=None to reproduce that (world z as cos theta); pass the
    surface basis to evaluate in the proper tangent frame.

    Math notes: with theta = acos(c) in [0, pi], sin(max) sin(min) ==
    sin(theta_i) sin(theta_o), and cos(acos(a) - acos(b)) = a b +
    sqrt((1-a^2)(1-b^2)), so the eval is acos-free. The reference's
    std::max(0.0f, NaN) == 0 semantics (out-of-range acos args, zero
    sin(theta)) are reproduced with an explicit validity mask.
    """
    if frame_basis is not None:
        wi = Vec3(dot(wi, frame_basis.t), dot(wi, frame_basis.b), dot(wi, frame_basis.n))
        wo = Vec3(dot(wo, frame_basis.t), dot(wo, frame_basis.b), dot(wo, frame_basis.n))

    cos_i = wi.z
    cos_o = wo.z
    # 1e-12 floors keep sqrt' finite (grad-safe); forward change < 1e-6.
    sin_i = jnp.sqrt(jnp.maximum(1.0 - cos_i * cos_i, 1e-12))
    sin_o = jnp.sqrt(jnp.maximum(1.0 - cos_o * cos_o, 1e-12))

    safe_sin_i = jnp.where(sin_i > 0.0, sin_i, 1.0)
    safe_sin_o = jnp.where(sin_o > 0.0, sin_o, 1.0)
    cphi_i = wi.x / safe_sin_i
    cphi_o = wo.x / safe_sin_o

    valid = (
        (sin_i > 0.0)
        & (sin_o > 0.0)
        & (jnp.abs(cphi_i) <= 1.0)
        & (jnp.abs(cphi_o) <= 1.0)
    )
    cos_dphi = cphi_i * cphi_o + jnp.sqrt(
        jnp.maximum((1.0 - cphi_i * cphi_i) * (1.0 - cphi_o * cphi_o), 1e-12)
    )
    term = jnp.where(valid, jnp.maximum(0.0, cos_dphi), 0.0)

    a, b = oren_nayar_ab(sigma)
    scale = (a + b * term * sin_i * sin_o) / PI
    return albedo * scale


# -- Layered standard BRDF (Materials.hpp:245-306) ---------------------------


def layered_eval(wi: Vec3, wo: Vec3, n: Vec3, params: MaterialParams) -> RGB:
    """(1 - schlick(N.wi)) * diffuse + glossy (Materials.hpp:255-263)."""
    sigma = diffuse_sigma(params.roughness)
    alpha = glossy_alpha(params.roughness)
    d_f = oren_nayar_eval(wi, wo, params.albedo, sigma)
    g_f = glossy_eval(wi, wo, n, params.tint, alpha, params.ior)
    w = 1.0 - schlick(jnp.maximum(0.0, dot(n, wi)), 1.0, params.ior)
    return d_f * w + g_f


def layered_pdf(wi: Vec3, wo: Vec3, n: Vec3, params: MaterialParams) -> Array:
    """Weighted-average pdf over the two layers (Materials.hpp:265-277);
    the diffuse layer samples the uniform hemisphere (base-class default,
    Materials.hpp:105-115)."""
    alpha = glossy_alpha(params.roughness)
    return 0.5 * (hemisphere_pdf() + glossy_pdf(wi, wo, n, alpha))


def layered_pdf_true(wi: Vec3, wo: Vec3, n: Vec3, params: MaterialParams) -> Array:
    """The ACTUAL sampling density of layered_sample's 50/50 mixture:
    0.5 * (uniform hemisphere + the glossy sampler's true density). The
    reference's layered_pdf underweights the glossy component by 2x (the
    replicated quirk, see glossy_sampler_density); the corrected-estimator
    integrator mode (integrator="nee") divides by this instead, and MIS
    weights need it."""
    alpha = glossy_alpha(params.roughness)
    return 0.5 * (hemisphere_pdf() + glossy_sampler_density(wi, wo, n, alpha))


def layered_sample(
    wo: Vec3, x0: Array, x1: Array, x2: Array, basis: Basis, params: MaterialParams
):
    """Sample the layered BRDF (Materials.hpp:279-293).

    Layer choice on x2 < 0.5 (x2 rescale is a no-op here: the base sampler
    consumes only x0/x1). Returns (wi, pdf, f) with pdf the averaged layered
    pdf and f the full layered eval at the sampled direction -- exactly the
    reference's generateDirection contract.
    """
    alpha = glossy_alpha(params.roughness)
    choose_diffuse = x2 < 0.5

    wi_d = hemisphere_sample_basis(x0, x1, basis)
    wi_g = glossy_sample(wo, x0, x1, basis, alpha)
    wi = Vec3(
        jnp.where(choose_diffuse, wi_d.x, wi_g.x),
        jnp.where(choose_diffuse, wi_d.y, wi_g.y),
        jnp.where(choose_diffuse, wi_d.z, wi_g.z),
    )

    pdf = layered_pdf(wi, wo, basis.n, params)
    f = layered_eval(wi, wo, basis.n, params)
    return wi, pdf, f


def emission(params: MaterialParams) -> RGB:
    """StandardMaterial::emission (Materials.hpp:333): position-independent."""
    return params.emission


# Deliberate omission: the reference's LambertBRDF (Materials.hpp:308-323)
# has NO counterpart here. It is dead code in the reference -- nothing
# constructs it (StandardMaterial, the only material reachable from the
# scene API, hardwires LayeredBRDF at Materials.hpp:325-338) -- and it is
# internally inconsistent: its pdf() returns 1/(4 pi) while its inherited
# sampler draws from the uniform *hemisphere* (density 1/(2 pi)). A
# Lambert-like response is expressible anyway: roughness=0 turns the
# Oren-Nayar base into albedo/pi exactly (oren_nayar_ab(0) = (1, 0)). See
# COMPAT.md R7.
