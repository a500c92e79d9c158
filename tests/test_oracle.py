"""Golden-oracle tests: compare cornelis's batched implementations
elementwise against dumps produced by the *actual reference code*
(tools/oracle/oracle_main.cpp links the reference sources and evaluates its
camera / basis / sampling / BRDF / intersection functions on fixed random
inputs). Pins every numeric quirk. Regenerate with tools/oracle/build_oracle.sh."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cornelis import materials as M
from cornelis.camera import generate_rays, look_at
from cornelis.geometry import plane_candidate, sphere_candidate
from cornelis.math.vec import Vec3, construct_basis
from cornelis.rng import hemisphere_sample, hemisphere_sample_basis

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "oracle")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(GOLDEN_DIR), reason="oracle goldens not generated"
)


def load(name, record_size):
    data = np.fromfile(os.path.join(GOLDEN_DIR, name + ".f32"), np.float32)
    assert data.size % record_size == 0
    return data.reshape(-1, record_size)


def vec(cols):
    return Vec3(jnp.asarray(cols[:, 0]), jnp.asarray(cols[:, 1]), jnp.asarray(cols[:, 2]))


def allclose(mine, ref, atol=1e-5, rtol=1e-4, frac=1.0, msg=""):
    mine = np.asarray(mine, np.float64)
    ref = np.asarray(ref, np.float64)
    ok = np.isclose(mine, ref, atol=atol, rtol=rtol) | (
        np.isnan(mine) & np.isnan(ref)
    )
    good = ok.mean()
    assert good >= frac, (
        f"{msg}: {100 * (1 - good):.2f}% mismatched; "
        f"worst |diff|={np.nanmax(np.abs(mine - ref)):.3e}"
    )


class TestModels:
    def test_microfacet_blocks(self):
        r = load("models", 10)
        c, alpha, tan_i, tan_o, ior = (jnp.asarray(r[:, k]) for k in range(5))
        allclose(M.distribution_gtr2(c, alpha), r[:, 5], msg="gtr2")
        allclose(M.distribution_gtr3p2(c, alpha), r[:, 6], msg="gtr3p2")
        allclose(M.lambda_tr(tan_i, alpha), r[:, 7], msg="lambda")
        allclose(M.shadow_masking_tr(tan_i, tan_o, alpha), r[:, 8], msg="shadow")
        allclose(M.schlick(c, 1.0, ior), r[:, 9], msg="schlick")


class TestBasis:
    def test_construct_basis(self):
        r = load("basis", 9)
        b = construct_basis(vec(r[:, 0:3]))
        allclose(b.t.x, r[:, 3], msg="T.x")
        allclose(b.t.y, r[:, 4], msg="T.y")
        allclose(b.t.z, r[:, 5], msg="T.z")
        allclose(b.b.x, r[:, 6], msg="B.x")
        allclose(b.b.y, r[:, 7], msg="B.y")
        allclose(b.b.z, r[:, 8], msg="B.z")


class TestHemisphere:
    def test_mapping(self):
        r = load("hemisphere", 11)
        x1, x2 = jnp.asarray(r[:, 0]), jnp.asarray(r[:, 1])
        v = hemisphere_sample(x1, x2)
        allclose(v.x, r[:, 5], msg="v.x")
        allclose(v.y, r[:, 6], msg="v.y")
        allclose(v.z, r[:, 7], msg="v.z")
        basis = construct_basis(vec(r[:, 2:5]))
        w = hemisphere_sample_basis(x1, x2, basis)
        allclose(w.x, r[:, 8], msg="w.x")
        allclose(w.y, r[:, 9], msg="w.y")
        allclose(w.z, r[:, 10], msg="w.z")


class TestCamera:
    def test_lookat_rays(self):
        r = load("camera", 16)
        # Vectorize over cases via per-case scalar camera build.
        mism = 0
        n = r.shape[0]
        step = max(1, n // 256)  # subsample for speed; all math paths hit
        for row in r[::step]:
            cam = look_at(tuple(row[0:3]), tuple(row[3:6]), row[6], row[7])
            o, d = generate_rays(cam, jnp.float32(row[8]), jnp.float32(row[9]))
            mine = np.array(
                [float(o.x), float(o.y), float(o.z), float(d.x), float(d.y), float(d.z)]
            )
            ref = row[10:16]
            if not np.allclose(mine, ref, atol=2e-5):
                mism += 1
        assert mism == 0, f"{mism} camera cases mismatched"


class TestOrenNayar:
    def test_eval(self):
        r = load("orennayar", 16)
        wi, wo = vec(r[:, 3:6]), vec(r[:, 6:9])
        sigma = jnp.asarray(r[:, 9])
        albedo = vec(r[:, 10:13])
        f = M.oren_nayar_eval(wi, wo, albedo, sigma)
        # float32 acos-free identity vs the reference's acos chain: allow a
        # slightly looser absolute tolerance.
        allclose(f.x, r[:, 13], atol=1e-4, rtol=1e-3, msg="f.x")
        allclose(f.y, r[:, 14], atol=1e-4, rtol=1e-3, msg="f.y")
        allclose(f.z, r[:, 15], atol=1e-4, rtol=1e-3, msg="f.z")


class TestGlossy:
    def test_eval_pdf_sample(self):
        r = load("glossy", 27)
        n, wi, wo = vec(r[:, 0:3]), vec(r[:, 3:6]), vec(r[:, 6:9])
        alpha, ior = jnp.asarray(r[:, 9]), jnp.asarray(r[:, 10])
        tint = vec(r[:, 11:14])
        f = M.glossy_eval(wi, wo, n, tint, alpha, ior)
        allclose(f.x, r[:, 14], atol=1e-4, rtol=2e-3, msg="eval.x")
        allclose(f.y, r[:, 15], atol=1e-4, rtol=2e-3, msg="eval.y")

        pdf = M.glossy_pdf(wi, wo, n, alpha)
        allclose(pdf, r[:, 17], atol=1e-4, rtol=2e-3, msg="pdf")

        basis = construct_basis(n)
        x0, x1 = jnp.asarray(r[:, 18]), jnp.asarray(r[:, 19])
        wi_s = M.glossy_sample(wo, x0, x1, basis, alpha)
        allclose(wi_s.x, r[:, 20], atol=5e-4, rtol=1e-3, msg="sample.x")
        allclose(wi_s.y, r[:, 21], atol=5e-4, rtol=1e-3, msg="sample.y")
        allclose(wi_s.z, r[:, 22], atol=5e-4, rtol=1e-3, msg="sample.z")


class TestLayered:
    def test_eval_pdf_sample(self):
        r = load("layered", 31)
        n, wi, wo = vec(r[:, 0:3]), vec(r[:, 3:6]), vec(r[:, 6:9])
        rough, ior = jnp.asarray(r[:, 9]), jnp.asarray(r[:, 10])
        albedo, tint = vec(r[:, 11:14]), vec(r[:, 14:17])
        params = M.MaterialParams(
            albedo=albedo,
            emission=albedo,  # unused by eval
            tint=tint,
            roughness=rough,
            ior=ior,
        )
        f = M.layered_eval(wi, wo, n, params)
        allclose(f.x, r[:, 17], atol=2e-4, rtol=2e-3, msg="eval.x")
        allclose(f.y, r[:, 18], atol=2e-4, rtol=2e-3, msg="eval.y")
        allclose(f.z, r[:, 19], atol=2e-4, rtol=2e-3, msg="eval.z")

        pdf = M.layered_pdf(wi, wo, n, params)
        allclose(pdf, r[:, 20], atol=1e-4, rtol=2e-3, msg="pdf")

        basis = construct_basis(n)
        x0, x1, x2 = (jnp.asarray(r[:, k]) for k in (21, 22, 23))
        wi_s, pdf_s, f_s = M.layered_sample(wo, x0, x1, x2, basis, params)
        allclose(wi_s.x, r[:, 24], atol=5e-4, rtol=1e-3, msg="sample wi.x")
        allclose(wi_s.y, r[:, 25], atol=5e-4, rtol=1e-3, msg="sample wi.y")
        allclose(wi_s.z, r[:, 26], atol=5e-4, rtol=1e-3, msg="sample wi.z")
        # Low-roughness (Burley alpha=r^2 ~ 1e-2) glossy samples have GGX D in
        # the 1e2..1e3 range; float32 evaluation-order differences amplify to
        # ~0.5% relative there while the sampled directions still match to
        # ~1e-4. Pure precision, not logic — hence the looser rtol.
        allclose(pdf_s, r[:, 27], atol=1e-4, rtol=8e-3, msg="sample pdf")
        allclose(f_s.x, r[:, 28], atol=2e-4, rtol=8e-3, msg="sample f.x")


class TestIntersections:
    def test_sphere(self):
        r = load("sphere_isect", 19)
        o, d, c = vec(r[:, 0:3]), vec(r[:, 3:6]), vec(r[:, 6:9])
        radius = jnp.asarray(r[:, 9])
        prev = np.where(r[:, 10] < 0, np.inf, r[:, 10])
        ref_t = np.where(r[:, 11] < 0, np.inf, r[:, 11])

        t, p, n, valid = sphere_candidate(o, d, c, radius)
        t = np.asarray(t)
        # Apply the closest-hit rule: update only when prev > t.
        final_t = np.where(np.asarray(valid) & (prev > t), t, prev)
        allclose(
            np.where(np.isinf(final_t), -1.0, final_t),
            np.where(np.isinf(ref_t), -1.0, ref_t),
            atol=1e-3,
            rtol=1e-3,
            msg="t",
        )
        updated = np.asarray(valid) & (prev > t) & np.isfinite(t)
        for comp, col, name in ((p.x, 12, "p.x"), (p.y, 13, "p.y"), (n.x, 15, "n.x"), (n.z, 17, "n.z")):
            allclose(
                np.asarray(comp)[updated], r[updated, col], atol=1e-3, rtol=1e-3, msg=name
            )

    def test_plane(self):
        r = load("plane_isect", 19)
        o, d = vec(r[:, 0:3]), vec(r[:, 3:6])
        pn, pp = vec(r[:, 6:9]), vec(r[:, 9:12])
        w, h = jnp.asarray(r[:, 12]), jnp.asarray(r[:, 13])
        prev = np.where(r[:, 14] < 0, np.inf, r[:, 14])
        ref_t = np.where(r[:, 15] < 0, np.inf, r[:, 15])

        t, p, n, valid = plane_candidate(o, d, pn, pp, w, h)
        t = np.asarray(t)
        final_t = np.where(np.asarray(valid) & (prev > t), t, prev)
        allclose(
            np.where(np.isinf(final_t), -1.0, final_t),
            np.where(np.isinf(ref_t), -1.0, ref_t),
            atol=1e-3,
            rtol=1e-3,
            # The extents test compares |.|*2 against width with float32
            # rounding; allow a hair of edge flips.
            frac=0.999,
            msg="t",
        )
