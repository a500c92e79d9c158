// Golden-oracle generator.
//
// Links against the reference implementation (mounted read-only at
// /root/reference) and evaluates its camera / basis / sampling / BRDF /
// intersection functions on fixed pseudo-random inputs, dumping raw float32
// vectors. The Python test suite (tests/test_oracle.py) replays the same
// inputs through cornelis and compares elementwise -- pinning every
// numeric quirk of the reference (camera skew, GTR normalizations, NaN->0
// max semantics, pdf fallbacks, closest-hit rules).
//
// This file is new code; it *uses* the reference as a library (headers
// included from the read-only mount), it does not copy it.
//
// Build & run: tools/oracle/build_oracle.sh

#include <cornelis/Camera.hpp>
#include <cornelis/Geometry.hpp>
#include <cornelis/Materials.hpp>
#include <cornelis/Math.hpp>
#include <cornelis/PRNG.hpp>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <random>
#include <string>
#include <vector>

using namespace cornelis;

static std::mt19937 gen(123456789u);

static float urand() {
    // Note: uses doubles then truncates, deterministic across platforms for
    // a fixed libstdc++; inputs are also dumped so exactness of the
    // generator does not matter.
    std::uniform_real_distribution<float> dist(0.0f, 1.0f);
    return dist(gen);
}

static float srange(float lo, float hi) { return lo + (hi - lo) * urand(); }

static float3 unit_vector() {
    // Uniform direction on the sphere.
    float z = srange(-1.0f, 1.0f);
    float a = srange(0.0f, 2.0f * Pi);
    float r = std::sqrt(std::max(0.0f, 1.0f - z * z));
    return float3(r * std::cos(a), r * std::sin(a), z);
}

static float3 unit_hemisphere(float3 const &n) {
    float3 v = unit_vector();
    if (dot(v, n) < 0.0f)
        v = -v;
    return v;
}

struct Dump {
    std::vector<float> values;
    void push(float v) { values.push_back(v); }
    void push(float3 const &v) {
        values.push_back(v(0));
        values.push_back(v(1));
        values.push_back(v(2));
    }
    void push(RGB const &v) {
        values.push_back(v(0));
        values.push_back(v(1));
        values.push_back(v(2));
    }
    void save(std::string const &dir, std::string const &name) const {
        std::string path = dir + "/" + name + ".f32";
        FILE *f = std::fopen(path.c_str(), "wb");
        if (!f) {
            std::perror(path.c_str());
            std::exit(1);
        }
        std::fwrite(values.data(), sizeof(float), values.size(), f);
        std::fclose(f);
        std::printf("%s: %zu floats\n", name.c_str(), values.size());
    }
};

int main(int argc, char **argv) {
    std::string outdir = argc > 1 ? argv[1] : "tests/golden/oracle";
    int const N = 2048;

    // ---- models: GTR2 / GTR3p2 / lambdaTR / shadowMaskingTR / schlick ----
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            float c = srange(0.0f, 1.0f);
            float alpha = srange(0.0f, 1.0f);
            float tan_i = srange(0.0f, 20.0f);
            float tan_o = srange(0.0f, 20.0f);
            float ior = srange(0.4f, 2.5f);
            d.push(c);
            d.push(alpha);
            d.push(tan_i);
            d.push(tan_o);
            d.push(ior);
            d.push(models::distributionGTR2(c, alpha));
            d.push(models::distributionGTR3p2(c, alpha));
            d.push(models::lambdaTR(tan_i, alpha));
            d.push(models::shadowMaskingTR(tan_i, tan_o, alpha));
            d.push(models::schlick(c, 1.0f, ior));
        }
        d.save(outdir, "models");
    }

    // ---- constructBasis ----
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            float3 n = normalize(unit_vector());
            Basis b = constructBasis(n);
            d.push(n);
            d.push(b.T);
            d.push(b.B);
        }
        d.save(outdir, "basis");
    }

    // ---- randomHemisphere mapping (canonical + basis placement) ----
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            float x1 = urand(), x2 = urand();
            float3 n = normalize(unit_vector());
            Basis b = constructBasis(n);
            float3 v = randomHemisphere(float2(x1, x2));
            float3 w = randomHemisphere(float2(x1, x2), b);
            d.push(x1);
            d.push(x2);
            d.push(n);
            d.push(v);
            d.push(w);
        }
        d.save(outdir, "hemisphere");
    }

    // ---- camera: lookAt frame + ray directions ----
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            V3 from(srange(-10, 10), srange(-10, 10), srange(-10, 10));
            V3 at(srange(-10, 10), srange(-10, 10), srange(-10, 10));
            float aspect = srange(0.3f, 3.0f);
            float hfov = srange(0.2f, 2.5f);
            float x = urand(), y = urand();
            auto cam = PerspectiveCamera::lookAt(from, at, aspect, hfov);
            Ray r = cam(x, y);
            d.push(float3(from[0], from[1], from[2]));
            d.push(float3(at[0], at[1], at[2]));
            d.push(aspect);
            d.push(hfov);
            d.push(x);
            d.push(y);
            d.push(float3(r.eye()[0], r.eye()[1], r.eye()[2]));
            d.push(float3(r.dir()[0], r.dir()[1], r.dir()[2]));
        }
        d.save(outdir, "camera");
    }

    // ---- OrenNayar eval (the world-frame quirk captured verbatim) ----
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            float3 n = normalize(unit_vector());
            float3 wi = unit_hemisphere(n);
            float3 wo = unit_hemisphere(n);
            float sigma = srange(0.0f, 1.0f);
            RGB albedo(srange(0, 1), srange(0, 1), srange(0, 1));
            OrenNayarBRDF brdf(albedo, sigma);
            RGB f = brdf(wi, wo, n);
            // The reference can emit NaN through acos out-of-range in
            // degenerate configs; record raw (tests treat NaN==NaN).
            d.push(n);
            d.push(wi);
            d.push(wo);
            d.push(sigma);
            d.push(albedo);
            d.push(f);
        }
        d.save(outdir, "orennayar");
    }

    // ---- Glossy eval / pdf / sample ----
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            float3 n = normalize(unit_vector());
            Basis b = constructBasis(n);
            float3 wi = unit_hemisphere(n);
            float3 wo = unit_hemisphere(n);
            float alpha = srange(0.0f, 1.0f);
            float ior = srange(0.4f, 2.5f);
            RGB tint(srange(0, 1), srange(0, 1), srange(0, 1));
            GlossyBRDF brdf(tint, alpha, ior);
            RGB f = brdf(wi, wo, n);
            float pdf = brdf.pdf(wi, wo, b);

            float x0 = urand(), x1 = urand();
            float3 wi_s{};
            float pdf_s = 0.0f;
            RGB f_s = brdf.generateDirection(wo, float3(x0, x1, 0.0f), b, wi_s, pdf_s);

            d.push(n);
            d.push(wi);
            d.push(wo);
            d.push(alpha);
            d.push(ior);
            d.push(tint);
            d.push(f);
            d.push(pdf);
            d.push(x0);
            d.push(x1);
            d.push(wi_s);
            d.push(pdf_s);
            d.push(f_s);
        }
        d.save(outdir, "glossy");
    }

    // ---- Layered eval / pdf / sample (the standard material BRDF) ----
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            float3 n = normalize(unit_vector());
            Basis b = constructBasis(n);
            float3 wi = unit_hemisphere(n);
            float3 wo = unit_hemisphere(n);
            float rough = srange(0.0f, 1.0f);
            float ior = srange(0.4f, 2.5f);
            RGB albedo(srange(0, 1), srange(0, 1), srange(0, 1));
            RGB tint(srange(0, 1), srange(0, 1), srange(0, 1));
            LayeredBRDF brdf(albedo, tint, rough, ior);
            RGB f = brdf(wi, wo, n);
            float pdf = brdf.pdf(wi, wo, b);

            float x0 = urand(), x1 = urand(), x2 = urand();
            float3 wi_s{};
            float pdf_s = 0.0f;
            RGB f_s = brdf.generateDirection(wo, float3(x0, x1, x2), b, wi_s, pdf_s);

            d.push(n);
            d.push(wi);
            d.push(wo);
            d.push(rough);
            d.push(ior);
            d.push(albedo);
            d.push(tint);
            d.push(f);
            d.push(pdf);
            d.push(x0);
            d.push(x1);
            d.push(x2);
            d.push(wi_s);
            d.push(pdf_s);
            d.push(f_s);
        }
        d.save(outdir, "layered");
    }

    // ---- intersectSphere / intersectPlane (single-ray batches) ----
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            // Random ray near the origin, random sphere.
            float3 o(srange(-5, 5), srange(-5, 5), srange(-5, 5));
            float3 dir = unit_vector();
            if (i % 7 == 0)
                dir = dir * float3(srange(0.5f, 3.0f)); // non-normalized
            float3 c(srange(-5, 5), srange(-5, 5), srange(-5, 5));
            float radius = srange(0.2f, 3.0f);
            float prev_t = (i % 5 == 0) ? srange(0.0f, 4.0f) : INFINITY;

            std::vector<float> ox{o(0)}, oy{o(1)}, oz{o(2)};
            std::vector<float> dx{dir(0)}, dy{dir(1)}, dz{dir(2)};
            IntersectionData data(1);
            data.get<tags::RayParam0>()[0] = prev_t;
            std::vector<std::size_t> active{0};
            intersectSphere({ox, oy, oz}, {dx, dy, dz}, c, radius, 3, data, active);

            float t = data.get<tags::RayParam0>()[0];
            auto [px, py, pz] = getPositions(data);
            auto [nx, ny, nz] = getNormalSpans(data);
            d.push(o);
            d.push(dir);
            d.push(c);
            d.push(radius);
            d.push(prev_t == INFINITY ? -1.0f : prev_t);
            d.push(std::isinf(t) ? -1.0f : t);
            d.push(float3(px[0], py[0], pz[0]));
            d.push(float3(nx[0], ny[0], nz[0]));
            d.push(float(data.get<tags::MaterialId>()[0]));
        }
        d.save(outdir, "sphere_isect");
    }
    {
        Dump d;
        for (int i = 0; i < N; i++) {
            float3 o(srange(-5, 5), srange(-5, 5), srange(-5, 5));
            float3 dir = unit_vector();
            float3 pn = normalize(unit_vector());
            float3 pp(srange(-5, 5), srange(-5, 5), srange(-5, 5));
            float w = srange(0.5f, 8.0f), h = srange(0.5f, 8.0f);
            float prev_t = (i % 5 == 0) ? srange(0.0f, 4.0f) : INFINITY;

            std::vector<float> ox{o(0)}, oy{o(1)}, oz{o(2)};
            std::vector<float> dx{dir(0)}, dy{dir(1)}, dz{dir(2)};
            IntersectionData data(1);
            data.get<tags::RayParam0>()[0] = prev_t;
            std::vector<std::size_t> active{0};
            intersectPlane({ox, oy, oz}, {dx, dy, dz}, pn, pp, w, h, 5, data, active);

            float t = data.get<tags::RayParam0>()[0];
            auto [px, py, pz] = getPositions(data);
            d.push(o);
            d.push(dir);
            d.push(pn);
            d.push(pp);
            d.push(w);
            d.push(h);
            d.push(prev_t == INFINITY ? -1.0f : prev_t);
            d.push(std::isinf(t) ? -1.0f : t);
            d.push(float3(px[0], py[0], pz[0]));
        }
        d.save(outdir, "plane_isect");
    }

    std::printf("oracle dumps written to %s\n", outdir.c_str());
    return 0;
}
