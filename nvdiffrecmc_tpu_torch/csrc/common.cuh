// Shared device math for the port's kernels.  Every expression follows the
// plain PyTorch version in nvdiffrecmc_tpu_torch/ops/pallas_shade.py term
// by term and in the same order; the library is built with --fmad=false, so
// no multiply-add contraction changes the rounding.
#pragma once

#include <cuda_runtime.h>

#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.28318530717958647692f
#define HALF_PI_F 1.57079632679489661923f
#define TWO_PI_SQ_F 19.7392088021787172376f   // 2 * pi * pi
#define ONE_MINUS_EPS_F 0.99999994f

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 mk3(float x, float y, float z) {
    V3 r;
    r.x = x;
    r.y = y;
    r.z = z;
    return r;
}

__device__ __forceinline__ float dot3(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
    return mk3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
               a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ V3 normalize3(V3 a) {
    float inv = rsqrtf(fmaxf(dot3(a, a), 1e-20f));
    return mk3(a.x * inv, a.y * inv, a.z * inv);
}

// Pixar branchless orthonormal basis around n.
__device__ __forceinline__ void onb(V3 n, V3* b1, V3* b2) {
    float sign = n.z >= 0.f ? 1.f : -1.f;
    float a = -1.f / (sign + n.z);
    float b = n.x * n.y * a;
    *b1 = mk3(1.f + sign * n.x * n.x * a, sign * b, -sign * n.x);
    *b2 = mk3(b, sign + n.y * n.y * a, -n.y);
}

// Polynomial acos / atan2 of the JAX package's kernels (pallas_shade.py).
__device__ __forceinline__ float acos_poly(float x) {
    float ax = fabsf(x);
    float p = ((-0.0187293f * ax + 0.0742610f) * ax - 0.2121144f) * ax
              + 1.5707288f;
    float r = sqrtf(fmaxf(1.f - ax, 0.f)) * p;
    return x >= 0.f ? r : PI_F - r;
}

__device__ __forceinline__ float atan2_poly(float y, float x) {
    float ax = fabsf(x), ay = fabsf(y);
    float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
    float t = mn / fmaxf(mx, 1e-30f);
    float s = t * t;
    float r = ((-0.0464964749f * s + 0.15931422f) * s - 0.327622764f) * s * t
              + t;
    r = ay > ax ? HALF_PI_F - r : r;
    r = x < 0.f ? PI_F - r : r;
    return y < 0.f ? -r : r;
}

__device__ __forceinline__ void dir_to_uv(V3 d, float* u, float* v) {
    *u = atan2_poly(d.x, -d.z) / TWO_PI_F + 0.5f;
    *v = acos_poly(fminf(fmaxf(d.y, -1.f), 1.f)) / PI_F;
}

__device__ __forceinline__ V3 uv_to_dir(float u, float v) {
    float phi = (u * 2.f - 1.f) * PI_F;
    float theta = v * PI_F;
    float st = sinf(theta);
    return mk3(st * sinf(phi), cosf(theta), -st * cosf(phi));
}

__device__ __forceinline__ float ndf_ggx(float alpha, float ct) {
    float a2 = alpha * alpha;
    float d = (ct * a2 - ct) * ct + 1.f;
    return a2 / (d * d * PI_F);
}

__device__ __forceinline__ float g1_ggx(float alpha_sqr, float ct) {
    float c2 = ct * ct;
    float t2 = fmaxf(1.f - c2, 0.f) / fmaxf(c2, 1e-12f);
    float g = 2.f / (1.f + sqrtf(1.f + alpha_sqr * t2));
    return ct > 0.f ? g : 0.f;
}

__device__ __forceinline__ float ggx_pdf(V3 n, V3 wo, V3 wi, float alpha) {
    V3 w = normalize3(n);
    V3 u, v;
    onb(w, &u, &v);
    V3 wo_l = mk3(dot3(wo, u), dot3(wo, v), dot3(wo, w));
    V3 wi_l = mk3(dot3(wi, u), dot3(wi, v), dot3(wi, w));
    V3 m = normalize3(mk3(wi_l.x + wo_l.x, wi_l.y + wo_l.y, wi_l.z + wo_l.z));
    float woDotH = dot3(m, wo_l);
    float D = ndf_ggx(alpha, m.z);
    float G1 = g1_ggx(alpha * alpha, wo_l.z);
    float pdf = G1 * D * fmaxf(woDotH, 0.f) / fmaxf(wo_l.z, 1e-12f);
    pdf = pdf / fmaxf(4.f * woDotH, 1e-12f);
    return (wo_l.z > 0.f && wi_l.z > 0.f) ? pdf : 0.f;
}

__device__ __forceinline__ float acc_pdf(float pdf, float opdf, float b) {
    return pdf + (b > 1e-6f ? opdf * b : 0.f);
}

__device__ __forceinline__ float bsdf_pdf(float p_diffuse, V3 n, V3 wo, V3 wi,
                                          float alpha) {
    float NdotL = dot3(n, wi);
    float NdotV = dot3(n, wo);
    float cosine_pdf = fmaxf(NdotL, 0.f) / PI_F;
    float g_pdf = ggx_pdf(n, wo, wi, alpha);
    float pdf = acc_pdf(0.f, cosine_pdf, p_diffuse);
    pdf = acc_pdf(pdf, g_pdf, 1.f - p_diffuse);
    return fminf(NdotV, NdotL) < 1e-6f ? 1.f : pdf;
}

__device__ __forceinline__ V3 cosine_sample(V3 n, float u, float v,
                                            float* pdf) {
    V3 nn = normalize3(n);
    V3 dx, dy;
    onb(nn, &dx, &dy);
    float phi = TWO_PI_F * u;
    float ct = sqrtf(v);
    float st = sqrtf(fmaxf(1.f - v, 0.f));
    float x = cosf(phi) * st;
    float y = sinf(phi) * st;
    *pdf = fmaxf(ct / PI_F, 1e-6f);
    return normalize3(mk3(dx.x * x + dy.x * y + nn.x * ct,
                          dx.y * x + dy.y * y + nn.y * ct,
                          dx.z * x + dy.z * y + nn.z * ct));
}

__device__ __forceinline__ V3 ggx_sample(V3 n, V3 wo, float u, float v,
                                         float alpha, float* pdf_out) {
    V3 w = normalize3(n);
    V3 uax, vax;
    onb(w, &uax, &vax);
    V3 wo_l = normalize3(mk3(dot3(wo, uax), dot3(wo, vax), dot3(wo, w)));
    float cosNO = wo_l.z;

    V3 Vh = normalize3(mk3(alpha * wo_l.x, alpha * wo_l.y, wo_l.z));
    float lensq = Vh.x * Vh.x + Vh.y * Vh.y;
    float inv_len = rsqrtf(fmaxf(lensq, 1e-30f));
    bool near_z = Vh.z >= 0.9999f;
    V3 T1 = mk3(near_z ? 1.f : -Vh.y * inv_len, near_z ? 0.f : Vh.x * inv_len,
                0.f);
    V3 T2 = cross3(Vh, T1);

    float r = sqrtf(u);
    float phi = TWO_PI_F * v;
    float t1 = r * cosf(phi);
    float t2 = r * sinf(phi);
    float s = 0.5f * (1.f + Vh.z);
    t2 = (1.f - s) * sqrtf(fmaxf(1.f - t1 * t1, 0.f)) + s * t2;
    float t3 = sqrtf(fmaxf(1.f - t1 * t1 - t2 * t2, 0.f));
    V3 Nh = mk3(T1.x * t1 + T2.x * t2 + Vh.x * t3,
                T1.y * t1 + T2.y * t2 + Vh.y * t3,
                T1.z * t1 + T2.z * t2 + Vh.z * t3);
    V3 h = normalize3(mk3(alpha * Nh.x, alpha * Nh.y, fmaxf(Nh.z, 0.f)));

    float G1 = g1_ggx(alpha * alpha, wo_l.z);
    float D = ndf_ggx(alpha, h.z);
    float woDotH = dot3(wo_l, h);
    float pdf = G1 * D * fmaxf(woDotH, 0.f) / fmaxf(wo_l.z, 1e-12f);
    V3 wi_l = mk3(h.x * 2.f * woDotH - wo_l.x, h.y * 2.f * woDotH - wo_l.y,
                  h.z * 2.f * woDotH - wo_l.z);
    pdf = pdf / fmaxf(4.f * woDotH, 1e-12f);
    V3 wi = normalize3(
        mk3(uax.x * wi_l.x + vax.x * wi_l.y + w.x * wi_l.z,
            uax.y * wi_l.x + vax.y * wi_l.y + w.y * wi_l.z,
            uax.z * wi_l.x + vax.z * wi_l.y + w.z * wi_l.z));
    bool front = cosNO > 0.f;
    *pdf_out = front ? pdf : 0.f;
    return front ? wi : mk3(0.f, 0.f, 0.f);
}

__device__ __forceinline__ V3 bsdf_sample(float p_diffuse, V3 n, V3 wo,
                                          float u, float v, float z,
                                          float alpha, float* pdf_out) {
    float d_pdf;
    V3 d_dir = cosine_sample(n, u, v, &d_pdf);
    d_pdf = d_pdf * p_diffuse;
    d_pdf = acc_pdf(d_pdf, ggx_pdf(n, wo, d_dir, alpha), 1.f - p_diffuse);
    V3 nn = normalize3(n);
    bool deg = p_diffuse < 1e-4f;
    if (deg) {
        d_dir = nn;
        d_pdf = 1.f;
    }
    float s_pdf;
    V3 s_dir = ggx_sample(n, wo, u, v, alpha, &s_pdf);
    s_pdf = s_pdf * (1.f - p_diffuse);
    float cosine_pdf = fmaxf(dot3(n, s_dir), 0.f) / PI_F;
    s_pdf = acc_pdf(s_pdf, cosine_pdf, p_diffuse);
    bool take_d = z < p_diffuse;
    *pdf_out = take_d ? d_pdf : s_pdf;
    return take_d ? d_dir : s_dir;
}
