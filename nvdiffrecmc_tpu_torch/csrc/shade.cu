// Shadow-ray tracing + demodulated shading, forward: a trace pass with one
// thread per ray slot, then a shading pass with one thread per pixel.
//
// Replaces the Pallas kernel _shade_fwd_kernel (nvdiffrecmc_tpu/ops/
// pallas_shade.py:568, launched from env_shade_fused :895) together with
// the pass that builds its per-block leaf visit lists (_build_lists :859).
// The TPU kernel tests whole ray blocks against the union of their leaves
// with Plücker matmuls; here every ray walks the BVH on its own: supernode
// box, leaf box, sub-box, then the sub-box's triangles, stopping at the
// first hit (the walk is trace.cuh, shared with the standalone tracer
// trace.cu; the block's supernode and leaf boxes sit in shared memory).
// The triangle test is the Plücker any-hit of ops/bvh.py in the same
// arithmetic order as the plain version (ops/tracer.py), so both give the
// same bits.
//
// Trace pass (shade_trace_kernel): one thread per (stratum s, light or
// BSDF, pixel) of the 2 n2 P ray slots writes the ray's visibility to visw;
// masked pixels write 1 without tracing.  Shading pass (shade_kernel): per
// pixel and stratum s = 0..n2-1 (the JAX accumulation order), read both
// visibilities, evaluate the demodulated BSDF for both directions and
// accumulate diffuse and specular twice, with visibility and with
// everything visible; masked pixels write zeros.  One thread walking its
// pixel's 2 n2 rays one after another (the kernel before the split) kept
// the lanes of masked pixels idle for all of them and took 2.5x the trace
// pass's time (bench_walk.py; PERF.md).
//
// What bounds it: the BVH walk of the trace pass.  Each ray tests ~26
// supernode boxes and the leaf boxes of the supernodes it enters (shared
// memory), the sub-boxes of the leaves it enters and G triangles per
// sub-box it enters (22 floats each, from a 2.5 MB triangle table that
// stays in L2); threads of a warp diverge across boxes.  It is bound by
// L1/L2 load throughput and warp divergence, not by DRAM.
//
// Layouts: samp [n2, 16, P] (sample.cu); gb [19, P] (ro3, pos3, nrm3,
// view3, kd3, ks3, mask); the structure as trace.cuh's Walk; out [12, P]
// (diff3|spec3 visible, diff3|spec3 all visible); visw [n2, 2P] (light
// rays, then BSDF rays).

#include "trace.cuh"

// Demodulated BSDF (pallas_shade.eval_demodulated_c): Lambert term and the
// three specular channels for direction wi.
__device__ __forceinline__ void eval_demod(V3 kd, V3 ks, V3 nrm, V3 wo, V3 wi,
                                           int bsdf, float* diff,
                                           float spec[3]) {
    *diff = fmaxf(dot3(nrm, wi), 0.f) / PI_F;
    if (bsdf != 0) {
        spec[0] = spec[1] = spec[2] = 0.f;
        return;
    }
    float occ = ks.x, rough = ks.y, metal = ks.z;
    float alpha = fminf(fmaxf(rough * rough, MIN_ROUGHNESS_SQ), 1.f);
    float alpha_sqr = alpha * alpha;
    float kdc[3] = {kd.x, kd.y, kd.z};
    V3 h = normalize3(mk3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z));
    float woDotN = dot3(wo, nrm);
    float wiDotN = dot3(wi, nrm);
    float woDotH = dot3(wo, h);
    float nDotH = dot3(nrm, h);
    float c = clip01(nDotH);
    float d_ = (c * alpha_sqr - c) * c + 1.f;
    float D = alpha_sqr / (d_ * d_ * PI_F);
    float G = 1.f / (1.f + lam(woDotN, alpha_sqr) + lam(wiDotN, alpha_sqr));
    float fc = powf(1.f - clip01(woDotH), 5.f);
    float w = D * G * 0.25f / fmaxf(woDotN, SPECULAR_EPSILON);
    float front = (woDotN > SPECULAR_EPSILON && wiDotN > SPECULAR_EPSILON)
                      ? 1.f : 0.f;
    for (int k = 0; k < 3; ++k) {
        float sc = (0.04f * (1.f - metal) + kdc[k] * metal) * (1.f - occ);
        spec[k] = (sc + (1.f - sc) * fc) * w * front;
    }
}

__global__ void shade_trace_kernel(const float* __restrict__ samp,
                                   const float* __restrict__ gb, Walk w,
                                   float* __restrict__ visw, int n2, int P,
                                   float tmin) {
    extern __shared__ float4 top[];
    load_top(top, w);
    const size_t sP = (size_t)P;
    size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (size_t)n2 * 2 * sP) return;
    int p = (int)(i % sP);
    size_t sk = i / sP;  // 2 s + k: k = 0 the light ray, 1 the BSDF ray
    if (!(gb[18 * sP + p] > 0.f)) {
        visw[i] = 1.f;
        return;
    }
    V3 ro = mk3(gb[p], gb[sP + p], gb[2 * sP + p]);
    const float* dp = samp + ((sk / 2) * 16 + 3 * (sk % 2)) * sP + p;
    V3 dir = mk3(dp[0], dp[sP], dp[2 * sP]);
    visw[i] = any_hit(ro, dir, top, w, tmin) ? 0.f : 1.f;
}

__global__ void shade_kernel(const float* __restrict__ samp,
                             const float* __restrict__ gb,
                             const float* __restrict__ visw,
                             float* __restrict__ out, int n2, int P,
                             int bsdf) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const size_t sP = (size_t)P;
    if (!(gb[18 * sP + p] > 0.f)) {
        for (int k = 0; k < 12; ++k) out[k * sP + p] = 0.f;
        return;
    }
    V3 pos = mk3(gb[3 * sP + p], gb[4 * sP + p], gb[5 * sP + p]);
    V3 nrm = mk3(gb[6 * sP + p], gb[7 * sP + p], gb[8 * sP + p]);
    V3 view = mk3(gb[9 * sP + p], gb[10 * sP + p], gb[11 * sP + p]);
    V3 kd = mk3(gb[12 * sP + p], gb[13 * sP + p], gb[14 * sP + p]);
    V3 ks = mk3(gb[15 * sP + p], gb[16 * sP + p], gb[17 * sP + p]);
    V3 wo = normalize3(mk3(view.x - pos.x, view.y - pos.y, view.z - pos.z));
    float sample_frac = 1.f / (float)n2;

    float acc[12];
    for (int k = 0; k < 12; ++k) acc[k] = 0.f;
    for (int s = 0; s < n2; ++s) {
        const float* sp = samp + (size_t)s * 16 * sP + p;
        V3 l_dir = mk3(sp[0], sp[sP], sp[2 * sP]);
        V3 b_dir = mk3(sp[3 * sP], sp[4 * sP], sp[5 * sP]);
        float l_mis = 1.f / fmaxf(sp[6 * sP], 1e-4f);
        float b_mis = 1.f / fmaxf(sp[7 * sP], 1e-4f);
        float l_rad[3] = {sp[8 * sP], sp[9 * sP], sp[10 * sP]};
        float b_rad[3] = {sp[11 * sP], sp[12 * sP], sp[13 * sP]};
        float vis_l = visw[(size_t)s * 2 * sP + p];
        float vis_b = visw[(size_t)s * 2 * sP + sP + p];

        float dl, db, sl[3], sb[3];
        eval_demod(kd, ks, nrm, wo, l_dir, bsdf, &dl, sl);
        eval_demod(kd, ks, nrm, wo, b_dir, bsdf, &db, sb);
        float wl = vis_l * l_mis * sample_frac;
        float wb = vis_b * b_mis * sample_frac;
        float wla = 1.f * l_mis * sample_frac;
        float wba = 1.f * b_mis * sample_frac;
        for (int c = 0; c < 3; ++c) {
            acc[c] = acc[c] + (dl * (l_rad[c] * wl) + db * (b_rad[c] * wb));
            acc[3 + c] = acc[3 + c]
                         + (sl[c] * (l_rad[c] * wl) + sb[c] * (b_rad[c] * wb));
            acc[6 + c] = acc[6 + c]
                         + (dl * (l_rad[c] * wla) + db * (b_rad[c] * wba));
            acc[9 + c] = acc[9 + c]
                         + (sl[c] * (l_rad[c] * wla) + sb[c] * (b_rad[c] * wba));
        }
    }
    for (int k = 0; k < 12; ++k) out[k * sP + p] = acc[k];
}

extern "C" int nvk_trace_shade(const float* samp, const float* gb,
                               const float* tri, const float* aabb_lo,
                               const float* aabb_hi, const float* super_lo,
                               const float* super_hi, const float* sub_lo,
                               const float* sub_hi, float* out, float* visw,
                               int n2, int P, int C, int S, int L, int G,
                               int bsdf, float tmin, cudaStream_t stream) {
    Walk w = {tri, aabb_lo, aabb_hi, super_lo, super_hi, sub_lo, sub_hi,
              C, S, L, G};
    size_t smem;
    cudaError_t err = walk_smem((const void*)shade_trace_kernel, w, &smem);
    if (err != cudaSuccess) return (int)err;
    size_t rays = (size_t)n2 * 2 * (size_t)P;
    if (rays > 0) {
        shade_trace_kernel<<<(unsigned)((rays + 127) / 128), 128, smem,
                             stream>>>(samp, gb, w, visw, n2, P, tmin);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    shade_kernel<<<(P + 127) / 128, 128, 0, stream>>>(samp, gb, visw, out, n2,
                                                      P, bsdf);
    return (int)cudaGetLastError();
}
