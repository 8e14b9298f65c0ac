// Shadow-ray tracing + demodulated shading, forward: one thread per pixel.
//
// Replaces the Pallas kernel _shade_fwd_kernel (nvdiffrecmc_tpu/ops/
// pallas_shade.py:568, launched from env_shade_fused :895) together with
// the pass that builds its per-block leaf visit lists (_build_lists :859).
// The TPU kernel tests whole ray blocks against the union of their leaves
// with Plücker matmuls; here every ray walks the two-level BVH on its own:
// supernode box, leaf box, then the leaf's triangles, stopping at the first
// hit.  The triangle test is the Plücker any-hit of ops/bvh.py in the same
// arithmetic order as the plain version (ops/tracer.py), so both give the
// same bits.
//
// Per pixel and stratum s = 0..n2-1 (the JAX accumulation order): trace the
// light ray, then the BSDF ray, from ro; write their visibility to visw;
// evaluate the demodulated BSDF for both directions; accumulate diffuse and
// specular twice, with visibility and with everything visible.  Masked
// pixels write zeros (and visibility 1) without tracing.
//
// What bounds it: the BVH walk.  Each ray tests ~26 supernode boxes, the
// leaf boxes of the supernodes it enters and 128 triangles per leaf it
// enters (22 floats each, from a 2.5 MB triangle table that stays in L2);
// threads of a warp diverge across leaves.  It is bound by L1/L2 load
// throughput and warp divergence, not by DRAM.
//
// Layouts: samp [n2, 16, P] (sample.cu); gb [19, P] (ro3, pos3, nrm3,
// view3, kd3, ks3, mask); tri [C*L, 24] (bvh.py); aabb_lo/hi [C, 3];
// super_lo/hi [S, 3]; out [12, P] (diff3|spec3 visible, diff3|spec3 all
// visible); visw [n2, 2P] (light rays, then BSDF rays).

#include "common.cuh"

#define SUPER 8

__device__ __forceinline__ bool slab(V3 o, V3 inv, const float* __restrict__ lo,
                                     const float* __restrict__ hi, float tmin) {
    float tn = tmin, tf = __int_as_float(0x7f800000);  // +inf
    float t0 = (lo[0] - o.x) * inv.x, t1 = (hi[0] - o.x) * inv.x;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (lo[1] - o.y) * inv.y;
    t1 = (hi[1] - o.y) * inv.y;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (lo[2] - o.z) * inv.z;
    t1 = (hi[2] - o.z) * inv.z;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    return tf >= tn;
}

// Plücker any-hit against one triangle row (bvh.py layout).
__device__ __forceinline__ bool tri_hit(const float* __restrict__ r, V3 o,
                                        V3 d, V3 m, float tmin) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
    float4 a = __ldg(r4 + 0), b = __ldg(r4 + 1), c = __ldg(r4 + 2),
           e = __ldg(r4 + 3), f = __ldg(r4 + 4), g = __ldg(r4 + 5);
    // a: V0x V0y V0z U0x | b: U0y U0z V1x V1y | c: V1z U1x U1y U1z
    // e: V2x V2y V2z U2x | f: U2y U2z nx ny   | g: nz np0 0 0
    float e0 = d.x * a.x + d.y * a.y + d.z * a.z + m.x * a.w + m.y * b.x
               + m.z * b.y;
    float e1 = d.x * b.z + d.y * b.w + d.z * c.x + m.x * c.y + m.y * c.z
               + m.z * c.w;
    float e2 = d.x * e.x + d.y * e.y + d.z * e.z + m.x * e.w + m.y * f.x
               + m.z * f.y;
    float num = g.y - (o.x * f.z + o.y * f.w + o.z * g.x);
    float den = d.x * f.z + d.y * f.w + d.z * g.x;
    num = num - tmin * den;
    bool same = (e0 * e1 >= 0.f) && (e1 * e2 >= 0.f) && (e0 * e2 >= 0.f);
    return same && (num * den > 0.f);
}

__device__ bool any_hit(V3 o, V3 d, const float* __restrict__ tri,
                        const float* __restrict__ alo,
                        const float* __restrict__ ahi,
                        const float* __restrict__ slo,
                        const float* __restrict__ shi, int C, int S, int L,
                        float tmin) {
    V3 inv = mk3(1.f / d.x, 1.f / d.y, 1.f / d.z);
    V3 m = cross3(o, d);
    for (int sn = 0; sn < S; ++sn) {
        if (!slab(o, inv, slo + 3 * sn, shi + 3 * sn, tmin)) continue;
        int c_end = min(sn * SUPER + SUPER, C);
        for (int c = sn * SUPER; c < c_end; ++c) {
            const float* lo = alo + 3 * c;
            const float* hi = ahi + 3 * c;
            if (!(lo[0] <= hi[0])) continue;  // empty leaf
            if (!slab(o, inv, lo, hi, tmin)) continue;
            const float* rows = tri + (size_t)c * L * 24;
            for (int t = 0; t < L; ++t)
                if (tri_hit(rows + t * 24, o, d, m, tmin)) return true;
        }
    }
    return false;
}

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

__global__ void trace_shade_kernel(const float* __restrict__ samp,
                                   const float* __restrict__ gb,
                                   const float* __restrict__ tri,
                                   const float* __restrict__ alo,
                                   const float* __restrict__ ahi,
                                   const float* __restrict__ slo,
                                   const float* __restrict__ shi,
                                   float* __restrict__ out,
                                   float* __restrict__ visw, int n2, int P,
                                   int C, int S, int L, int bsdf, float tmin) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const size_t sP = (size_t)P;
    if (!(gb[18 * sP + p] > 0.f)) {
        for (int k = 0; k < 12; ++k) out[k * sP + p] = 0.f;
        for (int s = 0; s < n2; ++s) {
            visw[(size_t)s * 2 * sP + p] = 1.f;
            visw[(size_t)s * 2 * sP + sP + p] = 1.f;
        }
        return;
    }
    V3 ro = mk3(gb[p], gb[sP + p], gb[2 * sP + p]);
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

        bool occ_l = any_hit(ro, l_dir, tri, alo, ahi, slo, shi, C, S, L, tmin);
        bool occ_b = any_hit(ro, b_dir, tri, alo, ahi, slo, shi, C, S, L, tmin);
        float vis_l = occ_l ? 0.f : 1.f;
        float vis_b = occ_b ? 0.f : 1.f;
        visw[(size_t)s * 2 * sP + p] = vis_l;
        visw[(size_t)s * 2 * sP + sP + p] = vis_b;

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
                               const float* super_hi, float* out, float* visw,
                               int n2, int P, int C, int S, int L, int bsdf,
                               float tmin, cudaStream_t stream) {
    dim3 block(128);
    dim3 grid((P + 127) / 128);
    trace_shade_kernel<<<grid, block, 0, stream>>>(
        samp, gb, tri, aabb_lo, aabb_hi, super_lo, super_hi, out, visw, n2, P,
        C, S, L, bsdf, tmin);
    return (int)cudaGetLastError();
}
