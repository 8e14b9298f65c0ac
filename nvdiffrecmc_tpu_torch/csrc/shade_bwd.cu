// Shade backward: the adjoint of the per-stratum demodulated shading, no
// tracing; one block per 32 pixels, its warps splitting the strata.
//
// Replaces the Pallas kernel _shade_bwd_kernel (nvdiffrecmc_tpu/ops/
// pallas_shade.py:723, launched from env_shade_fused's bwd :1101).  The TPU
// kernel runs jax.vjp of _shade_stratum inside the kernel; here the adjoint
// of eval_demodulated_c is written out by hand, term by term in reverse.
// Every clamp and max follows JAX's rule at a tie (half the gradient to
// each side): it matters at roughness 0.08, where alpha = clip(r^2, 0.0064,
// 1) sits exactly on its lower bound once the material projection has
// pinned the texel there.
//
// Inputs per pixel: the replayed samples of every stratum (sample.cu; or
// of the strata the launch takes, each weighed sample_frac),
// the G-buffer, the per-ray visibility already lerped by the shadow scale
// (vw = visw * ss + 1 - ss, so the forward's visible/all-visible mix is one
// weight), and the output cotangents g (d_diffuse 3, d_specular 3, zero at
// masked pixels).  Outputs: d(pos, nrm, view, kd, ks) summed over strata,
// and per (stratum, pixel) the radiance cotangents of the light and BSDF
// rays with their texel ids, for the light scatter (light_scatter.cu).
// Masked pixels write zeros.
//
// What bounds it: per pixel and stratum two BSDF evaluations and their
// adjoints (~600 flops, 3 sqrt, 4 rsqrt, 2 pow) against 28 floats read and
// 8 written, coalesced along pixels; at 512^2 and 16 strata that is ~2.5
// GFLOP against ~270 MB, so the bytes bound it.  One thread per pixel
// running all strata in series left the work in the ~28% of threads whose
// pixel is covered, each a serial chain of 2 n2 adjoints: parallelism and
// latency set its time.  Here a block of W warps covers 32 consecutive
// pixels (the lanes, so loads and stores along pixels stay coalesced) and
// warp w takes strata s = w, w + W, ... (any n2); each warp writes drad
// for its own strata, and the W partial sums of the 15 dgb rows meet in
// shared memory, added in warp order: no atomics, the same result in every
// run.  The stratum sum's order differs from the plain version's.  The
// adjoint needs ~130 registers a thread, so a cap of 128 allows 16 warps
// per SM: W = 4 (4 strata a thread at n2 = 16, 4 independent blocks per
// SM) measured faster than 8 or 16.
//
// Layouts: samp [n2, 16, P]; gb [19, P] (ro3, pos3, nrm3, view3, kd3, ks3,
// mask); vw [n2, 2P] (light rays, then BSDF rays); g [6, P]; dgb [15, P]
// (pos3, nrm3, view3, kd3, ks3); drad [n2, 8, P] (d_lrad3, d_brad3,
// tex_l, tex_b).

#include "common.cuh"

#define DGB_ROWS 15
#define WARPS 4  // W above: warps per block

// d max(x, lo) / dx, with half the gradient at a tie (jnp.maximum).
__device__ __forceinline__ float dmax(float x, float lo) {
    return x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
}

// d clip(x, lo, hi) / dx for clip = min(max(x, lo), hi) (jnp.clip).
__device__ __forceinline__ float dclip(float x, float lo, float hi) {
    float m = fmaxf(x, lo);
    float dmin = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
    return dmax(x, lo) * dmin;
}

__device__ __forceinline__ V3 add3(V3 a, V3 b) {
    return mk3(a.x + b.x, a.y + b.y, a.z + b.z);
}

__device__ __forceinline__ V3 scale3(V3 a, float s) {
    return mk3(a.x * s, a.y * s, a.z * s);
}

// Adjoint of normalize3: y = a * rsqrt(max(a.a, 1e-20)); returns dL/da.
__device__ __forceinline__ V3 normalize3_bwd(V3 a, V3 gy) {
    float s = dot3(a, a);
    float inv = rsqrtf(fmaxf(s, 1e-20f));
    float gs = dot3(gy, a) * (-0.5f * inv * inv * inv) * dmax(s, 1e-20f);
    return add3(scale3(gy, inv), scale3(a, 2.f * gs));
}

struct Grads {
    V3 pos, nrm, view, kd, ks;
};

// One ray of one stratum: out_d[c] += dd * rad[c] * wgt and out_s[c] +=
// ss[c] * rad[c] * wgt.  Given their cotangents gd, gsp, writes d_rad and
// adds the gradients of (pos, nrm, view, kd, ks) to acc.
__device__ void demod_bwd(V3 kd, V3 ks, V3 pos, V3 nrm, V3 view, V3 wi,
                          int bsdf, const float gd[3], const float gsp[3],
                          const float rad[3], float wgt, float d_rad[3],
                          Grads* acc) {
    // ---- forward (eval_demodulated_c), keeping the intermediates
    float ndw = dot3(nrm, wi);
    float dd = fmaxf(ndw, 0.f) / PI_F;
    float ss[3] = {0.f, 0.f, 0.f};
    float kdc[3] = {kd.x, kd.y, kd.z};
    float occ = ks.x, rough = ks.y, metal = ks.z;
    V3 a, wo, hv, h;
    float r2, alpha, as, b[3], sc[3], woDotN, wiDotN, woDotH, nDotH, c, d_,
        D, co, c2o, qo, ci, c2i, qi, G, om, fc, wm, w, F[3];
    bool front = false;
    if (bsdf == 0) {
        a = mk3(view.x - pos.x, view.y - pos.y, view.z - pos.z);
        wo = normalize3(a);
        r2 = rough * rough;
        alpha = fminf(fmaxf(r2, MIN_ROUGHNESS_SQ), 1.f);
        as = alpha * alpha;
        for (int k = 0; k < 3; ++k) {
            b[k] = 0.04f * (1.f - metal) + kdc[k] * metal;
            sc[k] = b[k] * (1.f - occ);
        }
        hv = mk3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z);
        h = normalize3(hv);
        woDotN = dot3(wo, nrm);
        wiDotN = dot3(wi, nrm);
        woDotH = dot3(wo, h);
        nDotH = dot3(nrm, h);
        c = clip01(nDotH);
        d_ = (c * as - c) * c + 1.f;
        D = as / (d_ * d_ * PI_F);
        co = clip01(woDotN);
        c2o = co * co;
        qo = 1.f + as * (1.f - c2o) / c2o;
        ci = clip01(wiDotN);
        c2i = ci * ci;
        qi = 1.f + as * (1.f - c2i) / c2i;
        G = 1.f / (1.f + 0.5f * (sqrtf(qo) - 1.f) + 0.5f * (sqrtf(qi) - 1.f));
        om = 1.f - clip01(woDotH);
        fc = powf(om, 5.f);
        wm = fmaxf(woDotN, SPECULAR_EPSILON);
        w = D * G * 0.25f / wm;
        front = woDotN > SPECULAR_EPSILON && wiDotN > SPECULAR_EPSILON;
        for (int k = 0; k < 3; ++k) {
            F[k] = sc[k] + (1.f - sc[k]) * fc;
            ss[k] = front ? F[k] * w : 0.f;
        }
    }

    // ---- the stratum sum
    float gdd = 0.f, gss[3];
    for (int k = 0; k < 3; ++k) {
        gdd = gdd + gd[k] * (rad[k] * wgt);
        gss[k] = gsp[k] * (rad[k] * wgt);
        d_rad[k] = (gd[k] * dd + gsp[k] * ss[k]) * wgt;
    }

    // ---- diffuse
    acc->nrm = add3(acc->nrm, scale3(wi, gdd / PI_F * dmax(ndw, 0.f)));
    if (bsdf != 0 || !front) return;

    // ---- specular: ss[k] = F[k] * w
    float g_w = 0.f, g_fc = 0.f, g_sc[3];
    for (int k = 0; k < 3; ++k) {
        float g_F = gss[k] * w;
        g_w = g_w + gss[k] * F[k];
        g_sc[k] = g_F * (1.f - fc);
        g_fc = g_fc + g_F * (1.f - sc[k]);
    }
    // w = D * G * 0.25 / wm
    float g_D = g_w * G * 0.25f / wm;
    float g_G = g_w * D * 0.25f / wm;
    float g_woDotN = -g_w * w / wm * dmax(woDotN, SPECULAR_EPSILON);
    // fc = (1 - clip01(woDotH))^5
    float g_woDotH = -(g_fc * 5.f * om * om * om * om)
                     * dclip(woDotH, SPECULAR_EPSILON, 1.f - SPECULAR_EPSILON);
    // G = 1 / (1 + lam_o + lam_i); lam = 0.5 (sqrt(q) - 1),
    // q = 1 + as (1 - c^2) / c^2, c = clip01(ct)
    float g_lam = -g_G * G * G;
    float g_as = 0.f;
    float g_q = g_lam * 0.25f / sqrtf(qo);
    g_as = g_as + g_q * (1.f - c2o) / c2o;
    g_woDotN = g_woDotN + g_q * as * (-1.f / (c2o * c2o)) * 2.f * co
               * dclip(woDotN, SPECULAR_EPSILON, 1.f - SPECULAR_EPSILON);
    g_q = g_lam * 0.25f / sqrtf(qi);
    g_as = g_as + g_q * (1.f - c2i) / c2i;
    float g_wiDotN = g_q * as * (-1.f / (c2i * c2i)) * 2.f * ci
                     * dclip(wiDotN, SPECULAR_EPSILON,
                             1.f - SPECULAR_EPSILON);
    // D = as / (d_^2 pi), d_ = (c as - c) c + 1, c = clip01(nDotH)
    g_as = g_as + g_D / (d_ * d_ * PI_F);
    float g_d = -2.f * g_D * D / d_;
    g_as = g_as + g_d * c * c;
    float g_nDotH = g_d * 2.f * c * (as - 1.f)
                    * dclip(nDotH, SPECULAR_EPSILON, 1.f - SPECULAR_EPSILON);
    // as = alpha^2, alpha = clip(rough^2, 0.0064, 1)
    float g_rough = g_as * 2.f * alpha * dclip(r2, MIN_ROUGHNESS_SQ, 1.f)
                    * 2.f * rough;
    // sc = (0.04 (1 - metal) + kd metal) (1 - occ)
    float g_occ = 0.f, g_metal = 0.f, g_kd[3];
    for (int k = 0; k < 3; ++k) {
        float g_b = g_sc[k] * (1.f - occ);
        g_occ = g_occ - g_sc[k] * b[k];
        g_metal = g_metal + g_b * (kdc[k] - 0.04f);
        g_kd[k] = g_b * metal;
    }
    acc->kd = add3(acc->kd, mk3(g_kd[0], g_kd[1], g_kd[2]));
    acc->ks = add3(acc->ks, mk3(g_occ, g_rough, g_metal));
    // the dot products
    V3 g_wo = add3(scale3(nrm, g_woDotN), scale3(h, g_woDotH));
    acc->nrm = add3(acc->nrm, add3(add3(scale3(wo, g_woDotN),
                                        scale3(wi, g_wiDotN)),
                                   scale3(h, g_nDotH)));
    V3 g_h = add3(scale3(wo, g_woDotH), scale3(nrm, g_nDotH));
    // h = normalize(wo + wi), wo = normalize(view - pos)
    g_wo = add3(g_wo, normalize3_bwd(hv, g_h));
    V3 g_a = normalize3_bwd(a, g_wo);
    acc->view = add3(acc->view, g_a);
    acc->pos = add3(acc->pos, scale3(g_a, -1.f));
}

// 16 / WARPS blocks of WARPS warps per SM: at most 128 registers a thread
__global__ void __launch_bounds__(32 * WARPS, 16 / WARPS)
shade_bwd_kernel(const float* __restrict__ samp, const float* __restrict__ gb,
                 const float* __restrict__ vw, const float* __restrict__ g,
                 float* __restrict__ dgb, float* __restrict__ drad, int n2,
                 int P, int bsdf, float sample_frac) {
    __shared__ float s_red[WARPS * DGB_ROWS * 32];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int p = blockIdx.x * 32 + lane;
    const size_t sP = (size_t)P;
    Grads acc;
    acc.pos = acc.nrm = acc.view = acc.kd = acc.ks = mk3(0.f, 0.f, 0.f);
    if (p < P) {
        const bool covered = gb[18 * sP + p] > 0.f;
        V3 pos = mk3(0.f, 0.f, 0.f), nrm = pos, view = pos, kd = pos,
           ks = pos;
        float gd[3] = {0.f, 0.f, 0.f}, gsp[3] = {0.f, 0.f, 0.f};
        if (covered) {
            pos = mk3(gb[3 * sP + p], gb[4 * sP + p], gb[5 * sP + p]);
            nrm = mk3(gb[6 * sP + p], gb[7 * sP + p], gb[8 * sP + p]);
            view = mk3(gb[9 * sP + p], gb[10 * sP + p], gb[11 * sP + p]);
            kd = mk3(gb[12 * sP + p], gb[13 * sP + p], gb[14 * sP + p]);
            ks = mk3(gb[15 * sP + p], gb[16 * sP + p], gb[17 * sP + p]);
            for (int k = 0; k < 3; ++k) {
                gd[k] = g[k * sP + p];
                gsp[k] = g[(3 + k) * sP + p];
            }
        }
        for (int s = w; s < n2; s += WARPS) {
            const float* sp = samp + (size_t)s * 16 * sP + p;
            float* dr = drad + (size_t)s * 8 * sP + p;
            dr[6 * sP] = sp[14 * sP];
            dr[7 * sP] = sp[15 * sP];
            if (!covered) {
                for (int k = 0; k < 6; ++k) dr[k * sP] = 0.f;
                continue;
            }
            V3 l_dir = mk3(sp[0], sp[sP], sp[2 * sP]);
            V3 b_dir = mk3(sp[3 * sP], sp[4 * sP], sp[5 * sP]);
            float l_mis = 1.f / fmaxf(sp[6 * sP], 1e-4f);
            float b_mis = 1.f / fmaxf(sp[7 * sP], 1e-4f);
            float l_rad[3] = {sp[8 * sP], sp[9 * sP], sp[10 * sP]};
            float b_rad[3] = {sp[11 * sP], sp[12 * sP], sp[13 * sP]};
            float wl = vw[(size_t)s * 2 * sP + p] * l_mis * sample_frac;
            float wb = vw[(size_t)s * 2 * sP + sP + p] * b_mis * sample_frac;
            float drl[3], drb[3];
            demod_bwd(kd, ks, pos, nrm, view, l_dir, bsdf, gd, gsp, l_rad, wl,
                      drl, &acc);
            demod_bwd(kd, ks, pos, nrm, view, b_dir, bsdf, gd, gsp, b_rad, wb,
                      drb, &acc);
            for (int k = 0; k < 3; ++k) {
                dr[k * sP] = drl[k];
                dr[(3 + k) * sP] = drb[k];
            }
        }
    }
    // the partial sums of each pixel's 15 dgb rows, added in warp order
    const V3 rows[5] = {acc.pos, acc.nrm, acc.view, acc.kd, acc.ks};
    float* red = s_red + w * DGB_ROWS * 32 + lane;
    for (int r = 0; r < 5; ++r) {
        red[(3 * r) * 32] = rows[r].x;
        red[(3 * r + 1) * 32] = rows[r].y;
        red[(3 * r + 2) * 32] = rows[r].z;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < DGB_ROWS * 32; o += 32 * WARPS) {
        const int q = blockIdx.x * 32 + (o & 31);
        if (q >= P) continue;
        float sum = s_red[o];
        for (int k = 1; k < WARPS; ++k)
            sum = sum + s_red[k * DGB_ROWS * 32 + o];
        dgb[(size_t)(o >> 5) * sP + q] = sum;
    }
}

// Returns the error of a refused launch.
// sample_frac: the weight of one stratum in the whole estimator, 1 / n2 of
// all its strata, so that a launch on some of them (the stratum loop's
// backward, one at a time) weighs them as the launch on all of them does.
extern "C" int nvk_shade_bwd(const float* samp, const float* gb,
                             const float* vw, const float* g, float* dgb,
                             float* drad, int n2, int P, int bsdf,
                             float sample_frac, cudaStream_t stream) {
    if (P == 0) return 0;
    shade_bwd_kernel<<<(P + 31) / 32, 32 * WARPS, 0, stream>>>(
        samp, gb, vw, g, dgb, drad, n2, P, bsdf, sample_frac);
    return (int)cudaGetLastError();
}

// info: registers per thread, local (spill) bytes per thread, blocks per
// SM and shared bytes per block of shade_bwd_kernel.
extern "C" int nvk_shade_bwd_info(int* info) {
    cudaFuncAttributes a;
    int per_sm = 0;
    cudaError_t err = cudaFuncGetAttributes(&a, shade_bwd_kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, shade_bwd_kernel, 32 * WARPS, 0);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    info[2] = per_sm;
    info[3] = (int)a.sharedSizeBytes;
    return 0;
}
