// Monte-Carlo sampling: one thread per (stratum, pixel).
//
// Replaces the Pallas kernel _sample_kernel (nvdiffrecmc_tpu/ops/
// pallas_shade.py:354, entry sample_all :367).  The TPU kernel looks the
// light tables up with one-hot matmuls (bf16 operands); here each thread
// inverts the row CDF, then that row's column CDF, by binary search over
// float32 tables, and fetches pdf and radiance texels directly.
//
// What bounds it: each thread reads ~16 table entries at data-dependent
// addresses (binary searches over a 512-entry and a 1024-entry CDF, two pdf
// and six radiance texels) from a 6 MB working set that stays in the 50 MB
// L2, plus 8 uniforms and 8 G-buffer values read and 16 results written
// coalesced along pixels.  It is latency-bound on those dependent loads; the
// BSDF math is a few hundred flops.  Launch: x over pixels, y over strata.
//
// Layouts (pallas_shade.py): u8 [S, 8, P] (u0..u4, cell_l, cell_b, pad);
// gb8 [8, P] (nrm3, wo3, alpha, p_diffuse); rows [Hl]; cols, pdf [Hl, Wl];
// base [Hl, Wl, 3]; out [S, 16, P] (l_dir3, b_dir3, l_pdfsum, b_pdfsum,
// l_rad3, b_rad3, l_tex, b_tex).  The cell ids arrive in u8, so S may be
// all n2 strata (the fused pipeline) or one (the stratum loop).

#include "common.cuh"

// count(cdf <= x) clamped to K-1 (cdf non-decreasing), with that texel's
// pdf and the fractional position inside it.
__device__ __forceinline__ void invert_cdf(const float* __restrict__ cdf,
                                           int K, float x, int* idx,
                                           float* pdf, float* frac) {
    x = fminf(x, ONE_MINUS_EPS_F);
    int lo = 0, hi = K;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (cdf[mid] <= x)
            lo = mid + 1;
        else
            hi = mid;
    }
    int i = min(lo, K - 1);
    float h = cdf[i];
    float l = i > 0 ? cdf[i - 1] : 0.f;
    *idx = i;
    *pdf = h - l;
    *frac = fminf((x - l) / fmaxf(h - l, 1e-12f), ONE_MINUS_EPS_F);
}

__global__ void sample_kernel(const float* __restrict__ u8,
                              const float* __restrict__ gb8,
                              const float* __restrict__ rows,
                              const float* __restrict__ cols,
                              const float* __restrict__ pdf_tex,
                              const float* __restrict__ base,
                              float* __restrict__ out, int n_samples_x, int P,
                              int Hl, int Wl) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    int s = blockIdx.y;
    if (p >= P) return;
    const size_t sP = (size_t)P;
    const float* u = u8 + (size_t)s * 8 * sP + p;
    float u0 = u[0], u1 = u[sP], u2 = u[2 * sP], u3 = u[3 * sP],
          u4 = u[4 * sP], cell_l = u[5 * sP], cell_b = u[6 * sP];
    V3 nrm = mk3(gb8[p], gb8[sP + p], gb8[2 * sP + p]);
    V3 wo = mk3(gb8[3 * sP + p], gb8[4 * sP + p], gb8[5 * sP + p]);
    float alpha = gb8[6 * sP + p];
    float p_diffuse = gb8[7 * sP + p];

    float n = (float)n_samples_x;
    float sx = (cell_l - n * floorf(cell_l / n) + u0) / n;
    float sy = (floorf(cell_l / n) + u1) / n;

    // light importance sample: row CDF, then this row's column CDF
    int y, x;
    float pdf_row, ry, pdf_col, rx;
    invert_cdf(rows, Hl, sy, &y, &pdf_row, &ry);
    invert_cdf(cols + (size_t)y * Wl, Wl, sx, &x, &pdf_col, &rx);
    float uu = ((float)x + rx) / (float)Wl;
    float vv = ((float)y + ry) / (float)Hl;
    V3 l_dir = uv_to_dir(uu, vv);
    float w_solid = (float)(Wl * Hl)
                    / (TWO_PI_SQ_F * fmaxf(sinf(vv * PI_F), 1e-4f));
    float l_pdf = pdf_row * pdf_col * w_solid;
    float l_bsdf_pdf = bsdf_pdf(p_diffuse, nrm, wo, l_dir, alpha);

    // BSDF sample
    float bx = (cell_b - n * floorf(cell_b / n) + u2) / n;
    float by = (floorf(cell_b / n) + u3) / n;
    float b_pdf;
    V3 b_dir = bsdf_sample(p_diffuse, nrm, wo, bx, by, u4, alpha, &b_pdf);

    // light pdf of the BSDF direction: nearest texel
    float ub, vb;
    dir_to_uv(b_dir, &ub, &vb);
    float x2 = fmaxf(fminf(floorf(ub * (float)Wl), (float)(Wl - 1)), 0.f);
    float y2 = fmaxf(fminf(floorf(vb * (float)Hl), (float)(Hl - 1)), 0.f);
    int x2i = (int)x2, y2i = (int)y2;
    float w2 = (float)(Wl * Hl)
               / (TWO_PI_SQ_F * fmaxf(sinf(vb * PI_F), 1e-4f));
    int tl = y * Wl + x, tb = y2i * Wl + x2i;
    float b_light_pdf = pdf_tex[tb] * w2;

    float* o = out + (size_t)s * 16 * sP + p;
    o[0] = l_dir.x;
    o[sP] = l_dir.y;
    o[2 * sP] = l_dir.z;
    o[3 * sP] = b_dir.x;
    o[4 * sP] = b_dir.y;
    o[5 * sP] = b_dir.z;
    o[6 * sP] = l_pdf + l_bsdf_pdf;
    o[7 * sP] = b_light_pdf + b_pdf;
    for (int c = 0; c < 3; ++c) {
        o[(8 + c) * sP] = base[(size_t)tl * 3 + c];
        o[(11 + c) * sP] = base[(size_t)tb * 3 + c];
    }
    o[14 * sP] = (float)tl;
    o[15 * sP] = (float)tb;
}

extern "C" int nvk_sample(const float* u8, const float* gb8, const float* rows,
                          const float* cols, const float* pdf_tex,
                          const float* base, float* out, int n_samples_x,
                          int n_strata, int P, int Hl, int Wl,
                          cudaStream_t stream) {
    dim3 block(256);
    dim3 grid((P + 255) / 256, n_strata);
    sample_kernel<<<grid, block, 0, stream>>>(u8, gb8, rows, cols, pdf_tex,
                                              base, out, n_samples_x, P, Hl,
                                              Wl);
    return (int)cudaGetLastError();
}

extern "C" const char* nvk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
