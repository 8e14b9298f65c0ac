// Monte-Carlo sampling: persistent blocks over (stratum, pixel) items; each
// CDF inversion starts from a guide table, so it takes one or two search
// steps where a binary search over the whole row took ten or eleven.
//
// Replaces the Pallas kernel _sample_kernel (nvdiffrecmc_tpu/ops/
// pallas_shade.py:354, entry sample_all :367).  The TPU kernel looks the
// light tables up with one-hot matmuls (bf16 operands); here each item
// inverts the row CDF, then that row's column CDF, over float32 tables, and
// fetches pdf and radiance texels directly.
//
// What bounds it: the bytes are 8 uniforms and 8 G-buffer values read and
// 16 results written per item, coalesced along pixels (the bound); the BSDF
// math is a few hundred flops.  One thread per item with two binary
// searches over global memory made ~25 dependent loads per item (~21 of
// them in the searches): load latency sets its time.  Keeping the searches'
// top levels in shared memory (the row CDF and every 32nd column-CDF entry,
// 66 KB a block) measured slower than that: 3 blocks per SM, and the L1
// cache squeezed to the rest.  This design shortens the chains instead:
//
// - guide_kernel builds a guide table per CDF (the row CDF and each row's
//   column CDF), one block each: g[b] = the number of entries in buckets
//   below b, the bucket of v being floor(v K) of K (clamped), by an
//   integer histogram in shared memory and its scan.  Integers: the same
//   tables in every run.  The tables depend on the light alone, so the
//   caller builds them once per light (nvk_sample_guide) and passes them
//   to every sampler launch that reads that light.
// - sample_kernel: SAMPLE_BLOCKS_PER_SM blocks per SM, as many as fit by
//   registers, each staging the row CDF and its guide (8 Hl bytes) into
//   shared memory once and walking (stratum, pixel-tile) tiles with a grid
//   stride.  A draw x in bucket b has count(cdf <= x) in [g[b], g[b + 1]]
//   when the CDF is non-decreasing (entries in lower buckets are below x,
//   in higher ones above it), so the binary search of the plain version
//   over that range (about one entry on these lights) finds the same
//   index: idx, pdf and frac keep their bits.  The column guide pair is
//   one load from global memory, its entry a second.
//
// Layouts (pallas_shade.py): u8 [S, 8, P] (u0..u4, cell_l, cell_b, pad);
// gb8 [8, P] (nrm3, wo3, alpha, p_diffuse); rows [Hl]; cols, pdf [Hl, Wl];
// base [Hl, Wl, 3]; out [S, 16, P] (l_dir3, b_dir3, l_pdfsum, b_pdfsum,
// l_rad3, b_rad3, l_tex, b_tex); guide (int) [Hl (Wl + 1) + Hl + 1]:
// each row's column guide, then the row guide.  Both kernels take their
// shared memory (max(Hl, Wl) ints, 2 Hl + 1 words) within the 48 KB a
// block has without opting in; the wrapper refuses larger lights.  The
// cell ids arrive in u8, so S may be all n2 strata (the fused pipeline) or
// one (the stratum loop).

#include "common.cuh"

#define SAMPLE_THREADS 256
#define GUIDE_THREADS 256
#define SAMPLE_BLOCKS_PER_SM 4   // 256 threads of ~55 registers

// The guide bucket of v in [0, 1] among K.
__device__ __forceinline__ int bucket(float v, int K) {
    int b = (int)floorf(v * (float)K);
    return min(max(b, 0), K - 1);
}

// count(cdf <= x) clamped to K-1 (cdf non-decreasing), with that texel's
// pdf and the fractional position inside it: the binary search of the
// plain version over the range [g[b], g[b + 1]] of x's bucket b.
__device__ __forceinline__ void invert_cdf(const float* cdf, const int* g,
                                           int K, float x, int* idx,
                                           float* pdf, float* frac) {
    x = fminf(x, ONE_MINUS_EPS_F);
    int b = bucket(x, K);
    int lo = g[b], hi = g[b + 1];
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

// Block y < Hl: the guide of column CDF y (K = Wl) into guide + y (Wl + 1);
// block Hl: the row CDF's (K = Hl) into guide + Hl (Wl + 1).  Dynamic
// shared memory: max(Hl, Wl) ints.
__global__ void __launch_bounds__(GUIDE_THREADS)
guide_kernel(const float* __restrict__ rows, const float* __restrict__ cols,
             int* __restrict__ guide, int Hl, int Wl) {
    extern __shared__ int s_hist[];
    __shared__ int s_warp[GUIDE_THREADS / 32];
    const bool is_rows = blockIdx.x == Hl;
    const int K = is_rows ? Hl : Wl;
    const float* cdf = is_rows ? rows : cols + (size_t)blockIdx.x * Wl;
    int* g = guide + (size_t)blockIdx.x * (Wl + 1);
    const int t = threadIdx.x;
    for (int i = t; i < K; i += GUIDE_THREADS) s_hist[i] = 0;
    __syncthreads();
    for (int i = t; i < K; i += GUIDE_THREADS)
        atomicAdd(&s_hist[bucket(__ldg(cdf + i), K)], 1);
    __syncthreads();
    // exclusive scan: thread t owns buckets [t C, t C + C)
    const int C = (K + GUIDE_THREADS - 1) / GUIDE_THREADS;
    const int b0 = min(t * C, K), b1 = min(b0 + C, K);
    int own = 0;
    for (int b = b0; b < b1; ++b) own += s_hist[b];
    int incl = own;
    const int lane = t & 31;
    for (int d = 1; d < 32; d <<= 1) {
        int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[t >> 5] = incl;
    __syncthreads();
    int run = incl - own;
    for (int w = 0; w < (t >> 5); ++w) run += s_warp[w];
    for (int b = b0; b < b1; ++b) {
        g[b] = run;
        run += s_hist[b];
    }
    if (t == 0) g[K] = K;
}

__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_kernel(const float* __restrict__ u8, const float* __restrict__ gb8,
              const float* __restrict__ rows,
              const float* __restrict__ cols,
              const int* __restrict__ guide,
              const float* __restrict__ pdf_tex,
              const float* __restrict__ base, float* __restrict__ out,
              int n_samples_x, int S, int P, int Hl, int Wl) {
    extern __shared__ float s_rows[];          // [Hl], then int [Hl + 1]
    int* s_rg = reinterpret_cast<int*>(s_rows + Hl);
    const int* rg = guide + (size_t)Hl * (Wl + 1);
    for (int i = threadIdx.x; i < Hl; i += blockDim.x)
        s_rows[i] = __ldg(rows + i);
    for (int i = threadIdx.x; i <= Hl; i += blockDim.x)
        s_rg[i] = __ldg(rg + i);
    __syncthreads();

    const size_t sP = (size_t)P;
    const int n_tiles = (P + SAMPLE_THREADS - 1) / SAMPLE_THREADS;
    const float n = (float)n_samples_x;
    for (int tile = blockIdx.x; tile < S * n_tiles; tile += gridDim.x) {
        const int s = tile / n_tiles;
        const int p = (tile - s * n_tiles) * SAMPLE_THREADS + threadIdx.x;
        if (p >= P) continue;
        const float* u = u8 + (size_t)s * 8 * sP + p;
        float u0 = u[0], u1 = u[sP], u2 = u[2 * sP], u3 = u[3 * sP],
              u4 = u[4 * sP], cell_l = u[5 * sP], cell_b = u[6 * sP];
        V3 nrm = mk3(gb8[p], gb8[sP + p], gb8[2 * sP + p]);
        V3 wo = mk3(gb8[3 * sP + p], gb8[4 * sP + p], gb8[5 * sP + p]);
        float alpha = gb8[6 * sP + p];
        float p_diffuse = gb8[7 * sP + p];

        float sx = (cell_l - n * floorf(cell_l / n) + u0) / n;
        float sy = (floorf(cell_l / n) + u1) / n;

        // light importance sample: row CDF, then this row's column CDF
        int y, x;
        float pdf_row, ry, pdf_col, rx;
        invert_cdf(s_rows, s_rg, Hl, sy, &y, &pdf_row, &ry);
        invert_cdf(cols + (size_t)y * Wl, guide + (size_t)y * (Wl + 1), Wl,
                   sx, &x, &pdf_col, &rx);
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
        float b_light_pdf = __ldg(pdf_tex + tb) * w2;

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
            o[(8 + c) * sP] = __ldg(base + (size_t)tl * 3 + c);
            o[(11 + c) * sP] = __ldg(base + (size_t)tb * 3 + c);
        }
        o[14 * sP] = (float)tl;
        o[15 * sP] = (float)tb;
    }
}

static int sample_smem(int Hl) { return (2 * Hl + 1) * (int)sizeof(float); }

// The guide tables of a light (layout above).  Returns the error of a
// refused launch.
extern "C" int nvk_sample_guide(const float* rows, const float* cols,
                                int* guide, int Hl, int Wl,
                                cudaStream_t stream) {
    const int smem = (Hl > Wl ? Hl : Wl) * (int)sizeof(int);
    guide_kernel<<<Hl + 1, GUIDE_THREADS, smem, stream>>>(rows, cols, guide,
                                                          Hl, Wl);
    return (int)cudaGetLastError();
}

// guide: the light's tables from nvk_sample_guide; sms: the card's SMs.
// Returns the error of a refused launch.
extern "C" int nvk_sample(const float* u8, const float* gb8, const float* rows,
                          const float* cols, const int* guide,
                          const float* pdf_tex, const float* base, float* out,
                          int n_samples_x, int n_strata, int P, int Hl,
                          int Wl, int sms, cudaStream_t stream) {
    if (n_strata * P == 0) return 0;
    const int tiles =
        n_strata * ((P + SAMPLE_THREADS - 1) / SAMPLE_THREADS);
    const int grid = tiles < SAMPLE_BLOCKS_PER_SM * sms
                         ? tiles : SAMPLE_BLOCKS_PER_SM * sms;
    sample_kernel<<<grid, SAMPLE_THREADS, sample_smem(Hl), stream>>>(
        u8, gb8, rows, cols, guide, pdf_tex, base, out, n_samples_x, n_strata,
        P, Hl, Wl);
    return (int)cudaGetLastError();
}

// info: registers per thread, local (spill) bytes per thread, blocks per
// SM and shared bytes per block of sample_kernel for a light of Hl rows.
extern "C" int nvk_sample_info(int Hl, int* info) {
    cudaFuncAttributes a;
    int per_sm = 0;
    cudaError_t err = cudaFuncGetAttributes(&a, sample_kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, sample_kernel, SAMPLE_THREADS, sample_smem(Hl));
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    info[0] = a.numRegs;
    info[1] = (int)a.localSizeBytes;
    info[2] = per_sm;
    info[3] = sample_smem(Hl);
    return 0;
}

extern "C" const char* nvk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
