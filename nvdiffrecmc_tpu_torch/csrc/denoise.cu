// Cross-bilateral denoiser, forward and grad mode, for a pair of color
// buffers that share their guide planes (C = 6 channels) or for one (C =
// 3): one block per 32 x 8 output tile, its tap window staged in shared
// memory.
//
// The pair instance replaces the Pallas kernel _denoise_kernel
// (nvdiffrecmc_tpu/ops/pallas_denoise.py:47, both modes; entries
// bilateral_denoiser_pair :215 and the backward _premul_pair_bwd :193).
// The one-buffer instance replaces no TPU kernel: the JAX package denoises
// the modulated color (denoiser_demodulate false) in jnp
// (nvdiffrecmc_tpu/ops/denoiser.py:94-118, _taps under a custom_vjp); it
// is the same filter on 3 channels.
// The TPU kernel DMAs a row window of all planes into VMEM and unrolls the
// tap columns; here a block of 32 x 8 threads copies the (32 + 22) x
// (8 + 22) window of the planes its taps read into shared memory, NP
// floats per pixel (z, the normal's three components, the C colours and
// dz).  Each thread then walks the taps of its pixel in row-major order
// (ky, then kx), as ops/denoiser._taps does.
//
// Weight of a tap: exp(-d^2 / (2 sigma^2)) (zero beyond the dynamic radius
// 2*ceil(2.5 sigma)+1) * clamp(n_tap . n_center, 1e-4, 1)^128 *
// exp(-|z_tap - z_center| / max(dz_center * d, 1e-4)) * valid.  The
// spatial weight and d depend on the tap alone: the block tabulates them
// once per (|fx|, |fy|) with the expf and sqrtf of the tap loop, and the
// loop skips the taps beyond the dynamic radius, whose weight is zero.
// x^128 is 7 squarings, as the TPU kernel takes it.  Window pixels outside
// the image are staged as zeros: their normal weight (1e-4)^128 is exactly
// 0, so every lane of a warp walks the same (2r+1)^2 taps and an
// out-of-image tap adds exactly 0, as the plain version's skipped tap.
// (Per-lane tap bounds over unwritten slots gave wrong, run-dependent
// sums at a ragged right edge on the H100; the zeroed slots cure it.)
// Output: C premultiplied channels and the weight sum; the division by
// max(w, 1e-4) stays in PyTorch.
//
// Grad mode (the backward): col holds the output gradient, and the depth
// denominator takes the tap's dz instead of the center's, which makes the
// weights those of the transposed filter (the reference's
// denoising.cu:114-118); the weight sum is then meaningless.
//
// What bounds it: per (pixel, tap) ~10 shared-memory loads and ~30-40
// float instructions, of them an ex2 and a reciprocal in the
// special-function units (the exp and the division of the depth weight);
// 529 taps per pixel at sigma 2.  DRAM is not the limit: the planes are
// 12 MB at 512x512 and each block reads its window once.
//
// Layouts: col [N, H, W, C]; nrm [N, H, W, 3]; zdz [N, H, W, 2] (z, dz);
// out [N, H, W, C + 1].

#include "common.cuh"

#define R 11
#define NTAB (R + 1)          // tabulated |fx|, |fy|: 0..R
#define TW 32                 // tile width = blockDim.x
#define TH 8                  // tile height = blockDim.y
#define WW (TW + 2 * R)       // window width
#define WH (TH + 2 * R)       // window height
#define FLT_EPS_D 1e-4f

// Floats per window pixel in shared memory: z, the normal (3), the C
// colours and dz (read in grad mode), padded to an odd count (11 for the
// pair, 9 for one buffer), so the 32 lanes of a warp reading 32
// neighbouring pixels hit 32 banks.
template <int C>
struct Planes {
    static constexpr int NP = (C + 5) | 1;
    static constexpr int Q_Z = 0, Q_N = 1, Q_C = 4, Q_DZ = 4 + C;
    // the tap table and the window: 72,432 bytes (pair) or 59,472 (one
    // buffer), above the default 48 KB
    static constexpr size_t SMEM_BYTES =
        NTAB * NTAB * sizeof(float2) + WW * WH * NP * sizeof(float);
    static_assert(SMEM_BYTES <= 227 * 1024,
                  "the tap window must fit in a block's shared memory");
    static_assert(Q_DZ < NP, "the planes must fit in NP floats");
};

template <int C>
__global__ void denoise_kernel(const float* __restrict__ col,
                               const float* __restrict__ nrm,
                               const float* __restrict__ zdz,
                               float* __restrict__ out, int H, int W,
                               float sigma, int grad_mode) {
    using Q = Planes<C>;
    constexpr int NP = Q::NP;
    extern __shared__ float2 smem[];
    float2* s_tab = smem;                         // (w_xy, d) [NTAB][NTAB]
    float* s_win = (float*)(smem + NTAB * NTAB);  // [WH][WW][NP]
    const int n_win = WW * WH;
    const int n = blockIdx.z;
    const int gx0 = blockIdx.x * TW - R, gy0 = blockIdx.y * TH - R;
    const int tid = threadIdx.y * TW + threadIdx.x;
    const int nthreads = TW * TH;
    const size_t base = (size_t)n * H * W;

    const float variance = sigma * sigma;
    const float dyn_rad = 2.f * ceilf(sigma * 2.5f) + 1.f;
    for (int i = tid; i < NTAB * NTAB; i += nthreads) {
        int ay = i / NTAB, ax = i % NTAB;
        float dist_sqr = (float)(ax * ax + ay * ay);
        float w_xy = expf(-dist_sqr / (2.f * variance));
        if ((float)ax > dyn_rad || (float)ay > dyn_rad) w_xy = 0.f;
        s_tab[i] = make_float2(w_xy, sqrtf(dist_sqr));
    }
    for (int i = tid; i < n_win; i += nthreads) {
        int gy = gy0 + i / WW, gx = gx0 + i % WW;
        float* d = s_win + i * NP;
        if (gx < 0 || gx >= W || gy < 0 || gy >= H) {
            for (int q = 0; q < NP; ++q) d[q] = 0.f;      // weight 0
            continue;
        }
        size_t p = base + (size_t)gy * W + gx;
        d[Q::Q_Z] = zdz[p * 2];
        for (int c = 0; c < 3; ++c) d[Q::Q_N + c] = nrm[p * 3 + c];
        for (int c = 0; c < C; ++c) d[Q::Q_C + c] = col[p * C + c];
        d[Q::Q_DZ] = zdz[p * 2 + 1];
    }
    __syncthreads();

    // taps with |fx| or |fy| beyond the dynamic radius weigh exactly 0
    const int r = dyn_rad < (float)R ? (int)dyn_rad : R;
    const int x = blockIdx.x * TW + threadIdx.x;
    const int y = blockIdx.y * TH + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t pc = base + (size_t)y * W + x;
    const float cn0 = nrm[pc * 3], cn1 = nrm[pc * 3 + 1],
                cn2 = nrm[pc * 3 + 2];
    const float cz = zdz[pc * 2], cdz = zdz[pc * 2 + 1];
    float acc[C];
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    float accw = 0.f;
    for (int fy = -r; fy <= r; ++fy) {
        const float* row =
            s_win + ((threadIdx.y + R + fy) * WW + threadIdx.x + R) * NP;
        const float2* tab = s_tab + abs(fy) * NTAB;
        for (int fx = -r; fx <= r; ++fx) {
            const float* q = row + fx * NP;
            const float2 t = tab[abs(fx)];       // (w_xy, dist)
            float ndot = q[Q::Q_N] * cn0 + q[Q::Q_N + 1] * cn1
                         + q[Q::Q_N + 2] * cn2;
            float w_normal = fminf(fmaxf(ndot, FLT_EPS_D), 1.f);
            for (int i = 0; i < 7; ++i) w_normal = w_normal * w_normal;
            float dz = grad_mode ? q[Q::Q_DZ] : cdz;
            float denom = fmaxf(dz * t.y, FLT_EPS_D);
            float w_depth = expf(-fabsf(q[Q::Q_Z] - cz) / denom);
            float w = t.x * w_normal * w_depth;
            for (int c = 0; c < C; ++c)
                acc[c] = acc[c] + q[Q::Q_C + c] * w;
            accw = accw + w;
        }
    }
    float* o = out + pc * (C + 1);
    for (int c = 0; c < C; ++c) o[c] = acc[c];
    o[C] = accw;
}

// Returns the error of a refused launch (or of the shared-memory
// attribute).
template <int C>
static int launch_denoise(const float* col, const float* nrm,
                          const float* zdz, float* out, int N, int H, int W,
                          float sigma, int grad_mode, cudaStream_t stream) {
    const int smem = (int)Planes<C>::SMEM_BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        denoise_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {
        cudaGetLastError();  // not sticky: clear it for the next launch
        return (int)err;
    }
    dim3 block(TW, TH);
    dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
    denoise_kernel<C><<<grid, block, smem, stream>>>(
        col, nrm, zdz, out, H, W, sigma, grad_mode);
    return (int)cudaGetLastError();
}

// The pair: col6 [N, H, W, 6] -> out [N, H, W, 7].
extern "C" int nvk_denoise(const float* col6, const float* nrm,
                           const float* zdz, float* out, int N, int H, int W,
                           float sigma, int grad_mode, cudaStream_t stream) {
    return launch_denoise<6>(col6, nrm, zdz, out, N, H, W, sigma, grad_mode,
                             stream);
}

// One buffer: col3 [N, H, W, 3] -> out [N, H, W, 4], with its own grad
// mode.
extern "C" int nvk_denoise_one(const float* col3, const float* nrm,
                               const float* zdz, float* out, int N, int H,
                               int W, float sigma, int grad_mode,
                               cudaStream_t stream) {
    return launch_denoise<3>(col3, nrm, zdz, out, N, H, W, sigma, grad_mode,
                             stream);
}
