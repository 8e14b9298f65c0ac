// Cross-bilateral denoiser for a pair of color buffers, forward and grad
// mode: one thread per output pixel.
//
// Replaces the Pallas kernel _denoise_kernel (nvdiffrecmc_tpu/ops/
// pallas_denoise.py:47, both modes; entries bilateral_denoiser_pair :215
// and the backward _premul_pair_bwd :193).
// The TPU kernel DMAs a row window of all planes into VMEM and unrolls the
// tap columns; here each thread walks the 23x23 taps (R = 11) in row-major
// order, as ops/denoiser._taps does, reading its neighbours through L1.
//
// Weight of a tap: exp(-d^2 / (2 sigma^2)) (zero beyond the dynamic radius
// 2*ceil(2.5 sigma)+1) * pow(clamp(n_tap . n_center, 1e-4, 1), 128) *
// exp(-|z_tap - z_center| / max(dz_center * d, 1e-4)) * valid.  Taps
// outside the image have valid = 0: they add exactly zero and are skipped.
// Output: 6 premultiplied channels and the weight sum; the division by
// max(w, 1e-4) stays in PyTorch.
//
// Grad mode (the backward): col6 holds the output gradient, and the depth
// denominator takes the tap's dz instead of the center's, which makes the
// weights those of the transposed filter (the reference's
// denoising.cu:114-118); the weight sum is then meaningless.
//
// What bounds it: 529 taps x 11 floats read per pixel (~23 KB), nearly all
// L1 hits since neighbouring threads share taps; ~30 flops and 2 exp + 1 pow
// per tap, so it is bound by L1 load throughput and the special-function
// units, not by DRAM (the planes are 12 MB at 512x512).
//
// Layouts: col6 [N, H, W, 6]; nrm [N, H, W, 3]; zdz [N, H, W, 2] (z, dz);
// out [N, H, W, 7].

#include "common.cuh"

#define R 11
#define KT (2 * R + 1)
#define FLT_EPS_D 1e-4f

__global__ void denoise_kernel(const float* __restrict__ col6,
                               const float* __restrict__ nrm,
                               const float* __restrict__ zdz,
                               float* __restrict__ out, int H, int W,
                               float sigma, int grad_mode) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    int n = blockIdx.z;
    if (x >= W || y >= H) return;
    size_t base = (size_t)n * H * W;
    size_t pc = base + (size_t)y * W + x;
    float cn0 = nrm[pc * 3], cn1 = nrm[pc * 3 + 1], cn2 = nrm[pc * 3 + 2];
    float cz = zdz[pc * 2], cdz = zdz[pc * 2 + 1];
    float variance = sigma * sigma;
    float dyn_rad = 2.f * ceilf(sigma * 2.5f) + 1.f;

    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float accw = 0.f;
    for (int ky = 0; ky < KT; ++ky) {
        int fy = ky - R;
        int yy = y + fy;
        if (yy < 0 || yy >= H) continue;
        for (int kx = 0; kx < KT; ++kx) {
            int fx = kx - R;
            int xx = x + fx;
            if (xx < 0 || xx >= W) continue;
            float dist_sqr = (float)(fx * fx + fy * fy);
            float dist = sqrtf(dist_sqr);
            float w_xy = expf(-dist_sqr / (2.f * variance));
            if (fabsf((float)fx) > dyn_rad || fabsf((float)fy) > dyn_rad)
                w_xy = 0.f;
            size_t pt = base + (size_t)yy * W + xx;
            float ndot = nrm[pt * 3] * cn0 + nrm[pt * 3 + 1] * cn1
                         + nrm[pt * 3 + 2] * cn2;
            float w_normal = powf(fminf(fmaxf(ndot, FLT_EPS_D), 1.f), 128.f);
            float dz = grad_mode ? zdz[pt * 2 + 1] : cdz;
            float denom = fmaxf(dz * dist, FLT_EPS_D);
            float w_depth = expf(-fabsf(zdz[pt * 2] - cz) / denom);
            float w = w_xy * w_normal * w_depth * 1.f;
            const float* tc = col6 + pt * 6;
            for (int c = 0; c < 6; ++c) acc[c] = acc[c] + tc[c] * w;
            accw = accw + w;
        }
    }
    float* o = out + pc * 7;
    for (int c = 0; c < 6; ++c) o[c] = acc[c];
    o[6] = accw;
}

extern "C" int nvk_denoise(const float* col6, const float* nrm,
                           const float* zdz, float* out, int N, int H, int W,
                           float sigma, int grad_mode, cudaStream_t stream) {
    dim3 block(16, 16);
    dim3 grid((W + 15) / 16, (H + 15) / 16, N);
    denoise_kernel<<<grid, block, 0, stream>>>(col6, nrm, zdz, out, H, W,
                                               sigma, grad_mode);
    return (int)cudaGetLastError();
}
