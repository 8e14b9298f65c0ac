// Ray-block x leaf visit mask: one thread block per block of RB rays.
//
// Replaces the Pallas kernel _mask_kernel (nvdiffrecmc_tpu/ops/
// pallas_tracer.py:94, launched from visit_masks :153).  The TPU kernel
// puts 8 rays on the sublanes and 128 leaves on the lanes, slab-tests every
// (ray, leaf) pair and max-reduces over the block's rays.  Here the block's
// OR over its rays is one int flag per leaf in shared memory: the threads
// stride over the block's (ray, leaf) pairs, neighbouring threads on
// neighbouring leaves of one ray (a broadcast load of the ray, consecutive
// boxes), skip a leaf whose flag is already set (the OR is monotone, so a
// skipped test cannot change it), and set the flag on a hit.  The races on
// a flag only ever write 1.  After a barrier the flags are the block's row
// of the mask.
//
// The slab arithmetic is the JAX kernel's: inv = 1/d where |d| > 1e-12,
// else 2e12; tn = max of the per-axis near distances and tmin, tf = min of
// the far ones and tmax; a hit is tf >= tn.  For finite rays and boxes no
// NaN arises, so fmaxf/fminf give the same bits as the plain version's
// torch.maximum/minimum.
//
// What bounds it: the slab tests, ~25 float operations per (ray, leaf)
// pair not skipped, against 64 bytes read per ray; it is operation-bound
// where few leaves are entered and far below it where the flags fill early.
//
// Layouts: rayf [NB*RB, 16] (d | o x d | o | 1 | 0...); aabb_lo/hi [C, 3];
// out [NB, C] int32.

#include <cuda_runtime.h>

__global__ void mask_kernel(const float* __restrict__ rayf,
                            const float* __restrict__ alo,
                            const float* __restrict__ ahi,
                            int* __restrict__ out, int RB, int C, float tmin,
                            float tmax) {
    extern __shared__ int flags[];
    for (int c = threadIdx.x; c < C; c += blockDim.x) flags[c] = 0;
    __syncthreads();

    const float* rays = rayf + (size_t)blockIdx.x * RB * 16;
    long long n = (long long)RB * C;
    // pair k = r * C + c; a stride of blockDim pairs is dr rays and dc leaves
    int r = threadIdx.x / C, c = threadIdx.x % C;
    const int dr = blockDim.x / C, dc = blockDim.x % C;
    for (long long k = threadIdx.x; k < n; k += blockDim.x) {
        if (!flags[c]) {
            const float* ray = rays + (size_t)r * 16;
            float dx = ray[0], dy = ray[1], dz = ray[2];
            float ox = ray[6], oy = ray[7], oz = ray[8];
            float ix = fabsf(dx) > 1e-12f ? 1.f / dx : 2e12f;
            float iy = fabsf(dy) > 1e-12f ? 1.f / dy : 2e12f;
            float iz = fabsf(dz) > 1e-12f ? 1.f / dz : 2e12f;
            const float* lo = alo + 3 * c;
            const float* hi = ahi + 3 * c;
            float t0x = (lo[0] - ox) * ix, t1x = (hi[0] - ox) * ix;
            float t0y = (lo[1] - oy) * iy, t1y = (hi[1] - oy) * iy;
            float t0z = (lo[2] - oz) * iz, t1z = (hi[2] - oz) * iz;
            float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), tmin));
            float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), tmax));
            if (tf >= tn) flags[c] = 1;
        }
        r += dr;
        c += dc;
        if (c >= C) {
            c -= C;
            ++r;
        }
    }
    __syncthreads();
    int* row = out + (size_t)blockIdx.x * C;
    for (int j = threadIdx.x; j < C; j += blockDim.x) row[j] = flags[j];
}

extern "C" int nvk_mask(const float* rayf, const float* aabb_lo,
                        const float* aabb_hi, int* out, int NB, int RB, int C,
                        float tmin, float tmax, cudaStream_t stream) {
    if (NB == 0 || C == 0) return 0;
    dim3 block(256);
    dim3 grid(NB);
    mask_kernel<<<grid, block, C * sizeof(int), stream>>>(
        rayf, aabb_lo, aabb_hi, out, RB, C, tmin, tmax);
    return (int)cudaGetLastError();
}
