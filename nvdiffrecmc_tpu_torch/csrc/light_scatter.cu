// Light scatter: the environment-light gradient, one thread per (stratum,
// pixel), float atomicAdd of each ray's radiance cotangent into its texel.
//
// Replaces the Pallas kernel _light_scatter_kernel (nvdiffrecmc_tpu/ops/
// pallas_shade.py:777, entry light_scatter :813).  The TPU kernel builds
// one-hot row and column matrices in bf16 and accumulates the whole light
// table with a matmul per ray block; its f32 twin light_scatter_jnp :831
// is the CPU oracle.  Here each ray adds its three f32 values where its
// nearest-texel fetch read them (the reference's atomicAdd, kernel.cu:
// 203-211), so no value is rounded to bf16.  The order of the atomics
// changes from run to run; sums agree to rounding, not to the bit.
//
// Rays whose three cotangents are zero (masked pixels) add nothing and are
// skipped.  What bounds it: the atomics into a 256x256x3 table (786 KB,
// resident in L2).  Rays of one warp sample nearby directions, so several
// may land on one texel and serialise; 2 x 16 x 262,144 rays at the slice.
//
// Layouts: drad [n2, 8, P] (d_lrad3, d_brad3, tex_l, tex_b as floats);
// dbase [Hl*Wl, 3] f32 (zeroed by the caller).

#include <cuda_runtime.h>

__global__ void light_scatter_kernel(const float* __restrict__ drad,
                                     float* __restrict__ dbase, int P,
                                     int HW) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    int s = blockIdx.y;
    if (p >= P) return;
    const size_t sP = (size_t)P;
    const float* d = drad + (size_t)s * 8 * sP + p;
    for (int ray = 0; ray < 2; ++ray) {
        float g0 = d[(3 * ray) * sP], g1 = d[(3 * ray + 1) * sP],
              g2 = d[(3 * ray + 2) * sP];
        if (g0 == 0.f && g1 == 0.f && g2 == 0.f) continue;
        int t = (int)d[(6 + ray) * sP];
        if (t < 0 || t >= HW) continue;
        float* o = dbase + (size_t)t * 3;
        atomicAdd(o, g0);
        atomicAdd(o + 1, g1);
        atomicAdd(o + 2, g2);
    }
}

extern "C" int nvk_light_scatter(const float* drad, float* dbase, int n2,
                                 int P, int HW, cudaStream_t stream) {
    dim3 block(256);
    dim3 grid((P + 255) / 256, n2);
    light_scatter_kernel<<<grid, block, 0, stream>>>(drad, dbase, P, HW);
    return (int)cudaGetLastError();
}
