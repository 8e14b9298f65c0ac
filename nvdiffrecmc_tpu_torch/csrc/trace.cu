// Standalone any-hit shadow-ray tracer: one thread per ray.
//
// Replaces the Pallas kernel _trace_kernel (nvdiffrecmc_tpu/ops/
// pallas_tracer.py:189, launched from trace_rayf :415, entry any_hit_pallas
// :331) together with the visit lists it walks (visit_masks_od and
// _mask_to_lists).  The TPU kernel streams each ray block's list of visited
// leaves through VMEM and tests the whole block against a leaf with one
// Plücker matmul; here every ray walks the two-level BVH on its own
// (trace.cuh: supernode box, leaf box, the leaf's triangles) and stops at
// its first hit.  Any-hit is monotone, so the visit order cannot change
// the result.  The walk is the one of the trace + shade kernel, so both
// give the plain version's bits (ops/tracer.py any_hit).
//
// What bounds it: the BVH walk, as in shade.cu.  Each ray tests the
// supernode boxes, the leaf boxes of the supernodes it enters and up to
// 128 triangles per leaf it enters (a 2.5 MB triangle table that stays in
// L2); threads of a warp diverge across leaves.  L1/L2 load throughput and
// divergence bound it, not DRAM (24 bytes in and 1 out per ray).  Rays
// with a zero direction (masked pixels) fail every box at once.
//
// Layouts: ro, rd [R, 3]; tri [C*L, 24] (bvh.py); aabb_lo/hi [C, 3];
// super_lo/hi [S, 3]; occ [R] bool (one byte).

#include "trace.cuh"

__global__ void trace_kernel(const float* __restrict__ ro,
                             const float* __restrict__ rd,
                             const float* __restrict__ tri,
                             const float* __restrict__ alo,
                             const float* __restrict__ ahi,
                             const float* __restrict__ slo,
                             const float* __restrict__ shi,
                             bool* __restrict__ occ, int R, int C, int S,
                             int L, float tmin) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    V3 o = mk3(ro[3 * r], ro[3 * r + 1], ro[3 * r + 2]);
    V3 d = mk3(rd[3 * r], rd[3 * r + 1], rd[3 * r + 2]);
    occ[r] = any_hit(o, d, tri, alo, ahi, slo, shi, C, S, L, tmin);
}

extern "C" int nvk_trace(const float* ro, const float* rd, const float* tri,
                         const float* aabb_lo, const float* aabb_hi,
                         const float* super_lo, const float* super_hi,
                         bool* occ, int R, int C, int S, int L, float tmin,
                         cudaStream_t stream) {
    if (R == 0) return 0;
    dim3 block(128);
    dim3 grid((R + 127) / 128);
    trace_kernel<<<grid, block, 0, stream>>>(ro, rd, tri, aabb_lo, aabb_hi,
                                             super_lo, super_hi, occ, R, C,
                                             S, L, tmin);
    return (int)cudaGetLastError();
}
