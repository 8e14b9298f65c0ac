// Standalone any-hit shadow-ray tracer: one thread per ray.
//
// Replaces the Pallas kernel _trace_kernel (nvdiffrecmc_tpu/ops/
// pallas_tracer.py:189, launched from trace_rayf :415, entry any_hit_pallas
// :331) together with the visit lists it walks (visit_masks_od and
// _mask_to_lists).  The TPU kernel streams each ray block's list of visited
// leaves through VMEM and tests the whole block against a leaf with one
// Plücker matmul; here every ray walks the BVH on its own (trace.cuh:
// supernode box, leaf box, sub-box, the sub-box's triangles) and stops at
// its first hit.  Any-hit is monotone, so the visit order cannot change
// the result.  The walk is the one of the trace + shade kernel, so both
// give the plain version's bits (ops/tracer.py any_hit).
//
// What bounds it: the BVH walk, as in shade.cu.  Each ray tests the
// supernode boxes and the leaf boxes of the supernodes it enters from
// shared memory, the sub-boxes of the leaves it enters through the
// read-only cache, and the G triangles of each sub-box it enters (96-byte
// rows of a 2.5 MB table that stays in L2); threads of a warp diverge
// across boxes.  L1/L2 load throughput and divergence bound it, not DRAM
// (24 bytes in and 1 out per ray).  Rays with a zero direction (masked
// pixels) fail every box at once.
//
// Layouts: ro, rd [R, 3]; the structure as trace.cuh's Walk; occ [R] bool
// (one byte).

#include "trace.cuh"

__global__ void trace_kernel(const float* __restrict__ ro,
                             const float* __restrict__ rd, Walk w,
                             bool* __restrict__ occ, int R, float tmin) {
    extern __shared__ float4 top[];
    load_top(top, w);
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    V3 o = mk3(ro[3 * r], ro[3 * r + 1], ro[3 * r + 2]);
    V3 d = mk3(rd[3 * r], rd[3 * r + 1], rd[3 * r + 2]);
    occ[r] = any_hit(o, d, top, w, tmin);
}

extern "C" int nvk_trace(const float* ro, const float* rd, const float* tri,
                         const float* aabb_lo, const float* aabb_hi,
                         const float* super_lo, const float* super_hi,
                         const float* sub_lo, const float* sub_hi, bool* occ,
                         int R, int C, int S, int L, int G, float tmin,
                         cudaStream_t stream) {
    if (R == 0) return 0;
    Walk w = {tri, aabb_lo, aabb_hi, super_lo, super_hi, sub_lo, sub_hi,
              C, S, L, G};
    size_t smem;
    cudaError_t err = walk_smem((const void*)trace_kernel, w, &smem);
    if (err != cudaSuccess) return (int)err;
    dim3 block(128);
    dim3 grid((R + 127) / 128);
    trace_kernel<<<grid, block, smem, stream>>>(ro, rd, w, occ, R, tmin);
    return (int)cudaGetLastError();
}
