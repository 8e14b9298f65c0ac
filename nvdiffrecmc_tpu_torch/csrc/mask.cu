// Ray-block x leaf visit mask: per block of RB rays and per leaf, whether
// any ray of the block enters the leaf's box in [tmin, tmax].  One thread
// block per ray block; its rays are staged into shared memory a tile at a
// time, and each warp takes a leaf, its 32 lanes 32 rays of the tile at
// once, until a ray enters the box (a vote) or the rays run out.
//
// Replaces the Pallas kernel _mask_kernel (nvdiffrecmc_tpu/ops/
// pallas_tracer.py:94, launched from visit_masks :153).  The TPU kernel
// puts 8 rays on the sublanes and 128 leaves on the lanes, slab-tests every
// (ray, leaf) pair and max-reduces over the block's rays.
//
// The slab arithmetic is the JAX kernel's: inv = 1/d where |d| > 1e-12,
// else 2e12; tn = max of the per-axis near distances and tmin, tf = min of
// the far ones and tmax; a hit is tf >= tn.  For finite rays and boxes no
// NaN arises, so fmaxf/fminf give the same bits as the plain version's
// torch.maximum/minimum, and every entry equals the plain version's.
//
// What bounds it: the 64 bytes read per ray that a block needs (d and o
// sit in the first 36 of the 64 bytes of a feature row, so both 32-byte
// sectors are read): every ray of a block that leaves a leaf unentered,
// else its rays up to the last of its leaves' first entering rays;
// against ~25 float operations per test that the answer needs: every ray
// for a leaf the block does not enter, one for a leaf it does.  On the
// bench rays (random directions from inside the mesh) every leaf of every
// block is entered: the answer needs few tests and a prefix of each
// block's rays, and bytes set the bound.  On a validation stratum
// (coherent rays, a quarter of the leaves not entered, ~70% of the rays
// disabled: origin at BIG, zero direction) every ray is read and bytes
// set it too; the tests come close.  The design:
//
// - each ray's o and inv (1/d by the JAX rule, once per ray) are staged
//   into shared memory from 16-byte loads of the feature row (24 bytes a
//   ray), MASK_TILE rays at a time, leaving out a ray equal to the one
//   before it: a run of disabled rays is tested once;
// - a warp per leaf and a lane per ray: a leaf entered early costs one or
//   two 32-ray steps of its warp, one not entered one step per 32 staged
//   rays with every lane busy;
// - the leaf's box is a broadcast load; no shared flags, no races: a
//   leaf's entry is written by its warp alone;
// - the next tile is staged only while some leaf of the block is not
//   entered, so a block whose leaves are all entered stops reading rays.
//
// Layouts: rayf [NB*RB, 16] (d | o x d | o | 1 | 0...); aabb_lo/hi [C, 3];
// out [NB, C] int32.  Any C and RB.

#include <cuda_runtime.h>

#define MASK_TILE 512    // rays staged per tile (12 KB of shared memory)
#define MASK_WARPS 16    // warps per block
#define FULL_MASK 0xffffffffu

static_assert(32 * MASK_WARPS >= MASK_TILE, "a thread stages one ray");

__device__ __forceinline__ float jax_inv(float d) {
    return fabsf(d) > 1e-12f ? 1.f / d : 2e12f;
}

// Stage rays [r0, r0 + n) of the block, one a thread, as (ox, oy), (oz,
// ix), (iy, iz), packed in order, leaving out each ray equal to the one
// before it (the same d and o bits, hence the same tests).  wcount: a word
// per warp.  Returns the rays staged.
__device__ __forceinline__ int stage(const float4* __restrict__ rays,
                                     float2* s, int* wcount, int r0, int n) {
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, c = a;
    if (t < n) {
        const float4* f = rays + (size_t)(r0 + t) * 4;
        a = __ldcs(f);       // (dx, dy, dz, m.x)
        b = __ldcs(f + 1);   // (m.y, m.z, ox, oy)
        c = __ldcs(f + 2);   // (oz, 1, 0, 0)
    }
    // the ray before: lane - 1's, or the one before the warp's first
    const float mine[6] = {a.x, a.y, a.z, b.z, b.w, c.x};
    float prev[6];
#pragma unroll
    for (int k = 0; k < 6; ++k)
        prev[k] = __shfl_up_sync(FULL_MASK, mine[k], 1);
    if (lane == 0 && t < n && r0 + t > 0) {
        const float4* g = rays + (size_t)(r0 + t - 1) * 4;
        const float4 a0 = g[0], b0 = g[1], c0 = g[2];
        prev[0] = a0.x, prev[1] = a0.y, prev[2] = a0.z;
        prev[3] = b0.z, prev[4] = b0.w, prev[5] = c0.x;
    }
    bool same = r0 + t > 0;
#pragma unroll
    for (int k = 0; k < 6; ++k)
        same &= __float_as_uint(mine[k]) == __float_as_uint(prev[k]);
    const bool keep = t < n && !same;
    const unsigned bal = __ballot_sync(FULL_MASK, keep);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int off = 0, total = 0;
    for (int w = 0; w < MASK_WARPS; ++w) {
        off += w < warp ? wcount[w] : 0;
        total += wcount[w];
    }
    if (keep) {
        const int i = off + __popc(bal & ((1u << lane) - 1u));
        s[3 * i] = make_float2(b.z, b.w);
        s[3 * i + 1] = make_float2(c.x, jax_inv(a.x));
        s[3 * i + 2] = make_float2(jax_inv(a.y), jax_inv(a.z));
    }
    return total;
}

__device__ __forceinline__ bool slab(const float2* s, int r, float lx,
                                     float ly, float lz, float hx, float hy,
                                     float hz, float tmin, float tmax) {
    float2 p = s[3 * r], q = s[3 * r + 1], u = s[3 * r + 2];
    float t0x = (lx - p.x) * q.y, t1x = (hx - p.x) * q.y;
    float t0y = (ly - p.y) * u.x, t1y = (hy - p.y) * u.x;
    float t0z = (lz - q.x) * u.y, t1z = (hz - q.x) * u.y;
    float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                     fmaxf(fminf(t0z, t1z), tmin));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                     fminf(fmaxf(t0z, t1z), tmax));
    return tf >= tn;
}

__global__ void mask_kernel(const float* __restrict__ rayf,
                            const float* __restrict__ alo,
                            const float* __restrict__ ahi,
                            int* __restrict__ out, int RB, int C, float tmin,
                            float tmax) {
    __shared__ float2 s[3 * MASK_TILE];
    __shared__ int wcount[MASK_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float4* rays =
        (const float4*)(rayf + (size_t)blockIdx.x * RB * 16);
    int* row = out + (size_t)blockIdx.x * C;
    for (int r0 = 0; r0 < RB; r0 += MASK_TILE) {
        const int n = stage(rays, s, wcount, r0, min(MASK_TILE, RB - r0));
        __syncthreads();
        bool pending = false;   // a leaf of this warp not entered so far
        for (int c = warp; c < C; c += MASK_WARPS) {
            if (r0 > 0 && row[c]) continue;   // entered in an earlier tile
            const float lx = alo[3 * c], ly = alo[3 * c + 1],
                        lz = alo[3 * c + 2];
            const float hx = ahi[3 * c], hy = ahi[3 * c + 1],
                        hz = ahi[3 * c + 2];
            bool hit = false;
            for (int j = 0; j < n && !hit; j += 32) {
                const int r = j + lane;
                hit = __any_sync(FULL_MASK,
                                 r < n && slab(s, r, lx, ly, lz, hx, hy, hz,
                                               tmin, tmax));
            }
            if (lane == 0 && (r0 == 0 || hit)) row[c] = hit;
            pending |= !hit;
        }
        // the next tile overwrites s; stop once every leaf is entered
        if (!__syncthreads_or(pending)) break;
    }
}

extern "C" int nvk_mask(const float* rayf, const float* aabb_lo,
                        const float* aabb_hi, int* out, int NB, int RB, int C,
                        float tmin, float tmax, cudaStream_t stream) {
    if (NB == 0 || C == 0) return 0;
    mask_kernel<<<NB, 32 * MASK_WARPS, 0, stream>>>(rayf, aabb_lo, aabb_hi,
                                                    out, RB, C, tmin, tmax);
    return (int)cudaGetLastError();
}

// Registers and local bytes per thread, blocks per SM and shared bytes per
// block of mask_kernel.
extern "C" int nvk_mask_info(int* info) {
    cudaFuncAttributes a;
    int per_sm = 0;
    cudaError_t err = cudaFuncGetAttributes(&a, mask_kernel);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, mask_kernel, 32 * MASK_WARPS, 0);
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
