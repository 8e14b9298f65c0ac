// Row scatter-add, the adjoint of every rows_gather: out[idx[m], :] +=
// vals[m, :].  One warp takes 32 consecutive update rows at a time, one
// lane a row; lanes whose rows go to the same output row add them up first
// and one lane issues the group's atomics.
//
// Replaces the Pallas kernel _kernel (nvdiffrecmc_tpu/ops/
// pallas_scatter.py:45, entry sorted_scatter_add_t :70, scatter_add_t
// :189).  The TPU has no scatter worth the name, so the JAX package sorts
// the updates by target row, cuts the table into bins and accumulates each
// bin with a one-hot matmul.  Hopper has float atomics in L2, so no sort is
// needed: every update is added where it lands.  The order of the additions
// is the order in which the atomics reach L2, which changes from run to
// run; the sums agree with the plain version (index_add_) to rounding, not
// to the bit.  A float atomic add flushes subnormal terms and sums to zero,
// as index_add_'s atomics on the card do.
//
// Rows whose id lies outside [0, V) are dropped, as in the TPU kernel.  A
// row whose C values are all zero is skipped after one test, which removes
// most of the atomics of a texture or vertex adjoint whose pixels are
// largely uncovered.
//
// What bounds it: the bytes of idx (8 a row), vals (4 C a row) and out
// (4 C an output row) over 3.35 TB/s, and the atomics' traffic into L2.  At
// the training step the largest call is the texture pyramid's adjoint,
// 2.1 M rows x 9 channels into 1.4 M texels; the vertex and triangle
// adjoints put ~61 and ~10-20 updates on each output row, and neighbouring
// pixels, which share a triangle and its vertices, send their atomics to
// the same addresses, where L2 serialises them.  The design:
//
// - the kernel is a template on C for the step's channel counts (3, 4, 6,
//   9, 13), with one generic instance for any other C: the row index comes
//   from a loop counter, never from a division of the element index;
// - each warp of an instance stages its 32 rows (128 C bytes, 16-byte
//   aligned when vals is) into shared memory with 16-byte streaming loads;
//   the generic instance, which no step launch uses, reads each lane's row
//   from global memory and adds it with scalar atomics;
// - lanes of one warp holding the same id (__match_any_sync) are summed,
//   in lane order, by the group's lowest lane, which then adds the group's
//   row to out: one set of atomics per distinct row per warp instead of
//   one per update;
// - the row is added with Hopper's vector atomics (atomicAdd on float4 and
//   float2, compute capability 9.x) where its address is aligned, scalar
//   ones at its ends; out keeps its [V, C] layout.
//
// Layouts: idx [M] int64; vals [M, C] f32; out [V, C] f32 (zeroed by the
// caller).  Shared memory: 128 C bytes a warp for the step's channel
// counts; the generic instance reads its rows from global memory and takes
// any C.

#include <cuda_runtime.h>
#include <stdint.h>

#define SCATTER_WARPS 8   // warps per block
#define FULL_MASK 0xffffffffu

// Add the n floats of s (shared memory) to d (global) with the widest
// atomics its alignment allows; all-zero pieces add nothing.
__device__ __forceinline__ void add_row_vec(float* d, const float* s, int n) {
    int c = 0;
    while (c < n && ((uintptr_t)(d + c) & 15)) {
        if (!((uintptr_t)(d + c) & 7) && c + 2 <= n) {
            float2 v = make_float2(s[c], s[c + 1]);
            if (v.x != 0.f || v.y != 0.f) atomicAdd((float2*)(d + c), v);
            c += 2;
        } else {
            if (s[c] != 0.f) atomicAdd(d + c, s[c]);
            c += 1;
        }
    }
    for (; c + 4 <= n; c += 4) {
        float4 v = make_float4(s[c], s[c + 1], s[c + 2], s[c + 3]);
        if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
            atomicAdd((float4*)(d + c), v);
    }
    if (c + 2 <= n) {
        float2 v = make_float2(s[c], s[c + 1]);
        if (v.x != 0.f || v.y != 0.f) atomicAdd((float2*)(d + c), v);
        c += 2;
    }
    if (c < n && s[c] != 0.f) atomicAdd(d + c, s[c]);
}

// C = CT, known at compile time: the channel loops unroll and the group's
// sum is kept in registers.
template <int CT>
__global__ void scatter_add_kernel(const int64_t* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, long long M,
                                   long long V, int aligned) {
    __shared__ float4 smem4[SCATTER_WARPS * 8 * CT];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* rows = (float*)smem4 + warp * 32 * CT;
    float* row = rows + lane * CT;
    const long long chunks = (M + 31) >> 5;
    for (long long k = (long long)blockIdx.x * SCATTER_WARPS + warp;
         k < chunks; k += (long long)gridDim.x * SCATTER_WARPS) {
        const long long m0 = k << 5;
        const int n = M - m0 < 32 ? (int)(M - m0) : 32;
        const float* src = vals + m0 * CT;
        // the id's load first, so that it overlaps the rows' loads
        const long long id =
            lane < n ? __ldcs((const long long*)idx + m0 + lane) : -1;
        if (n == 32 && aligned) {
            const float4* s4 = (const float4*)src;
            float4* d4 = (float4*)rows;
            for (int j = lane; j < 8 * CT; j += 32) d4[j] = __ldcs(s4 + j);
        } else {
            for (int j = lane; j < n * CT; j += 32) rows[j] = __ldcs(src + j);
        }
        __syncwarp();
        bool nonzero = false;
#pragma unroll
        for (int c = 0; c < CT; ++c) nonzero |= row[c] != 0.f;
        const bool active = lane < n && nonzero && id >= 0 && id < V;
        bool lead = active;
        const unsigned live = __ballot_sync(FULL_MASK, active);
        if (live & (live - 1)) {   // two or more live lanes
            // inactive lanes share the key ~0, which no valid id equals
            const unsigned grp = __match_any_sync(
                FULL_MASK, active ? (unsigned long long)id : ~0ULL);
            lead = active && __ffs(grp) - 1 == lane;
            if (lead) {   // the sum in registers, in lane order
                float acc[CT];
#pragma unroll
                for (int c = 0; c < CT; ++c) acc[c] = row[c];
                for (unsigned m = grp & (grp - 1); m; m &= m - 1) {
                    const float* o = rows + (__ffs(m) - 1) * CT;
#pragma unroll
                    for (int c = 0; c < CT; ++c) acc[c] += o[c];
                }
#pragma unroll
                for (int c = 0; c < CT; ++c) row[c] = acc[c];
            }
        }
        if (lead) add_row_vec(out + id * CT, row, CT);
        __syncwarp();
    }
}

// Any C: a lane's row is read from global memory, the group's lowest lane
// sums the group's rows channel by channel, in lane order, and adds each
// nonzero sum with a scalar atomic.
__global__ void scatter_add_generic(const int64_t* __restrict__ idx,
                                    const float* __restrict__ vals,
                                    float* __restrict__ out, long long M,
                                    int C, long long V) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long chunks = (M + 31) >> 5;
    for (long long k = (long long)blockIdx.x * SCATTER_WARPS + warp;
         k < chunks; k += (long long)gridDim.x * SCATTER_WARPS) {
        const long long m = (k << 5) + lane;
        const float* row = vals + m * C;
        const long long id = m < M ? idx[m] : -1;
        bool nonzero = false;
        for (int c = 0; c < C && m < M && !nonzero; ++c)
            nonzero = row[c] != 0.f;
        const bool active = nonzero && id >= 0 && id < V;
        const unsigned grp = __match_any_sync(
            FULL_MASK, active ? (unsigned long long)id : ~0ULL);
        if (active && __ffs(grp) - 1 == lane) {
            for (int c = 0; c < C; ++c) {
                float acc = row[c];
                for (unsigned g = grp & (grp - 1); g; g &= g - 1)
                    acc += row[(long long)(__ffs(g) - 1 - lane) * C + c];
                if (acc != 0.f) atomicAdd(out + id * C + c, acc);
            }
        }
        __syncwarp();
    }
}

typedef void (*ScatterFn)(const int64_t*, const float*, float*, long long,
                          long long, int);

static ScatterFn pick(int C) {
    switch (C) {
        case 3: return scatter_add_kernel<3>;
        case 4: return scatter_add_kernel<4>;
        case 6: return scatter_add_kernel<6>;
        case 9: return scatter_add_kernel<9>;
        case 13: return scatter_add_kernel<13>;
        default: return nullptr;
    }
}

extern "C" int nvk_scatter_add(const int64_t* idx, const float* vals,
                               float* out, long long M, int C, long long V,
                               cudaStream_t stream) {
    if (M == 0 || C == 0) return 0;
    const long long blocks =
        ((M + 31) / 32 + SCATTER_WARPS - 1) / SCATTER_WARPS;
    dim3 grid((unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20)));
    ScatterFn fn = pick(C);
    if (fn)
        fn<<<grid, 32 * SCATTER_WARPS, 0, stream>>>(
            idx, vals, out, M, V, ((uintptr_t)vals & 15) == 0);
    else
        scatter_add_generic<<<grid, 32 * SCATTER_WARPS, 0, stream>>>(
            idx, vals, out, M, C, V);
    return (int)cudaGetLastError();
}
