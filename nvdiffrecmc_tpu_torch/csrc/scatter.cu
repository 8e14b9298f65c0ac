// Row scatter-add, the adjoint of every rows_gather: one thread per
// (update row, channel), float atomicAdd into the output table.
//
// Replaces the Pallas kernel _kernel (nvdiffrecmc_tpu/ops/
// pallas_scatter.py:45, entry sorted_scatter_add_t :70, scatter_add_t
// :189).  The TPU has no scatter worth the name, so the JAX package
// sorts the updates by target row, cuts the table into bins and
// accumulates each bin with a one-hot matmul.  Hopper has float atomics in L2, so no sort is needed: every
// update is added where it lands.  The order of the additions is the order
// in which the atomics reach L2, which changes from run to run; the sums
// agree with the plain version (index_add_) to rounding, not to the bit.
//
// Rows whose id lies outside [0, V) are dropped, as in the TPU kernel.
// Zero updates are skipped (x + 0 == x), which removes most of the atomics
// of a texture or vertex adjoint whose pixels are largely uncovered.
//
// What bounds it: the atomics.  At the training step the largest call is
// the texture pyramid adjoint, 2.1M rows x 9 channels into 1.4M texels
// (75 MB read); neighbouring pixels hit neighbouring texels, so atomics
// contend little.  Reads of the update rows are coalesced (thread i reads
// element i of the [M, C] row-major array).
//
// Layouts: idx [M] int64; vals [M, C] f32; out [V, C] f32 (zeroed by the
// caller).

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void scatter_add_kernel(const int64_t* __restrict__ idx,
                                   const float* __restrict__ vals,
                                   float* __restrict__ out, long long M,
                                   int C, long long V) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M * C) return;
    long long m = i / C;
    int c = (int)(i - m * C);
    float v = vals[i];
    if (v == 0.f) return;
    long long r = idx[m];
    if (r < 0 || r >= V) return;
    atomicAdd(out + r * C + c, v);
}

extern "C" int nvk_scatter_add(const int64_t* idx, const float* vals,
                               float* out, long long M, int C, long long V,
                               cudaStream_t stream) {
    long long n = M * (long long)C;
    if (n == 0) return 0;
    dim3 block(256);
    dim3 grid((unsigned)((n + 255) / 256));
    scatter_add_kernel<<<grid, block, 0, stream>>>(idx, vals, out, M, C, V);
    return (int)cudaGetLastError();
}
