// Coverage resolve of the rasterizer: one block per 32x32 pixel tile.
//
// Replaces the Pallas kernel _resolve_kernel (nvdiffrecmc_tpu/ops/
// pallas_raster.py:148, entry resolve_batch :222).  The TPU kernel walks
// per-tile visit lists and evaluates each 128-triangle chunk with one
// matmul; here the block walks all chunks in order, skips those whose
// screen bbox misses the tile (a test every thread evaluates alike), stages
// the chunk's 15x128 coefficients in shared memory and lets every thread
// test its 4 pixels against the chunk's triangles in order.
//
// Per pixel it keeps the nearest z that passes the inside test and the
// depth-peel rule z > prev_z + Z_EPS, excluding prev_id; a strict `<` keeps
// the lowest triangle id on ties (rasterizer._resolve_single, zk < best_z).
// The edge, depth and sum fields are evaluated as c0*sx + c1*sy + c2, the
// order of the plain version (ops/pallas_raster.resolve_batch_plain).
//
// What bounds it: arithmetic, ~20 flops per (pixel, triangle) pair over the
// chunks whose bbox overlaps the tile; coefficient traffic is 7.5 KB per
// chunk per tile, read once into shared memory.
//
// Layouts: coef [N, NC, 15, 128] (row f*3+c: field f in e0 e1 e2 z s,
// component c multiplies sx, sy, 1); bbox [N, NC, 4] (xlo ylo xhi yhi, NDC);
// prev_z [N, H, W]; prev_id [N, H, W] int32; out z [N, H, W], tid [N, H, W]
// int32 (tri_id + 1, 0 = empty).

#include "common.cuh"

#define TC 128
#define TILE 32
#define ROWS_PER_THREAD 4
#define BIG_F 3e37f
#define Z_EPS_F 1e-7f

__global__ void resolve_kernel(const float* __restrict__ coef,
                               const float* __restrict__ bbox,
                               const float* __restrict__ prev_z,
                               const int* __restrict__ prev_id,
                               float* __restrict__ z_out,
                               int* __restrict__ tid_out, int NC, int H,
                               int W) {
    __shared__ float sc[15 * TC];
    const int b = blockIdx.z;
    const int x = blockIdx.x * TILE + threadIdx.x;
    const int y0 = blockIdx.y * TILE + threadIdx.y;
    const int tid_lin = threadIdx.y * TILE + threadIdx.x;
    const int nthreads = TILE * (TILE / ROWS_PER_THREAD);

    float sx = 2.f * ((float)x + 0.5f) / (float)W - 1.f;
    float sy[ROWS_PER_THREAD], pzeps[ROWS_PER_THREAD], best_z[ROWS_PER_THREAD];
    int pid[ROWS_PER_THREAD], best_id[ROWS_PER_THREAD];
    bool live[ROWS_PER_THREAD];
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        int y = y0 + k * (TILE / ROWS_PER_THREAD);
        live[k] = (x < W) && (y < H);
        size_t pix = ((size_t)b * H + y) * W + x;
        sy[k] = 2.f * ((float)y + 0.5f) / (float)H - 1.f;
        pzeps[k] = live[k] ? prev_z[pix] + Z_EPS_F : BIG_F;
        pid[k] = live[k] ? prev_id[pix] : 0;
        best_z[k] = BIG_F;
        best_id[k] = 0;
    }

    // tile bbox in NDC with a half-pixel apron
    const int tx0 = blockIdx.x * TILE, ty0 = blockIdx.y * TILE;
    float txlo = 2.f * ((float)tx0 + 0.5f) / (float)W - 1.f - 1.f / (float)W;
    float txhi = 2.f * ((float)(tx0 + TILE - 1) + 0.5f) / (float)W - 1.f
                 + 1.f / (float)W;
    float tylo = 2.f * ((float)ty0 + 0.5f) / (float)H - 1.f - 1.f / (float)H;
    float tyhi = 2.f * ((float)(ty0 + TILE - 1) + 0.5f) / (float)H - 1.f
                 + 1.f / (float)H;

    const float* cf = coef + (size_t)b * NC * 15 * TC;
    const float* bb = bbox + (size_t)b * NC * 4;
    for (int c = 0; c < NC; ++c) {
        float bxlo = bb[4 * c], bylo = bb[4 * c + 1], bxhi = bb[4 * c + 2],
              byhi = bb[4 * c + 3];
        if (!(txlo <= bxhi && txhi >= bxlo && tylo <= byhi && tyhi >= bylo))
            continue;  // uniform across the block
        __syncthreads();
        for (int i = tid_lin; i < 15 * TC; i += nthreads)
            sc[i] = cf[(size_t)c * 15 * TC + i];
        __syncthreads();
        for (int t = 0; t < TC; ++t) {
            int id = c * TC + t + 1;
            float a[15];
            for (int r = 0; r < 15; ++r) a[r] = sc[r * TC + t];
            for (int k = 0; k < ROWS_PER_THREAD; ++k) {
                float e0 = a[0] * sx + a[1] * sy[k] + a[2];
                float e1 = a[3] * sx + a[4] * sy[k] + a[5];
                float e2 = a[6] * sx + a[7] * sy[k] + a[8];
                float z = a[9] * sx + a[10] * sy[k] + a[11];
                float s = a[12] * sx + a[13] * sy[k] + a[14];
                bool inside = e0 > 0.f && e1 > 0.f && e2 > 0.f && s > 0.f
                              && z >= -1.f && z <= 1.f && z > pzeps[k]
                              && id != pid[k];
                if (inside && z < best_z[k]) {
                    best_z[k] = z;
                    best_id[k] = id;
                }
            }
        }
    }
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        if (!live[k]) continue;
        int y = y0 + k * (TILE / ROWS_PER_THREAD);
        size_t pix = ((size_t)b * H + y) * W + x;
        bool hit = best_z[k] < BIG_F;
        z_out[pix] = hit ? best_z[k] : 0.f;
        tid_out[pix] = hit ? best_id[k] : 0;
    }
}

extern "C" int nvk_resolve(const float* coef, const float* bbox,
                           const float* prev_z, const int* prev_id,
                           float* z_out, int* tid_out, int N, int NC, int H,
                           int W, cudaStream_t stream) {
    dim3 block(TILE, TILE / ROWS_PER_THREAD);
    dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, N);
    resolve_kernel<<<grid, block, 0, stream>>>(coef, bbox, prev_z, prev_id,
                                               z_out, tid_out, NC, H, W);
    return (int)cudaGetLastError();
}
