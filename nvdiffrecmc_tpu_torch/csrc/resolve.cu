// Coverage resolve of the rasterizer: a setup pass per triangle, a raster
// pass with one warp per triangle, and an unpack pass per pixel.
//
// Replaces the Pallas kernel _resolve_kernel (nvdiffrecmc_tpu/ops/
// pallas_raster.py:148, entry resolve_batch :222).  The TPU kernel walks
// per-tile visit lists and evaluates each 128-triangle chunk against a
// pixel tile with one matmul; here nothing walks chunks or tiles.  Each
// triangle visits only the pixels of its own screen rectangle, and the
// nearest one per pixel wins through a 64-bit atomicMin on the key
// (ordered_bits(z) << 32) | tri_id: the smallest key is the smallest z
// and, among equal z, the lowest id, whatever order the atomics land in.
//
// 1. setup_kernel, one thread per triangle: the 15 coefficients of the
//    edge, depth and sum fields, computed term by term as
//    rasterizer._tri_setup and pallas_raster._chunk_coefs do (row f*3+c:
//    field f in e0 e1 e2 z s, component c multiplies sx, sy, 1; edge and
//    sum rows times sign(det); invalid triangles zero), and the pixel
//    rectangle of the triangle's screen box grown by one pixel and clamped
//    to the screen (pallas_raster._tri_rects): the whole screen where a
//    vertex has w <= 1e-6, empty (x1 < x0) for an invalid triangle.
// 2. raster_kernel, one warp per triangle: the lanes stride over the
//    rectangle's pixels, evaluate the fields as c0*sx + c1*sy + c2 (the
//    plain version's order, resolve_batch_plain), and where the inside test
//    and the peel rule pass (e0, e1, e2, s > 0, -1 <= z <= 1,
//    z > prev_z + Z_EPS, id != prev_id) take the atomicMin.  -0.0 is made
//    +0.0 first: the plain version holds them equal and keeps the lower id.
// 3. unpack_kernel, one thread per pixel: z and tid = tri_id + 1 from the
//    key, 0 and 0 where no triangle passed (the key stayed all ones).
//
// What bounds it: launch latency and the atomics on the ~10^5 covered
// pixels (~2-3 passes each at the main path's depth complexity); the
// rectangles hold ~2 M pixels at 512x512 for the spot mesh.  One triangle
// with a vertex at w <= 1e-6 costs its warp the whole screen.
//
// Layouts: v_clip [N, V, 4]; tri [T, 3] int32; px [W] and py [H], the
// pixel centres in NDC (pallas_raster._pixel_ndc_xy); prev_z [N, H, W];
// prev_id [N, H, W] int32; scratch coef [N, T, 15], rect [N, T, 4] int32
// (x0 y0 x1 y1, inclusive) and key [N, H, W] uint64; out z [N, H, W],
// tid [N, H, W] int32.

#include <stdint.h>

#include "common.cuh"

#define Z_EPS_F 1e-7f
#define PIX 4                 // pixels per lane per pass of the raster loop
#define EMPTY_KEY 0xFFFFFFFFFFFFFFFFull

__global__ void setup_kernel(const float* __restrict__ v_clip,
                             const int* __restrict__ tri,
                             float* __restrict__ coef, int* __restrict__ rect,
                             int V, int T, int H, int W) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int n = blockIdx.y;
    if (t >= T) return;
    const float* vb = v_clip + (size_t)n * V * 4;
    float x[3], y[3], z[3], w[3];
    for (int k = 0; k < 3; ++k) {
        const float* p = vb + (size_t)tri[3 * t + k] * 4;
        x[k] = p[0];
        y[k] = p[1];
        z[k] = p[2];
        w[k] = p[3];
    }
    // rasterizer._tri_setup: adjugate rows A[i] = (a_i0, a_i1, a_i2)
    float A[3][3];
    A[0][0] = y[1] * w[2] - y[2] * w[1];
    A[0][1] = x[2] * w[1] - x[1] * w[2];
    A[0][2] = x[1] * y[2] - x[2] * y[1];
    A[1][0] = y[2] * w[0] - y[0] * w[2];
    A[1][1] = x[0] * w[2] - x[2] * w[0];
    A[1][2] = x[2] * y[0] - x[0] * y[2];
    A[2][0] = y[0] * w[1] - y[1] * w[0];
    A[2][1] = x[1] * w[0] - x[0] * w[1];
    A[2][2] = x[0] * y[1] - x[1] * y[0];
    float det = x[0] * A[0][0] + y[0] * A[0][1] + w[0] * A[0][2];
    float det_safe = fabsf(det) > 1e-20f ? det : 1e-20f;
    bool valid = fabsf(det) > 1e-12f;
    float ds = det > 0.f ? 1.f : (det < 0.f ? -1.f : 0.f);

    float* c = coef + ((size_t)n * T + t) * 15;
    for (int k = 0; k < 3; ++k) {
        float az = (A[0][k] * z[0] + A[1][k] * z[1] + A[2][k] * z[2])
                   / det_safe;
        float asum = A[0][k] + A[1][k] + A[2][k];
        c[0 + k] = valid ? A[0][k] * ds : 0.f;
        c[3 + k] = valid ? A[1][k] * ds : 0.f;
        c[6 + k] = valid ? A[2][k] * ds : 0.f;
        c[9 + k] = valid ? az : 0.f;
        c[12 + k] = valid ? asum * ds : 0.f;
    }

    // pallas_raster._tri_rects
    int* r = rect + ((size_t)n * T + t) * 4;
    float wmin = fminf(fminf(w[0], w[1]), w[2]);
    if (!valid) {
        r[0] = 0, r[1] = 0, r[2] = -1, r[3] = -1;
    } else if (!(wmin > 1e-6f)) {
        r[0] = 0, r[1] = 0, r[2] = W - 1, r[3] = H - 1;
    } else {
        float sx[3], sy[3];
        for (int k = 0; k < 3; ++k) {
            float ws = fmaxf(fabsf(w[k]), 1e-20f);
            sx[k] = x[k] / ws;
            sy[k] = y[k] / ws;
        }
        float lo[2] = {fminf(fminf(sx[0], sx[1]), sx[2]),
                       fminf(fminf(sy[0], sy[1]), sy[2])};
        float hi[2] = {fmaxf(fmaxf(sx[0], sx[1]), sx[2]),
                       fmaxf(fmaxf(sy[0], sy[1]), sy[2])};
        int size[2] = {W, H};
        for (int a = 0; a < 2; ++a) {
            float half = 0.5f * (float)size[a];
            float p0 = floorf((lo[a] + 1.f) * half - 0.5f) - 1.f;
            float p1 = ceilf((hi[a] + 1.f) * half - 0.5f) + 1.f;
            p0 = fminf(fmaxf(p0, 0.f), (float)size[a]);
            p1 = fmaxf(fminf(p1, (float)(size[a] - 1)), -1.f);
            r[a] = (int)p0;
            r[2 + a] = (int)p1;
        }
    }
}

// float -> uint32 that sorts like the float (-0.0 made +0.0 first)
__device__ __forceinline__ uint32_t ordered_bits(float z) {
    uint32_t u = __float_as_uint(z == 0.f ? 0.f : z);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t o) {
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__global__ void raster_kernel(const float* __restrict__ coef,
                              const int* __restrict__ rect,
                              const float* __restrict__ px,
                              const float* __restrict__ py,
                              const float* __restrict__ prev_z,
                              const int* __restrict__ prev_id,
                              unsigned long long* __restrict__ key, int T,
                              int H, int W) {
    const int warps = blockDim.x / 32;
    const int t = blockIdx.x * warps + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int n = blockIdx.y;
    if (t >= T) return;
    const int* r = rect + ((size_t)n * T + t) * 4;
    const int x0 = r[0], y0 = r[1];
    const int rw = r[2] - x0 + 1, rh = r[3] - y0 + 1;
    if (rw <= 0 || rh <= 0) return;
    const float* cp = coef + ((size_t)n * T + t) * 15;
    float c[15];
    for (int k = 0; k < 15; ++k) c[k] = cp[k];
    const size_t base = (size_t)n * H * W;
    const int count = rw * rh;
    // PIX pixels per lane in flight: their prev_z / prev_id loads overlap
    for (int i0 = lane; i0 < count; i0 += 32 * PIX) {
        int pix[PIX];                 // within the batch element
        float zp[PIX];
        bool pass[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
            const int i = i0 + 32 * k;
            pass[k] = false;
            if (i >= count) continue;
            const int y = y0 + i / rw, x = x0 + i % rw;
            const float sx = px[x], sy = py[y];
            float e0 = c[0] * sx + c[1] * sy + c[2];
            float e1 = c[3] * sx + c[4] * sy + c[5];
            float e2 = c[6] * sx + c[7] * sy + c[8];
            float z = c[9] * sx + c[10] * sy + c[11];
            float s = c[12] * sx + c[13] * sy + c[14];
            pass[k] = e0 > 0.f && e1 > 0.f && e2 > 0.f && s > 0.f
                      && z >= -1.f && z <= 1.f;
            zp[k] = z;
            pix[k] = y * W + x;
        }
        float pz[PIX];
        int pid[PIX];
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
            if (!pass[k]) continue;
            pz[k] = prev_z[base + pix[k]];
            pid[k] = prev_id[base + pix[k]];
        }
#pragma unroll
        for (int k = 0; k < PIX; ++k) {
            if (!pass[k] || !(zp[k] > pz[k] + Z_EPS_F) || t + 1 == pid[k])
                continue;
            atomicMin(key + base + pix[k],
                      ((unsigned long long)ordered_bits(zp[k])
                                     << 32) | (unsigned long long)t);
        }
    }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ key,
                              float* __restrict__ z_out,
                              int* __restrict__ tid_out, size_t n_pix) {
    size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_pix) return;
    unsigned long long k = key[i];
    bool hit = k != EMPTY_KEY;
    z_out[i] = hit ? from_ordered_bits((uint32_t)(k >> 32)) : 0.f;
    tid_out[i] = hit ? (int)(k & 0xFFFFFFFFull) + 1 : 0;
}

extern "C" int nvk_resolve(const float* v_clip, const int* tri,
                           const float* px, const float* py,
                           const float* prev_z, const int* prev_id,
                           float* coef, int* rect, unsigned long long* key,
                           float* z_out, int* tid_out, int N, int V, int T,
                           int H, int W, cudaStream_t stream) {
    const size_t n_pix = (size_t)N * H * W;
    cudaError_t err = cudaMemsetAsync(key, 0xFF, n_pix * sizeof(*key),
                                      stream);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    dim3 sgrid((T + 127) / 128, N);
    setup_kernel<<<sgrid, 128, 0, stream>>>(v_clip, tri, coef, rect, V, T, H,
                                            W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int warps = 8;
    dim3 rgrid((T + warps - 1) / warps, N);
    raster_kernel<<<rgrid, warps * 32, 0, stream>>>(coef, rect, px, py,
                                                    prev_z, prev_id, key, T,
                                                    H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    unpack_kernel<<<(unsigned)((n_pix + 255) / 256), 256, 0, stream>>>(
        key, z_out, tid_out, n_pix);
    return (int)cudaGetLastError();
}
