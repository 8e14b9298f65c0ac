// Per-ray any-hit walk of the three-level BVH (ops/bvh.py): supernode box,
// leaf box, sub-box, then the sub-box's G triangles, stopping at the first
// hit.  Shared by the trace + shade kernel (shade.cu) and the standalone
// tracer (trace.cu).
//
// The supernode and leaf boxes (S + C of them, 32 bytes each: 7.5 KB for
// the 26k-triangle spot mesh) are copied into dynamic shared memory when a
// block starts, as two float4 per box, so the scan over them costs no
// global loads; threads of a warp that test the same box read one address
// (a broadcast).  The sub-boxes (C*L/G, 79 KB at G = 8 for that mesh) are
// read through the read-only cache: one leaf's sub-boxes are 192
// contiguous bytes per bound.  A leaf of L triangles costs L/G sub-box
// tests and the rows of the sub-boxes entered, not all L rows.
//
// The slab test and the Plücker triangle test compute every quantity in the
// order of the plain version (ops/tracer.py: slab_hits, tri_hits), so with
// --fmad=false both give the same bits.  The slab uses IEEE 1/d and
// fminf/fmaxf, which drop the NaN of 0 * inf.  The plain version tests
// leaf and sub-box only: a supernode box holds its leaves' boxes and the
// float slab test is monotone in the box, so the supernode test removes
// nothing the leaf test keeps.
#pragma once

#include "common.cuh"

#define SUPER 8
#define WALK_BOX_BYTES 32   // shared memory per supernode or leaf box

// The structure one walk reads (ops/bvh.py LeafBVH): tri [C*L, 24],
// aabb_lo/hi [C, 3], super_lo/hi [S, 3], sub_lo/hi [C*L/G, 3].
struct Walk {
    const float* tri;
    const float* aabb_lo;
    const float* aabb_hi;
    const float* super_lo;
    const float* super_hi;
    const float* sub_lo;
    const float* sub_hi;
    int C, S, L, G;
};

__device__ __forceinline__ bool slab(V3 o, V3 inv, float4 lo, float4 hi,
                                     float tmin) {
    float tn = tmin, tf = __int_as_float(0x7f800000);  // +inf
    float t0 = (lo.x - o.x) * inv.x, t1 = (hi.x - o.x) * inv.x;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (lo.y - o.y) * inv.y;
    t1 = (hi.y - o.y) * inv.y;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (lo.z - o.z) * inv.z;
    t1 = (hi.z - o.z) * inv.z;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    return tf >= tn;
}

// Plücker any-hit against one triangle row (bvh.py layout).
__device__ __forceinline__ bool tri_hit(const float* __restrict__ r, V3 o,
                                        V3 d, V3 m, float tmin) {
    const float4* r4 = reinterpret_cast<const float4*>(r);
    float4 a = __ldg(r4 + 0), b = __ldg(r4 + 1), c = __ldg(r4 + 2),
           e = __ldg(r4 + 3), f = __ldg(r4 + 4), g = __ldg(r4 + 5);
    // a: V0x V0y V0z U0x | b: U0y U0z V1x V1y | c: V1z U1x U1y U1z
    // e: V2x V2y V2z U2x | f: U2y U2z nx ny   | g: nz np0 0 0
    float e0 = d.x * a.x + d.y * a.y + d.z * a.z + m.x * a.w + m.y * b.x
               + m.z * b.y;
    float e1 = d.x * b.z + d.y * b.w + d.z * c.x + m.x * c.y + m.y * c.z
               + m.z * c.w;
    float e2 = d.x * e.x + d.y * e.y + d.z * e.z + m.x * e.w + m.y * f.x
               + m.z * f.y;
    float num = g.y - (o.x * f.z + o.y * f.w + o.z * g.x);
    float den = d.x * f.z + d.y * f.w + d.z * g.x;
    num = num - tmin * den;
    bool same = (e0 * e1 >= 0.f) && (e1 * e2 >= 0.f) && (e0 * e2 >= 0.f);
    return same && (num * den > 0.f);
}

// Copy the supernode boxes, then the leaf boxes, into top [2 (S + C)]
// float4 (lo.xyz 0, hi.xyz 0).  Every thread of the block calls it before
// any thread walks, including threads without a ray.
__device__ __forceinline__ void load_top(float4* top, const Walk& w) {
    for (int i = threadIdx.x; i < w.S + w.C; i += blockDim.x) {
        const float* lo = i < w.S ? w.super_lo + 3 * i
                                  : w.aabb_lo + 3 * (i - w.S);
        const float* hi = i < w.S ? w.super_hi + 3 * i
                                  : w.aabb_hi + 3 * (i - w.S);
        top[2 * i] = make_float4(lo[0], lo[1], lo[2], 0.f);
        top[2 * i + 1] = make_float4(hi[0], hi[1], hi[2], 0.f);
    }
    __syncthreads();
}

__device__ __forceinline__ float4 ldg3(const float* p) {
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
}

static __device__ bool any_hit(V3 o, V3 d, const float4* __restrict__ top,
                               const Walk& w, float tmin) {
    V3 inv = mk3(1.f / d.x, 1.f / d.y, 1.f / d.z);
    V3 m = cross3(o, d);
    const int per_leaf = w.L / w.G;
    const float4* leaf = top + 2 * w.S;
    for (int sn = 0; sn < w.S; ++sn) {
        if (!slab(o, inv, top[2 * sn], top[2 * sn + 1], tmin)) continue;
        int c_end = min(sn * SUPER + SUPER, w.C);
        for (int c = sn * SUPER; c < c_end; ++c) {
            float4 lo = leaf[2 * c], hi = leaf[2 * c + 1];
            if (!(lo.x <= hi.x)) continue;  // empty leaf
            if (!slab(o, inv, lo, hi, tmin)) continue;
            for (int b = c * per_leaf; b < (c + 1) * per_leaf; ++b) {
                lo = ldg3(w.sub_lo + 3 * b);
                hi = ldg3(w.sub_hi + 3 * b);
                if (!(lo.x <= hi.x)) continue;  // empty sub-box
                if (!slab(o, inv, lo, hi, tmin)) continue;
                const float* rows = w.tri + (size_t)b * w.G * 24;
                for (int t = 0; t < w.G; ++t)
                    if (tri_hit(rows + t * 24, o, d, m, tmin)) return true;
            }
        }
    }
    return false;
}

// Launch-side: allow the kernel the dynamic shared memory of the walk's
// boxes (the wrapper has refused sizes past the card's 227 KB).
static inline cudaError_t walk_smem(const void* kernel, const Walk& w,
                                    size_t* bytes) {
    *bytes = (size_t)WALK_BOX_BYTES * (size_t)(w.S + w.C);
    if (*bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*bytes);
}
