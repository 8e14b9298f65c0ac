// Per-ray any-hit walk of the two-level BVH (ops/bvh.py): supernode box,
// leaf box, then the leaf's triangles, stopping at the first hit.  Shared by
// the trace + shade kernel (shade.cu) and the standalone tracer (trace.cu).
//
// The slab test and the Plücker triangle test compute every quantity in the
// order of the plain version (ops/tracer.py: slab_hits, tri_hits), so with
// --fmad=false both give the same bits.  The slab uses IEEE 1/d and
// fminf/fmaxf, which drop the NaN of 0 * inf.
#pragma once

#include "common.cuh"

#define SUPER 8

__device__ __forceinline__ bool slab(V3 o, V3 inv, const float* __restrict__ lo,
                                     const float* __restrict__ hi, float tmin) {
    float tn = tmin, tf = __int_as_float(0x7f800000);  // +inf
    float t0 = (lo[0] - o.x) * inv.x, t1 = (hi[0] - o.x) * inv.x;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (lo[1] - o.y) * inv.y;
    t1 = (hi[1] - o.y) * inv.y;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (lo[2] - o.z) * inv.z;
    t1 = (hi[2] - o.z) * inv.z;
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

static __device__ bool any_hit(V3 o, V3 d, const float* __restrict__ tri,
                               const float* __restrict__ alo,
                               const float* __restrict__ ahi,
                               const float* __restrict__ slo,
                               const float* __restrict__ shi, int C, int S,
                               int L, float tmin) {
    V3 inv = mk3(1.f / d.x, 1.f / d.y, 1.f / d.z);
    V3 m = cross3(o, d);
    for (int sn = 0; sn < S; ++sn) {
        if (!slab(o, inv, slo + 3 * sn, shi + 3 * sn, tmin)) continue;
        int c_end = min(sn * SUPER + SUPER, C);
        for (int c = sn * SUPER; c < c_end; ++c) {
            const float* lo = alo + 3 * c;
            const float* hi = ahi + 3 * c;
            if (!(lo[0] <= hi[0])) continue;  // empty leaf
            if (!slab(o, inv, lo, hi, tmin)) continue;
            const float* rows = tri + (size_t)c * L * 24;
            for (int t = 0; t < L; ++t)
                if (tri_hit(rows + t * 24, o, d, m, tmin)) return true;
        }
    }
    return false;
}
