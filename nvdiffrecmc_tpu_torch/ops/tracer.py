"""Any-hit shadow-ray test against a LeafBVH, plain PyTorch (counterpart
of nvdiffrecmc_tpu/ops/tracer.py).

This is the tracer's plain version: rays are processed in chunks, each leaf
box is slab-tested against the whole chunk, and the rays that enter a leaf
(and have not hit yet) test its triangles.  The CUDA tracer inside
csrc/shade.cu walks the same boxes per ray (supernode, leaf, triangles) and
computes every quantity below in the same order, so both give the same bits.
"""

import torch

from .bvh import LeafBVH

BIG = 3e37


def slab_hits(o, inv, lo, hi, tmin):
    """[R, C] ray x box overlap for t in [tmin, inf).  inv = 1/d (IEEE, so
    +-inf for a zero component); fmin/fmax drop the NaN of 0*inf."""
    tn = torch.full((o.shape[0], lo.shape[0]), float(tmin), device=o.device)
    tf = torch.full_like(tn, float('inf'))
    for ax in range(3):
        t0 = (lo[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        t1 = (hi[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        tn = torch.fmax(tn, torch.fmin(t0, t1))
        tf = torch.fmin(tf, torch.fmax(t0, t1))
    return (tf >= tn) & (lo[None, :, 0] <= hi[None, :, 0])


def tri_hits(o, d, rows, tmin):
    """[R, L] Plücker any-hit of rays (o, d) [R, 3] against triangle rows
    [L, 24] (layout in bvh.py)."""
    m = torch.linalg.cross(o, d)

    def col(k):
        return rows[None, :, k]

    def dot3(a, k):
        return a[:, 0:1] * col(k) + a[:, 1:2] * col(k + 1) + a[:, 2:3] * col(k + 2)

    def edge(k):
        return (d[:, 0:1] * col(k) + d[:, 1:2] * col(k + 1)
                + d[:, 2:3] * col(k + 2) + m[:, 0:1] * col(k + 3)
                + m[:, 1:2] * col(k + 4) + m[:, 2:3] * col(k + 5))
    e0, e1, e2 = edge(0), edge(6), edge(12)
    num = col(21) - dot3(o, 18)
    den = dot3(d, 18)
    num = num - tmin * den
    same = (e0 * e1 >= 0.0) & (e1 * e2 >= 0.0) & (e0 * e2 >= 0.0)
    return same & (num * den > 0.0)


def any_hit(ro, rd, bvh: LeafBVH, tmin=0.0, ray_chunk=1 << 18):
    """Boolean occlusion [R] of rays (ro, rd) [R, 3] for t > tmin."""
    R = ro.shape[0]
    L = bvh.leaf_size
    occ = torch.zeros(R, dtype=torch.bool, device=ro.device)
    for s in range(0, R, ray_chunk):
        o, d = ro[s:s + ray_chunk], rd[s:s + ray_chunk]
        box = slab_hits(o, 1.0 / d, bvh.aabb_lo, bvh.aabb_hi, tmin)
        hit = torch.zeros(o.shape[0], dtype=torch.bool, device=ro.device)
        for c in range(bvh.n_leaves):
            idx = torch.nonzero(box[:, c] & ~hit)[:, 0]
            if idx.numel() == 0:
                continue
            h = tri_hits(o[idx], d[idx], bvh.tri[c * L:(c + 1) * L],
                         tmin).any(-1)
            hit[idx[h]] = True
        occ[s:s + ray_chunk] = hit
    return occ
