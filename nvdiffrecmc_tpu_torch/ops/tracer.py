"""Any-hit shadow-ray test against a LeafBVH, plain PyTorch (counterpart
of nvdiffrecmc_tpu/ops/tracer.py).

This is the tracer's plain version: rays are processed in chunks, each leaf
box and each sub-box is slab-tested against the whole chunk, and every
(ray, sub-box) pair that enters both its leaf and the sub-box tests the
sub-box's triangles.  The CUDA walk (csrc/trace.cuh, inside the trace +
shade kernel and the standalone tracer) tests supernode, leaf and sub-box
per ray, then the triangles, and computes every quantity below in the
same order, so both give the same bits: a supernode box holds its leaves'
boxes and the float slab test is monotone in the box, so a ray that enters
a leaf enters its supernode, and the walk's extra test removes nothing.
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


def cross(a, b):
    """a x b [R, 3], each product and difference its own rounding, as the
    walk's cross3 computes it under --fmad=false (torch.linalg.cross on
    the card may fuse a product into the difference)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def tri_hits(o, d, rows, tmin):
    """Plücker any-hit of rays (o, d) [R, 3] against triangle rows (layout
    in bvh.py): rows [L, 24] gives [R, L] (every ray against every row),
    rows [R, L, 24] gives [R, L] (ray i against its own L rows)."""
    m = cross(o, d)

    def col(k):
        return rows[..., k]

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


def entered(o, d, bvh: LeafBVH, tmin):
    """[R, C*L/G] bool: the ray enters the sub-box and its leaf's box."""
    inv = 1.0 / d
    leaf = slab_hits(o, inv, bvh.aabb_lo, bvh.aabb_hi, tmin)
    per_leaf = bvh.leaf_size // bvh.sub_size
    return (slab_hits(o, inv, bvh.sub_lo, bvh.sub_hi, tmin)
            & leaf.repeat_interleave(per_leaf, dim=1))


def any_hit(ro, rd, bvh: LeafBVH, tmin=0.0, ray_chunk=None):
    """Boolean occlusion [R] of rays (ro, rd) [R, 3] for t > tmin.  Each
    chunk of rays is slab-tested against every leaf box and sub-box
    (ray_chunk rays; by default as many as keep the [rays, sub-boxes]
    temporaries at 2^24 entries on the CPU, 2^26 on a card); the (ray,
    sub-box) pairs that enter test the sub-box's triangles in batches of
    at most 2^24 gathered floats on the CPU, 2^27 on a card."""
    R = ro.shape[0]
    G = bvh.sub_size
    rows = bvh.tri.reshape(-1, G, bvh.tri.shape[-1])
    if ray_chunk is None:
        ray_chunk = max(1, (1 << (26 if ro.is_cuda else 24)) // rows.shape[0])
    pair_chunk = max(1, (1 << (27 if ro.is_cuda else 24))
                     // (G * rows.shape[-1]))
    occ = torch.zeros(R, dtype=torch.bool, device=ro.device)
    for s in range(0, R, ray_chunk):
        o, d = ro[s:s + ray_chunk], rd[s:s + ray_chunk]
        pr, pc = torch.nonzero(entered(o, d, bvh, tmin), as_tuple=True)
        hit = torch.zeros(o.shape[0], dtype=torch.bool, device=ro.device)
        for p in range(0, pr.numel(), pair_chunk):
            r_, c_ = pr[p:p + pair_chunk], pc[p:p + pair_chunk]
            h = tri_hits(o[r_], d[r_], rows[c_], tmin).any(-1)
            hit[r_[h]] = True
        occ[s:s + ray_chunk] = hit
    return occ


def make_occlusion_fn():
    """occ(ro, rd, bvh) -> bool [R] through pallas_tracer.any_hit_pallas
    (t > 0), on detached rays: visibility is binary and carries no
    gradient, as the JAX package's explicit zero VJP and the reference
    (kernel.cu:96-99).  A CPU tensor takes the plain version inside
    any_hit_pallas."""

    def occlusion(ro, rd, bvh):
        from .pallas_tracer import any_hit_pallas
        return any_hit_pallas(ro.detach().contiguous(),
                              rd.detach().contiguous(), bvh)
    return occlusion
