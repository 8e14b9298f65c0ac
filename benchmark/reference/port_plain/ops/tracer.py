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

The JAX package's any_hit_counted (any_hit with a count of the (ray, leaf)
pairs dropped past its k_pairs cap) has no counterpart: any_hit here has
no cap and drops no pair, and the work the walk does is counted by
checks.trace_work.  any_hit_bruteforce is the independent O(R T) twin.
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


def any_hit_flat(ro, rd, bvh: LeafBVH, tmin=0.0, ray_chunk=None):
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


def slab_pairs(o, inv, lo, hi, tmin):
    """slab_hits of ray i against its own box i, [N]: the same floats in
    the same order, so the same bits."""
    tn = torch.full((o.shape[0],), float(tmin), device=o.device)
    tf = torch.full_like(tn, float('inf'))
    for ax in range(3):
        t0 = (lo[:, ax] - o[:, ax]) * inv[:, ax]
        t1 = (hi[:, ax] - o[:, ax]) * inv[:, ax]
        tn = torch.fmax(tn, torch.fmin(t0, t1))
        tf = torch.fmin(tf, torch.fmax(t0, t1))
    return (tf >= tn) & (lo[:, 0] <= hi[:, 0])


def _children(r, parent, fan, n_child):
    """(ray, child box) pairs of (ray, parent box) pairs, fan children a
    parent, children past n_child dropped."""
    child = (parent[:, None] * fan
             + torch.arange(fan, device=parent.device)).reshape(-1)
    rr = r[:, None].expand(-1, fan).reshape(-1)
    keep = child < n_child
    return rr[keep], child[keep]


def any_hit(ro, rd, bvh: LeafBVH, tmin=0.0, ray_chunk=None,
            pair_chunk=1 << 23):
    """any_hit_flat's answer by descent: each chunk of rays is slab-tested
    against the supernode boxes, the (ray, supernode) pairs that enter
    against their leaves, those against their sub-boxes, and the
    (ray, sub-box) pairs that enter test the sub-box's triangles.  A
    supernode box holds its leaves' boxes and a leaf's its sub-boxes, and
    the float slab test is monotone in the box, so the descent drops no
    pair that any_hit_flat tests: the same bits, at a cost that follows
    the boxes a ray enters instead of all of them."""
    from .bvh import SUPER
    R = ro.shape[0]
    G, L, C = bvh.sub_size, bvh.leaf_size, bvh.n_leaves
    S = bvh.super_lo.shape[0]
    rows = bvh.tri.reshape(-1, G, bvh.tri.shape[-1])
    if ray_chunk is None:
        ray_chunk = max(1, (1 << 26) // S)
    occ = torch.zeros(R, dtype=torch.bool, device=ro.device)
    for s in range(0, R, ray_chunk):
        o, d = ro[s:s + ray_chunk], rd[s:s + ray_chunk]
        inv = 1.0 / d
        hit = torch.zeros(o.shape[0], dtype=torch.bool, device=ro.device)
        r1, c1 = torch.nonzero(
            slab_hits(o, inv, bvh.super_lo, bvh.super_hi, tmin),
            as_tuple=True)
        for p in range(0, r1.numel(), pair_chunk // SUPER):
            r2, c2 = _children(r1[p:p + pair_chunk // SUPER],
                               c1[p:p + pair_chunk // SUPER], SUPER, C)
            k = slab_pairs(o[r2], inv[r2], bvh.aabb_lo[c2], bvh.aabb_hi[c2],
                           tmin)
            r2, c2 = r2[k], c2[k]
            fan = L // G
            for q in range(0, r2.numel(), max(1, pair_chunk // fan)):
                r3, c3 = _children(r2[q:q + pair_chunk // fan],
                                   c2[q:q + pair_chunk // fan], fan, C * fan)
                k = slab_pairs(o[r3], inv[r3], bvh.sub_lo[c3],
                               bvh.sub_hi[c3], tmin)
                r3, c3 = r3[k], c3[k]
                for t in range(0, r3.numel(), pair_chunk // G):
                    r_, c_ = r3[t:t + pair_chunk // G], c3[t:t + pair_chunk // G]
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


def any_hit_bruteforce(ro, rd, v0, v1, v2, tmin=1e-4, tmax=1e16):
    """Any-hit of every ray against every triangle (Moller-Trumbore, O(R T)
    memory), the independent twin for tests: rays [R, 3], triangle
    corners [T, 3] each -> bool [R]."""
    e1, e2 = v1 - v0, v2 - v0
    p = torch.linalg.cross(rd[:, None, :].expand(-1, e2.shape[0], -1),
                           e2[None].expand(rd.shape[0], -1, -1))
    det = torch.sum(e1[None] * p, -1)
    ok = torch.abs(det) > 1e-12
    det_safe = torch.where(ok, det, torch.full_like(det, 1e-12))
    tvec = ro[:, None, :] - v0[None]
    u = torch.sum(tvec * p, -1) / det_safe
    qv = torch.linalg.cross(tvec, e1[None].expand_as(tvec))
    v = torch.sum(rd[:, None, :] * qv, -1) / det_safe
    t = torch.sum(e2[None] * qv, -1) / det_safe
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin) & (t < tmax)
    return hit.any(-1)
