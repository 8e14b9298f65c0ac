"""Ray-acceleration structure rebuilt every step (counterpart of
nvdiffrecmc_tpu/ops/bvh.py): triangles are Morton-sorted by centroid and
grouped into fixed-size leaves, with supernode AABBs over groups of SUPER
consecutive leaves.  The port adds a third level of its own: sub-boxes
over SUB consecutive triangles of each leaf (spatially compact, since the
triangles are Morton-sorted), so a per-ray walk tests SUB triangles per box
it enters instead of a whole leaf.  The fields the JAX package also has
(tri, aabb_*, super_*) are computed exactly as there.

Each triangle is stored as the Plücker columns of the JAX package's
intersection matrix.  With ray features d, m = o x d, o:

  e_i = d . V_i + m . U_i    (edge i = (a, b): U = b - a, V = a x b)
  num = n . p0 - n . o       (n = unnormalized face normal)
  den = n . d

  hit  <=>  e0, e1, e2 share a sign  AND  (num - tmin*den) * den > 0

so a degenerate or padded triangle (all zeros) never hits.  Row layout of
`tri` [C*L, TRI_STRIDE]: V0, U0, V1, U1, V2, U2, n (3 floats each), n.p0,
two zeros."""

import dataclasses
import math

import torch

from .. import tracing

SUPER = 8          # leaves per supernode
SUB = 8            # triangles per sub-box (at most; see build)
TRI_STRIDE = 24    # floats per triangle row
AABB_PAD = 1e-6    # relative AABB growth: culling stays conservative
LEAF_MIN = 128     # the smallest leaf size leaf_size_for picks
WALK_BOX_BYTES = 32    # the walk's shared memory per supernode or leaf box
SMEM_MAX = 232448      # the dynamic shared memory an H100 block can use


@dataclasses.dataclass
class LeafBVH:
    tri: torch.Tensor       # [C*L, 24] Plücker columns, leaf-major
    aabb_lo: torch.Tensor   # [C, 3]
    aabb_hi: torch.Tensor   # [C, 3]
    super_lo: torch.Tensor  # [S, 3]
    super_hi: torch.Tensor  # [S, 3]
    sub_lo: torch.Tensor    # [C*L/G, 3] boxes over G consecutive triangles
    sub_hi: torch.Tensor    # [C*L/G, 3]
    leaf_size: int
    sub_size: int           # G

    @property
    def n_leaves(self):
        return self.aabb_lo.shape[0]


def ray_features(o, d):
    """[R, 16] Plücker ray features [d, o x d, o, 1, 0...] of rays (o, d)
    [R, 3] (the JAX package's layout, read by pallas_tracer)."""
    R = o.shape[0]
    return torch.cat([d, torch.linalg.cross(o, d), o, o.new_ones((R, 1)),
                      o.new_zeros((R, 6))], dim=-1)


def _morton3(q):
    """Interleave 10-bit quantized coords [T, 3] into 30-bit Morton codes."""
    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x30000FF
        v = (v | (v << 8)) & 0x300F00F
        v = (v | (v << 4)) & 0x30C30C3
        v = (v | (v << 2)) & 0x9249249
        return v
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def tri_rows(v0, v1, v2, valid):
    """[T, 24] Plücker rows; invalid triangles are zero rows."""
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    cols = []
    for a, b in ((v0, v1), (v1, v2), (v2, v0)):
        cols += [torch.linalg.cross(a, b), b - a]
    np0 = torch.sum(n * v0, dim=-1, keepdim=True)
    rows = torch.cat(cols + [n, np0, torch.zeros_like(n[:, :2])], dim=-1)
    return rows * valid[:, None]


def walk_boxes(n_tris, leaf_size):
    """Supernode and leaf boxes, S + C, of a structure over n_tris
    triangle slots at leaf_size."""
    C = -(-n_tris // leaf_size)
    return -(-C // SUPER) + C


def leaf_size_for(n_tris):
    """The leaf size of a structure over n_tris triangle slots: the
    smallest power of two >= LEAF_MIN whose supernode and leaf boxes fit
    the walk's shared memory (trace.cuh), 128 up to 826,368 slots and 256
    up to 1,652,736."""
    L = LEAF_MIN
    while WALK_BOX_BYTES * walk_boxes(n_tris, L) > SMEM_MAX:
        L *= 2
    return L


def build(v_pos, tri, tri_mask=None, leaf_size=None):
    """Build the structure on v_pos's device, at leaf_size or, when None,
    at leaf_size_for(T).  C = ceil(T/L) leaves,
    S = ceil(C/SUPER) supernodes, C*L/G sub-boxes of G = gcd(SUB, L)
    triangles (SUB for the power-of-two leaves used, min(SUB, L) below it);
    invalid and degenerate triangles sort to the end and are zeroed; empty
    leaves and sub-boxes get an empty (lo > hi) box.  Every box grows by
    the same AABB_PAD of the scene extent, so a sub-box lies inside its
    leaf's box and a ray's float slab test never enters a sub-box without
    entering its leaf."""
    with tracing.span('geometry.bvh'):
        v_pos = v_pos.detach()
        T = tri.shape[0]
        L = leaf_size or leaf_size_for(T)
        t = tri.long()
        v0, v1, v2 = v_pos[t[:, 0]], v_pos[t[:, 1]], v_pos[t[:, 2]]
        valid = (torch.ones(T, dtype=torch.bool, device=v_pos.device)
                 if tri_mask is None else tri_mask.bool())
        area2 = torch.sum(torch.linalg.cross(v1 - v0, v2 - v0) ** 2, dim=-1)
        valid = valid & (area2 > 0.0)

        centroid = (v0 + v1 + v2) / 3.0
        big = 3e37
        cmin = torch.where(valid[:, None], centroid, big).amin(0)
        cmax = torch.where(valid[:, None], centroid, -big).amax(0)
        scale = torch.where(cmax > cmin, 1023.0 / (cmax - cmin),
                            torch.zeros_like(cmin))
        q = torch.clamp((centroid - cmin) * scale, 0, 1023).to(torch.int64)
        key = torch.where(valid, _morton3(q),
                          torch.full_like(q[:, 0], 1 << 40))
        order = torch.argsort(key, stable=True)
        v0, v1, v2, valid = v0[order], v1[order], v2[order], valid[order]

        pad = (-T) % L
        if pad:
            z = v0.new_zeros((pad, 3))
            v0, v1, v2 = (torch.cat([v, z]) for v in (v0, v1, v2))
            valid = torch.cat([valid, valid.new_zeros(pad)])
        C = (T + pad) // L
        G = math.gcd(SUB, L)
        rows = tri_rows(v0, v1, v2, valid.float())

        # sub-box extents first; a leaf's extent is the min/max of its
        # sub-boxes', the same floats as over its points
        pts = torch.stack([v0, v1, v2], dim=1).reshape(C * L // G, G * 3, 3)
        mk = valid.reshape(-1, G).repeat_interleave(3, dim=1)[..., None]
        sub_lo = torch.where(mk, pts, big).amin(1)
        sub_hi = torch.where(mk, pts, -big).amax(1)
        lo = sub_lo.reshape(C, L // G, 3).amin(1)
        hi = sub_hi.reshape(C, L // G, 3).amax(1)
        occupied = valid.reshape(C, L).any(1, keepdim=True)
        extent = torch.where(occupied, torch.maximum(lo.abs(), hi.abs()), 0.0)
        grow = AABB_PAD * extent.amax()
        lo = torch.where(occupied, lo - grow, lo)
        hi = torch.where(occupied, hi + grow, hi)
        sub_occupied = mk.any(1)
        sub_lo = torch.where(sub_occupied, sub_lo - grow, sub_lo)
        sub_hi = torch.where(sub_occupied, sub_hi + grow, sub_hi)

        spad = (-C) % SUPER
        lo_p = torch.cat([lo, lo.new_full((spad, 3), big)]) if spad else lo
        hi_p = torch.cat([hi, hi.new_full((spad, 3), -big)]) if spad else hi
        S = (C + spad) // SUPER
        return LeafBVH(tri=rows.contiguous(), aabb_lo=lo.contiguous(),
                       aabb_hi=hi.contiguous(),
                       super_lo=lo_p.reshape(S, SUPER, 3).amin(1).contiguous(),
                       super_hi=hi_p.reshape(S, SUPER, 3).amax(1).contiguous(),
                       sub_lo=sub_lo.contiguous(), sub_hi=sub_hi.contiguous(),
                       leaf_size=L, sub_size=G)
