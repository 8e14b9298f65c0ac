"""Standalone any-hit tracing and the ray-block x leaf visit mask
(counterpart of nvdiffrecmc_tpu/ops/pallas_tracer.py).

Two kernels, each beside its plain PyTorch version:

- `any_hit_pallas` / `trace_rayf` (csrc/trace.cu; plain: tracer.any_hit):
  one thread per ray walks supernode -> leaf -> sub-box -> triangles and
  stops at the first hit.  The walk is csrc/trace.cuh, shared with the
  trace + shade kernel, and computes every quantity in the plain version's
  order, so both give the same bits.  It holds the supernode and leaf
  boxes in shared memory (`walk_smem_bytes`).
- `visit_masks` (csrc/mask.cu; plain: `visit_masks_plain`): per block of
  ray_block rays and per leaf, whether any ray of the block enters the
  leaf's box in [tmin, tmax], for any number of leaves and any ray_block.
  The kernel gives a warp to each leaf and a lane to each ray of a 32-ray
  step, stops a leaf at its first entering ray, and tests a run of equal
  rays (the disabled rays of masked pixels) once.  Its slab test follows
  the JAX package exactly: inv = 1/d where |d| > 1e-12, else 2e12; tmax is
  applied.  The tracer's cull keeps its own convention instead (IEEE 1/d,
  fmin/fmax, tracer.slab_hits).

The JAX package's block tactics (ray_block of the trace, visit lists,
`sort_rays`, the NVDR_LEAF_BATCH / NVDR_EARLY_EXIT loops) are TPU
scheduling and are not carried over.  Shadow rays are infinite, as the
reference's (tmax 1e16): the tracer takes no other tmax."""

import torch

from . import tracer
from .bvh import SMEM_MAX, WALK_BOX_BYTES, LeafBVH

BIG = 3e37
TMAX_INF = 1e16
_MASK_BUDGET = 1 << 24      # floats live per block group of the plain mask


def _check_tmax(tmax):
    if tmax < TMAX_INF:
        raise ValueError('shadow rays are infinite: tmax must be >= %g, got '
                         '%r' % (TMAX_INF, tmax))


def walk_smem_bytes(bvh: LeafBVH):
    """Dynamic shared memory of a block of the BVH walk (trace.cuh): the
    supernode and leaf boxes, 32 bytes each.  Raises past the 227 KB a
    block of the card can use: the walk has no path through global memory
    for them."""
    S, C = bvh.super_lo.shape[0], bvh.n_leaves
    n = WALK_BOX_BYTES * (S + C)
    if n > SMEM_MAX:
        raise ValueError('BVH walk: %d supernode and %d leaf boxes need %d '
                         'bytes of shared memory, past the %d a block can '
                         'use (build at bvh.leaf_size_for(T))'
                         % (S, C, n, SMEM_MAX))
    return n


def any_hit_pallas(ro, rd, bvh: LeafBVH, tmin=0.0, tmax=TMAX_INF):
    """Any-hit of rays (ro, rd) [R, 3] against bvh for t > tmin.  Returns
    bool [R]."""
    _check_tmax(tmax)
    return tracer.any_hit(ro, rd, bvh, tmin=tmin)


def trace_rayf(rayf, bvh: LeafBVH, tmin=0.0, tmax=TMAX_INF):
    """Any-hit on ray features [R, 16] (bvh.ray_features layout: d | m |
    o | 1 | 0...).  Returns bool [R]."""
    return any_hit_pallas(rayf[:, 6:9].contiguous(),
                          rayf[:, 0:3].contiguous(), bvh, tmin, tmax)


# ---------------------------------------------------------------------------
# Visit mask (kernel 9)
# ---------------------------------------------------------------------------

def _visit_hits(rayf, aabb_lo, aabb_hi, ray_block, tmin, tmax):
    """Yield, for each group of G consecutive ray blocks, whether each ray
    enters each leaf's box, bool [G, ray_block, C]: per-axis slab
    accumulation, groups bounded to ~2^24 floats."""
    Rp = rayf.shape[0]
    NB = Rp // ray_block
    C = aabb_lo.shape[0]
    o, d = rayf[:, 6:9], rayf[:, 0:3]
    inv = torch.where(torch.abs(d) > 1e-12,
                      1.0 / torch.where(d == 0.0, 1.0, d),
                      torch.full_like(d, 2e12))
    G = max(1, min(NB, _MASK_BUDGET // max(1, ray_block * C)))
    while NB % G:
        G -= 1
    for g0 in range(0, NB, G):
        og = o[g0 * ray_block:(g0 + G) * ray_block].reshape(G, ray_block, 3)
        ig = inv[g0 * ray_block:(g0 + G) * ray_block].reshape(G, ray_block, 3)
        tn = torch.full((G, ray_block, C), float(tmin), device=rayf.device)
        tf = torch.full((G, ray_block, C), float(tmax), device=rayf.device)
        for ax in range(3):
            t0 = (aabb_lo[None, None, :, ax] - og[:, :, None, ax]) \
                * ig[:, :, None, ax]
            t1 = (aabb_hi[None, None, :, ax] - og[:, :, None, ax]) \
                * ig[:, :, None, ax]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        yield tf >= tn


def visit_masks_plain(rayf, aabb_lo, aabb_hi, ray_block, tmin, tmax):
    """Plain PyTorch version of the mask kernel (the JAX package's
    visit_masks_od)."""
    return torch.cat([torch.any(h, dim=1).to(torch.int32) for h in
                      _visit_hits(rayf, aabb_lo, aabb_hi, ray_block, tmin,
                                  tmax)])


def visit_first_hits(rayf, aabb_lo, aabb_hi, ray_block, tmin, tmax):
    """[NB, C] int64: per block and leaf, the index within the block of the
    first ray that enters the leaf's box, ray_block where none does (the
    mask is first < ray_block)."""
    out = []
    for h in _visit_hits(rayf, aabb_lo, aabb_hi, ray_block, tmin, tmax):
        first = h.to(torch.uint8).argmax(dim=1)
        out.append(torch.where(h.any(dim=1), first, ray_block))
    return torch.cat(out)


def visit_masks(rayf, aabb_lo, aabb_hi, ray_block, tmin, tmax):
    """[NB, C] int32 visit masks of ray features [NB*ray_block, 16]
    against leaf boxes aabb_lo/hi [C, 3]: 1 where some ray of the block
    enters the box for t in [tmin, tmax]."""
    if rayf.shape[0] % ray_block:
        raise ValueError('visit_masks: %d rays are not a whole number of '
                         'blocks of %d' % (rayf.shape[0], ray_block))
    return visit_masks_plain(rayf, aabb_lo, aabb_hi, ray_block, tmin, tmax)
