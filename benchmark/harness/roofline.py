"""The least time of env_shade's forward, frozen from
nvdiffrecmc_tpu_torch/checks.py at commit 33f28f5: the H100 SXM's
published peaks (BYTES_PER_S, F32_PER_S), the operation counts per item
(SLAB_OPS, TRI_OPS, SAMPLE_OPS, SHADE_OPS), _bound_of, and trace_work's
count of the box and triangle tests that any walk of a structure needs.

What changed: the count reads only the call's public inputs (the covered
pixels' ray origins and shading normals, the strata, the light's tables,
the mesh's triangles), never the program's sample layout or BVH.  The
walk is counted against a structure the benchmark builds itself
(reference.port_plain's bvh.build at LEAF triangles a leaf), on SUBSET
rays drawn from a fixed seed at covered pixels, cosine-distributed about
the shading normal, and scaled to the call's 2 x strata x covered rays
(light and BSDF rays of every stratum).  So a change of the kernels, the
sample layout or the program's BVH leaves the count as it was.

Least bytes: each input read once (the covered pixels' G-buffer: ray
origin, position, normal, view, kd, ks; the mask; the light's base, pdf
and CDF tables; the triangles' corners) and the two demodulated outputs
written once.  Least operations: per (stratum, covered pixel) the
sampling of both lobes (SAMPLE_OPS) and the shading of both rays
(2 SHADE_OPS), and the walk's box and triangle tests."""

import math

import torch

BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SLAB_OPS = 25
TRI_OPS = 54
SAMPLE_OPS = 300
SHADE_OPS = 100
LEAF = 128
SUBSET = 8192
SUBSET_SEED = 0x600d


def bound_of(nbytes, ops):
    t_bytes = nbytes / BYTES_PER_S
    t_ops = ops / F32_PER_S
    return dict(bound_s=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bound_bytes=nbytes, bound_ops=ops)


def walk_tests(tracer, bvh_mod, ro, rd, bvh, tmin=0.0, chunk=1 << 10):
    """(slabs, tris): trace_work's count of the tests any walk of bvh
    needs on rays (ro, rd).  A ray that hits nothing tests every
    supernode box, the leaf boxes of the supernodes it enters, the
    sub-boxes of the leaves it enters and the triangles of the sub-boxes
    it enters; a ray that hits needs at least one box of each level and
    the triangle of one hit."""
    C, S = bvh.n_leaves, bvh.super_lo.shape[0]
    L, G = bvh.leaf_size, bvh.sub_size
    per_super = torch.clamp(C - bvh_mod.SUPER * torch.arange(
        S, device=ro.device), max=bvh_mod.SUPER).double()
    slabs = tris = 0
    for s in range(0, ro.shape[0], chunk):
        o, d = ro[s:s + chunk], rd[s:s + chunk]
        inv = 1.0 / d
        sup = tracer.slab_hits(o, inv, bvh.super_lo, bvh.super_hi, tmin)
        leaves = (tracer.slab_hits(o, inv, bvh.aabb_lo, bvh.aabb_hi, tmin)
                  & sup.repeat_interleave(bvh_mod.SUPER, 1)[:, :C])
        subs = tracer.entered(o, d, bvh, tmin)
        hit = tracer.any_hit(o, d, bvh, tmin)
        miss = ~hit
        n_hit = int(hit.sum())
        slabs += (int(miss.sum()) * S
                  + int((sup[miss].double() @ per_super).sum())
                  + int(leaves[miss].sum()) * (L // G) + 3 * n_hit)
        tris += int(subs[miss].sum()) * G + n_hit
    return slabs, tris


def cosine_dirs(nrm, gen):
    """Directions cosine-distributed about the unit normals nrm [R, 3]."""
    u = torch.rand((nrm.shape[0], 2), generator=gen, device=nrm.device,
                   dtype=torch.float64)
    r, phi = torch.sqrt(u[:, 0]), 2.0 * math.pi * u[:, 1]
    n = torch.nn.functional.normalize(nrm.double(), dim=-1)
    a = torch.where(n[:, 0:1].abs() > 0.9,
                    torch.tensor([0.0, 1.0, 0.0], device=n.device,
                                 dtype=torch.float64),
                    torch.tensor([1.0, 0.0, 0.0], device=n.device,
                                 dtype=torch.float64))
    t = torch.nn.functional.normalize(torch.linalg.cross(a, n), dim=-1)
    b = torch.linalg.cross(n, t)
    z = torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))
    d = (r * torch.cos(phi))[:, None] * t + (r * torch.sin(phi))[:, None] * b \
        + z[:, None] * n
    return d.float()


def env_shade_work(plain, call):
    """The least bytes and operations of one env_shade forward call.
    plain: the reference's frozen package (its bvh.build and tracer);
    call: mask [B,H,W], ro and gb_normal [B,H,W,3], the light's base
    shape (Hl, Wl), n_samples_x, and the mesh's v_pos [V,3], t_pos_idx
    [T,3] and tri_mask ([T] or None)."""
    m = call['mask'].reshape(-1) > 0
    covered = int(m.sum())
    P = m.numel()
    n2 = call['n_samples_x'] ** 2
    Hl, Wl = call['light_shape']
    v, f, tm = call['v_pos'], call['t_pos_idx'], call['tri_mask']
    T = int(f.shape[0] if tm is None else (tm > 0).sum())
    nbytes = (covered * 18 * 4 + P + Hl * Wl * (3 + 1 + 1) * 4 + Hl * 4
              + T * 9 * 4 + P * 6 * 4)
    ops = (SAMPLE_OPS + 2 * SHADE_OPS) * n2 * covered
    slabs = tris = 0
    if covered:
        bvh = plain.ops.bvh.build(v.detach().float(), f,
                                  tri_mask=None if tm is None else tm > 0,
                                  leaf_size=LEAF)
        gen = torch.Generator(device=v.device)
        gen.manual_seed(SUBSET_SEED)
        idx = torch.nonzero(m)[:, 0]
        pick = idx[torch.randint(0, idx.numel(), (min(SUBSET, covered),),
                                 generator=gen, device=v.device)]
        ro = call['ro'].reshape(-1, 3)[pick].float().contiguous()
        rd = cosine_dirs(call['nrm'].reshape(-1, 3)[pick], gen).contiguous()
        slabs, tris = walk_tests(plain.ops.tracer, plain.ops.bvh, ro, rd, bvh)
        scale = 2.0 * n2 * covered / pick.numel()
        slabs, tris = slabs * scale, tris * scale
        ops += SLAB_OPS * slabs + TRI_OPS * tris
    return dict(bound_of(nbytes, ops), covered=covered, walk_slabs=slabs,
                walk_tris=tris)
