"""Mesh attribute computation: face normals, smooth vertex normals,
mikktspace-style tangents (counterpart of nvdiffrecmc_tpu/ops/mesh_ops.py).
Scatter-adds use index_add_; invalid (masked) triangles contribute nothing."""

import torch

from .vecmath import dot, safe_normalize


def face_normals(v_pos, t_pos_idx, normalize=True):
    """[T, 3] face normals (optionally unnormalized cross products)."""
    t = t_pos_idx.long()
    v0, v1, v2 = v_pos[t[:, 0]], v_pos[t[:, 1]], v_pos[t[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    return safe_normalize(fn) if normalize else fn


def auto_normals(v_pos, t_pos_idx, tri_mask=None):
    """Area-weighted smooth vertex normals [V, 3]."""
    fn = face_normals(v_pos, t_pos_idx, normalize=False)
    if tri_mask is not None:
        fn = fn * tri_mask[:, None]
    t = t_pos_idx.long()
    v_nrm = torch.zeros_like(v_pos)
    for i in range(3):
        v_nrm.index_add_(0, t[:, i], fn)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=v_pos.dtype,
                            device=v_pos.device)
    v_nrm = torch.where(dot(v_nrm, v_nrm) > 1e-20, v_nrm, fallback)
    return safe_normalize(v_nrm)


def compute_tangents(v_pos, v_nrm, v_tex, t_pos_idx, t_nrm_idx, t_tex_idx,
                     tri_mask=None):
    """Per-vertex tangents [Vn, 3] indexed by t_nrm_idx."""
    tp, tt = t_pos_idx.long(), t_tex_idx.long()
    pos = [v_pos[tp[:, i]] for i in range(3)]
    tex = [v_tex[tt[:, i]] for i in range(3)]

    uve1 = tex[1] - tex[0]
    uve2 = tex[2] - tex[0]
    pe1 = pos[1] - pos[0]
    pe2 = pos[2] - pos[0]

    nom = pe1 * uve2[..., 1:2] - pe2 * uve1[..., 1:2]
    denom = uve1[..., 0:1] * uve2[..., 1:2] - uve1[..., 1:2] * uve2[..., 0:1]
    tang = nom / torch.where(denom > 0.0, torch.clamp(denom, min=1e-6),
                             torch.clamp(denom, max=-1e-6))
    if tri_mask is not None:
        tang = tang * tri_mask[:, None]

    tangents = torch.zeros_like(v_nrm)
    tansum = torch.zeros_like(v_nrm)
    w = (torch.ones_like(tang) if tri_mask is None
         else tri_mask[:, None].expand_as(tang).contiguous())
    tn = t_nrm_idx.long()
    for i in range(3):
        tangents.index_add_(0, tn[:, i], tang)
        tansum.index_add_(0, tn[:, i], w)
    tangents = tangents / torch.clamp(tansum, min=1.0)

    tangents = safe_normalize(tangents)
    tangents = safe_normalize(tangents - dot(tangents, v_nrm) * v_nrm)
    bad = dot(tangents, tangents) < 0.5
    up = torch.tensor([0.0, 1.0, 0.001], dtype=v_nrm.dtype,
                      device=v_nrm.device).expand_as(v_nrm)
    fallback = safe_normalize(torch.linalg.cross(v_nrm, up))
    return torch.where(bad, fallback, tangents)


def laplace_uniform(v_pos, t_pos_idx, tri_mask=None):
    """Uniform (umbrella) Laplacian residual per vertex, mean squared."""
    t = t_pos_idx.long()
    v0, v1, v2 = v_pos[t[:, 0]], v_pos[t[:, 1]], v_pos[t[:, 2]]
    contrib = [(v1 - v0) + (v2 - v0), (v0 - v1) + (v2 - v1),
               (v0 - v2) + (v1 - v2)]
    if tri_mask is not None:
        contrib = [c * tri_mask[:, None] for c in contrib]
        wgt = tri_mask[:, None] * 2.0
    else:
        wgt = torch.full((t.shape[0], 1), 2.0, dtype=v_pos.dtype,
                         device=v_pos.device)
    term = torch.zeros_like(v_pos)
    norm = torch.zeros_like(v_pos[:, :1])
    for i in range(3):
        term = term.index_add(0, t[:, i], contrib[i])
        norm = norm.index_add(0, t[:, i], wgt)
    term = term / torch.clamp(norm, min=1.0)
    return torch.mean(term ** 2)
