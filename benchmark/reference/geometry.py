"""The reference's geometry, written from upstream nvdiffrecmc's
geometry/dmtet.py and render/mesh.py and independent of the program's
code: smooth normals and tangents of a mesh, the Kuhn tet grid, marching
tetrahedra over it with its per-tet UV atlas, and the SDF's sign
regularizer.

The marching tets follow upstream's dense form: the sign-crossing edges
of the valid tets, made unique (in (a, b) order), one vertex on each by
the zero crossing, and the faces of the one-triangle tets first, then
the two triangles of each two-triangle tet.  The mesh is as large as its
surface: no fixed buffer and no mask."""

import dataclasses
from typing import Any

import numpy as np
import torch

# upstream dmtet.py's tables: the local edges of a tet's sign case, and
# how many triangles it makes
TRIANGLES = [
    [-1, -1, -1, -1, -1, -1], [1, 0, 2, -1, -1, -1], [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4], [3, 1, 5, -1, -1, -1], [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4], [4, 2, 5, -1, -1, -1], [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1], [3, 2, 0, 3, 5, 2], [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1], [3, 0, 4, -1, -1, -1], [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1]]
N_TRIANGLES = [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0]
TET_EDGES = [0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3]


@dataclasses.dataclass
class Mesh:
    """What the renderer reads of a mesh: positions, normals, tangents
    and texture coordinates with their index arrays, and the material."""
    v_pos: Any
    t_pos_idx: Any
    v_tex: Any
    t_tex_idx: Any
    material: Any
    v_nrm: Any = None
    t_nrm_idx: Any = None
    v_tng: Any = None
    t_tng_idx: Any = None
    tri_mask: Any = None


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _normalize(x):
    return x / torch.sqrt(torch.clamp(_dot(x, x), min=1e-20))


def with_normals_and_tangents(v_pos, t_pos_idx, v_tex, t_tex_idx,
                              material):
    """The mesh with upstream's auto_normals (area-weighted face normals
    summed at the vertices) and compute_tangents (each face's tangent from
    its UV edges, averaged at the vertices and made orthogonal to the
    normal)."""
    t = t_pos_idx.long()
    p0, p1, p2 = v_pos[t[:, 0]], v_pos[t[:, 1]], v_pos[t[:, 2]]
    fn = torch.linalg.cross(p1 - p0, p2 - p0)
    nrm = torch.zeros_like(v_pos)
    for i in range(3):
        nrm = nrm.index_add(0, t[:, i], fn)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=v_pos.dtype,
                      device=v_pos.device)
    nrm = _normalize(torch.where(_dot(nrm, nrm) > 1e-20, nrm, up))

    tt = t_tex_idx.long()
    u0, u1, u2 = v_tex[tt[:, 0]], v_tex[tt[:, 1]], v_tex[tt[:, 2]]
    du1, du2 = u1 - u0, u2 - u0
    num = (p1 - p0) * du2[:, 1:2] - (p2 - p0) * du1[:, 1:2]
    den = du1[:, 0:1] * du2[:, 1:2] - du1[:, 1:2] * du2[:, 0:1]
    den = torch.where(den > 0.0, torch.clamp(den, min=1e-6),
                      torch.clamp(den, max=-1e-6))
    tang = num / den
    tng = torch.zeros_like(nrm)
    count = torch.zeros_like(nrm)
    for i in range(3):
        tng = tng.index_add(0, t[:, i], tang)
        count = count.index_add(0, t[:, i], torch.ones_like(tang))
    tng = _normalize(tng / torch.clamp(count, min=1.0))
    tng = _normalize(tng - _dot(tng, nrm) * nrm)
    return Mesh(v_pos=v_pos, t_pos_idx=t_pos_idx, v_tex=v_tex,
                t_tex_idx=t_tex_idx, material=material, v_nrm=nrm,
                t_nrm_idx=t_pos_idx, v_tng=tng, t_tng_idx=t_pos_idx)


def kuhn_grid(res, scale, device):
    """The grid of res^3 cubes over [-scale/2, scale/2]^3, each cut into
    the six tets that share its diagonal from corner (0, 0, 0) to (1, 1,
    1), every tet ordered to a positive volume.  Returns (verts
    [(res+1)^3, 3], tets [6 res^3, 4] int64)."""
    n = res + 1
    ax = torch.linspace(-0.5, 0.5, n, device=device)
    verts = torch.stack(torch.meshgrid(ax, ax, ax, indexing='ij'),
                        -1).reshape(-1, 3) * scale
    base = torch.arange(res, device=device)
    i, j, k = (x.reshape(-1) for x in torch.meshgrid(base, base, base,
                                                     indexing='ij'))

    def corner(dx, dy, dz):
        return ((i + dx) * n + (j + dy)) * n + (k + dz)
    unit = np.eye(3, dtype=np.int64)
    tets = []
    for axes in ([0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1],
                 [2, 1, 0]):
        a = unit[axes[0]]
        b = a + unit[axes[1]]
        # the tet (0, a, a + b, 1): positive where (a, b, c) is an even
        # permutation of (x, y, z)
        if np.linalg.det(np.stack([a, b, np.ones(3)])) < 0:
            a, b = b, a
        tets.append(torch.stack([corner(0, 0, 0), corner(*a), corner(*b),
                                 corner(1, 1, 1)], -1))
    return verts, torch.cat(tets)


def _unique_pairs(e, n_verts):
    """The distinct rows of e [N, 2] (each sorted, smaller vertex first)
    in (a, b) order and each row's index among them: one key a * n + b a
    row, which is faster on the card than torch.unique over rows."""
    e = torch.sort(e, dim=1).values
    keys, inv = torch.unique(e[:, 0] * n_verts + e[:, 1],
                             return_inverse=True)
    return torch.stack([keys // n_verts, keys % n_verts], 1), inv


def unique_edges(tets, n_verts):
    """The grid's edges [E, 2] (smaller vertex first), each once."""
    return _unique_pairs(tets[:, TET_EDGES].reshape(-1, 2), n_verts)[0]


def marching_tets(pos, sdf, tets):
    """Upstream's marching tets: (verts [V, 3], faces [F, 3] int64,
    uvs [4 N^2, 2], uv_idx [F, 3]), differentiable in pos and sdf."""
    dev = sdf.device
    with torch.no_grad():
        inside = sdf > 0
        occ = inside[tets]                                      # [Nt, 4]
        n_in = occ.sum(-1)
        valid = (n_in > 0) & (n_in < 4)
        uniq, inv = _unique_pairs(tets[valid][:, TET_EDGES].reshape(-1, 2),
                                  pos.shape[0])
        crossing = inside[uniq].sum(-1) == 1
        slot = torch.full((uniq.shape[0],), -1, dtype=torch.long,
                          device=dev)
        slot[crossing] = torch.arange(int(crossing.sum()), device=dev)
        edge_vert = slot[inv].reshape(-1, 6)
        ends = uniq[crossing]
    s = sdf[ends]                                               # [V, 2]
    p = pos[ends]                                               # [V, 2, 3]
    w = torch.stack([-s[:, 1], s[:, 0]], -1) / (s[:, 0] - s[:, 1])[:, None]
    verts = (p * w[..., None]).sum(1)

    case = (occ[valid].long()
            * torch.tensor([1, 2, 4, 8], device=dev)).sum(-1)
    table = torch.tensor(TRIANGLES, device=dev)
    count = torch.tensor(N_TRIANGLES, device=dev)[case]
    one, two = count == 1, count == 2
    faces = torch.cat([
        torch.gather(edge_vert[one], 1, table[case[one]][:, :3]),
        torch.gather(edge_vert[two], 1, table[case[two]]).reshape(-1, 3)])
    tet_id = torch.arange(tets.shape[0], device=dev)[valid]
    face_id = torch.cat([tet_id[one] * 2, torch.stack(
        [tet_id[two] * 2, tet_id[two] * 2 + 1], -1).reshape(-1)])
    uvs, uv_idx = _uv_atlas(face_id, tets.shape[0], dev)
    return verts, faces, uvs, uv_idx


def _uv_atlas(face_id, n_tets, dev):
    """Upstream's map_uv: tet t owns cell (t // N, t % N) of an N x N
    grid of padded quads, its first triangle the quad's corners 0, 1, 2,
    its second 0, 2, 3."""
    N = int(np.ceil(np.sqrt((n_tets * 2 + 1) // 2)))
    lin = torch.linspace(0, 1 - 1 / N, N, device=dev)
    ty, tx = torch.meshgrid(lin, lin, indexing='ij')
    pad = 0.9 / N
    uvs = torch.stack([tx, ty, tx + pad, ty, tx + pad, ty + pad, tx,
                       ty + pad], -1).reshape(-1, 2)
    tet = face_id // 2
    tri = face_id % 2
    cell = (tet // N) * N + tet % N
    uv_idx = torch.stack([cell * 4, cell * 4 + tri + 1, cell * 4 + tri + 2],
                         -1)
    return uvs, uv_idx


def sdf_sign_loss(sdf, edges):
    """Upstream's sdf_reg_loss: over the edges whose ends' SDFs differ in
    sign, the binary cross-entropy of each end's SDF as a logit against
    the other end's side."""
    s = sdf[edges]
    s = s[torch.sign(s[:, 0]) != torch.sign(s[:, 1])]
    bce = torch.nn.functional.binary_cross_entropy_with_logits
    return (bce(s[:, 0], (s[:, 1] > 0).float())
            + bce(s[:, 1], (s[:, 0] > 0).float()))
