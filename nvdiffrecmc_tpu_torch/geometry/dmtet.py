"""Differentiable marching tetrahedra with fixed buffers, and the DMTet
geometry of pass 1 (counterpart of nvdiffrecmc_tpu/geometry/dmtet.py).

The surface of the SDF's zero level set is extracted into buffers of a
fixed size: every sign-crossing unique edge of the tet grid gets a vertex
slot in edge order, and the triangles go slot-major (the first triangle of
every tet, then the second) into `max_tris` slots, faces (0, 0, 0) with
`tri_mask` 0 past the live count.  Both compactions take their positions
from a cumsum and scatter into the fixed buffer, so nothing waits for the
host.  Vertices are differentiable in the SDF and the deformation (the
zero-crossing interpolation of the reference).  The JAX package's
transposed [k, huge] layouts and its constant binding are XLA tactics:
here every grid tensor is [huge, k] on one device.

The tet grid comes from data/tets/<r>_tets.npz under FLAGS['data_root']
when present, else the Kuhn grid is built in memory; the unique-edge table
is built on the device (the unique of a * Nv + b, the order of
np.unique(axis=0)).  Nothing is written to disk."""

import os

import numpy as np
import torch

from .. import tracing
from ..device import constant, resolve
from ..ops import bvh as bvh_mod
from ..ops.vecmath import abs_pos0, maximum_split
from ..render import mesh as mesh_mod
from ..render import regularizer
from ..render import render as render_mod

# marching-tets tables (reference dmtet.py:21-42)
TRIANGLE_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1],
], dtype=np.int32)

NUM_TRIANGLES_TABLE = np.array([0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0],
                               dtype=np.int32)
BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3], dtype=np.int32)


def kuhn_tet_grid(res):
    """The Kuhn tet grid: res^3 cube cells of 6 positively oriented tets
    each, vertices in [-0.5, 0.5]^3.  Returns (verts [(res+1)^3, 3]
    float32, indices [6 res^3, 4] int32), numpy."""
    r = res
    xs = np.linspace(-0.5, 0.5, r + 1, dtype=np.float32)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing='ij')
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    def vid(i, j, k):
        return (i * (r + 1) + j) * (r + 1) + k

    ii, jj, kk = np.meshgrid(np.arange(r), np.arange(r), np.arange(r),
                             indexing='ij')
    c = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    corners = np.stack([vid(c[:, 0] + dx, c[:, 1] + dy, c[:, 2] + dz)
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                       axis=-1)  # order: x*4 + y*2 + z
    # one tet per axis permutation along the diagonal 0 -> 7; odd
    # permutations swap two vertices so that every tet is positive
    paths = [(4, 6, False), (4, 5, True), (2, 6, True),
             (2, 3, False), (1, 5, False), (1, 3, True)]
    tets = []
    for a, b, flip in paths:
        if flip:
            a, b = b, a
        tets.append(np.stack([corners[:, 0], corners[:, a], corners[:, b],
                              corners[:, 7]], axis=-1))
    idx = np.concatenate(tets, axis=0).astype(np.int32)
    return verts, idx


def edge_tables(indices, n_verts):
    """The unique undirected edges of the tet grid, [E, 2] int64 (a < b,
    in np.unique(axis=0)'s order), and each tet's map from its 6 local
    edges to them, [Nt, 6] int64; on indices' device."""
    t = indices.long()
    e = t[:, torch.as_tensor(BASE_TET_EDGES, device=t.device).long()]
    e = e.reshape(-1, 2)
    a = torch.minimum(e[:, 0], e[:, 1])
    b = torch.maximum(e[:, 0], e[:, 1])
    uniq, inv = torch.unique(a * n_verts + b, return_inverse=True)
    return (torch.stack([uniq // n_verts, uniq % n_verts], dim=1),
            inv.reshape(-1, 6))


def map_uv_tables(num_tets):
    """The static per-tet UV atlas (reference dmtet.py:54-82): each tet owns
    a cell of an N x N chart grid holding a padded quad.  Returns (uvs
    [4 N^2, 2] float32 numpy, N)."""
    N = int(np.ceil(np.sqrt((num_tets * 2 + 1) // 2)))
    tex_y, tex_x = np.meshgrid(
        np.linspace(0, 1 - (1 / N), N, dtype=np.float32),
        np.linspace(0, 1 - (1 / N), N, dtype=np.float32), indexing='ij')
    pad = 0.9 / N
    uvs = np.stack([
        tex_x, tex_y,
        tex_x + pad, tex_y,
        tex_x + pad, tex_y + pad,
        tex_x, tex_y + pad,
    ], axis=-1).reshape(-1, 2).astype(np.float32)
    return uvs, N


def _compact(valid, size, fill):
    """The indices of valid's true entries in order, in a buffer of size
    entries (those past the count are fill, those past size dropped), and
    the count: JAX's nonzero(size=, fill_value=) by a cumsum and a
    scatter."""
    n = valid.shape[0]
    pos = torch.cumsum(valid.long(), 0) - 1
    slot = torch.where(valid & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64,
                     device=valid.device)
    out.scatter_(0, slot, torch.arange(n, device=valid.device))
    return out[:size], pos


def tet_index(sdf, indices):
    """Each tet's marching-tets case [Nt] (bit i: vertex i inside)."""
    occ = (sdf > 0).long()[indices.long()]                     # [Nt, 4]
    w = constant((1, 2, 4, 8), torch.int64, sdf.device)
    return (occ * w).sum(1)


def marching_tets(v_deformed, sdf, tet_idx, edge_uniq, edge_map, max_tris,
                  max_verts=None):
    """The zero-level-set mesh in fixed buffers.

    v_deformed [Nv, 3], sdf [Nv], tet_idx [Nt, 4], edge_uniq [E, 2],
    edge_map [Nt, 6].  Returns (verts [max_verts, 3]: one per sign-crossing
    edge in edge order, the midpoint of edge 0 past the count; faces
    [max_tris, 3] int32 into verts; face_gidx [max_tris] int32, slot-major
    (tet = gidx % Nt, its triangle = gidx // Nt); tri_mask [max_tris]
    float32; overflow, a bool tensor: true when either buffer truncated).
    max_verts defaults to max_tris; max_tris None sizes both buffers to
    the surface's triangles and sign-crossing edges (one host sync), so
    nothing is truncated."""
    dev = sdf.device
    Nt = tet_idx.shape[0]
    occ = sdf > 0
    tetindex = tet_index(sdf, tet_idx)

    e0, e1 = edge_uniq[:, 0], edge_uniq[:, 1]
    active_edge = occ[e0] != occ[e1]
    n_active = torch.sum(active_edge.long())
    ntt = constant(NUM_TRIANGLES_TABLE, torch.int64, dev)
    n_tri = ntt[tetindex]
    flat_valid = torch.cat([n_tri >= 1, n_tri >= 2])           # [2 Nt]
    n_flat = torch.sum(flat_valid.long())
    if max_tris is None:
        max_tris, max_verts = (max(n, 1) for n in
                               torch.stack([n_flat, n_active]).tolist())
    elif max_verts is None:
        max_verts = max_tris
    sel_e, cpos = _compact(active_edge, max_verts, 0)
    remap = torch.clamp(cpos, 0, max_verts - 1)

    # zero-crossing interpolation on the selected edges (reference
    # dmtet.py:111-118)
    ge0, ge1 = e0[sel_e], e1[sel_e]
    s0, s1 = sdf[ge0], sdf[ge1]
    p0, p1 = v_deformed[ge0], v_deformed[ge1]
    denom = s0 - s1
    denom = torch.where(torch.abs(denom) > 1e-10, denom,
                        torch.where(denom >= 0, 1e-10, -1e-10))
    w0 = -s1 / denom
    w1 = s0 / denom
    verts = p0 * w0[:, None] + p1 * w1[:, None]
    vmask = torch.arange(max_verts, device=dev) < n_active
    verts = torch.where(vmask[:, None], verts, (p0 + p1) * 0.5)

    tt = constant(TRIANGLE_TABLE, torch.int64, dev)
    local = tt[tetindex]                                       # [Nt, 6]
    gathered = torch.gather(edge_map, 1, torch.clamp(local, min=0))
    slot_faces = torch.cat([gathered[:, 0:3], gathered[:, 3:6]], dim=0)

    sel, _ = _compact(flat_valid, max_tris, 2 * Nt)
    overflow = (n_flat > max_tris) | (n_active > max_verts)
    live = sel < 2 * Nt
    tri_mask = live.float()
    sel_c = torch.clamp(sel, 0, 2 * Nt - 1)
    faces = remap[slot_faces[sel_c]]
    faces = torch.where(live[:, None], faces, 0).to(torch.int32)
    face_gidx = torch.where(live, sel_c, 0).to(torch.int32)
    return verts, faces, face_gidx, tri_mask, overflow


def face_uvs(face_gidx, n_tets, uv_N):
    """Per-face UV corners of the per-tet chart atlas, from the slot-major
    face index.  Returns (v_tex [3 T, 2], t_tex_idx [T, 3] int32)."""
    g = face_gidx.long()
    tet = g % n_tets
    tri = g // n_tets
    ii = tet // uv_N                       # chart row    -> y
    jj = tet % uv_N                        # chart column -> x
    base = torch.stack([jj.float() / uv_N, ii.float() / uv_N], dim=-1)
    pad = 0.9 / uv_N
    offs = constant((((0.0, 0.0), (pad, 0.0), (pad, pad)),
                     ((0.0, 0.0), (pad, pad), (0.0, pad))),
                    torch.float32, g.device)
    uv = base[:, None, :] + offs[tri]                          # [T, 3, 2]
    T = g.shape[0]
    return (uv.reshape(-1, 2),
            torch.arange(3 * T, dtype=torch.int32,
                         device=g.device).reshape(-1, 3))


def sdf_reg_loss(sdf, edges):
    """Sign-consistency BCE over the sign-crossing edges [E, 2] (reference
    dmtet.py:147-153), a masked mean."""
    s0 = sdf[edges[:, 0]]
    s1 = sdf[edges[:, 1]]
    mask = (torch.sign(s0) != torch.sign(s1)).float()

    def bce_logits(logit, target):
        return (maximum_split(logit, 0.0) - logit * target
                + torch.log1p(torch.exp(-abs_pos0(logit))))

    b = (bce_logits(s0, (s1 > 0).float())
         + bce_logits(s1, (s0 > 0).float()))
    return torch.sum(b * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _f32(x):
    return np.float32(x)


def ramps(iteration, FLAGS):
    """(shadow ramp, sdf regularizer weight) at iteration, in float32 as
    the JAX package computes them: min(it / shadow_ramp_iters, 1) and
    sdf_regularizer - (sdf_regularizer - 0.01) min(1, 4 it / iter)."""
    it = _f32(iteration)
    shadow = np.minimum(it / _f32(FLAGS.get('shadow_ramp_iters', 1750.0)),
                        _f32(1.0))
    t_iter = it / _f32(FLAGS['iter'])
    sr = FLAGS['sdf_regularizer']
    weight = _f32(sr) - _f32(sr - 0.01) * np.minimum(_f32(1.0),
                                                     _f32(4.0) * t_iter)
    return float(shadow), float(weight)


class DMTetGeometry:
    """Topology-free geometry of pass 1 (reference dmtet.py:159-246).
    Parameters: {'sdf': [Nv], 'deform': [Nv, 3]}."""

    def __init__(self, grid_res, scale, FLAGS, tets_path=None, max_tris=None,
                 seed=0, device=None):
        device = resolve(device)
        self.FLAGS = FLAGS
        self.grid_res = grid_res
        path = tets_path or os.path.join(
            FLAGS.get('data_root', '.'), 'data', 'tets',
            '{}_tets.npz'.format(grid_res))
        if os.path.exists(path):
            tets = np.load(path)
            tet_verts = np.asarray(tets['vertices'], dtype=np.float32)
            tet_idx = np.asarray(tets['indices'], dtype=np.int32)
        else:
            tet_verts, tet_idx = kuhn_tet_grid(grid_res)
        self.verts = torch.as_tensor(tet_verts, device=device) * scale
        self.indices = torch.as_tensor(tet_idx, device=device).long()
        self.edge_uniq, self.edge_map = edge_tables(self.indices,
                                                    self.verts.shape[0])
        self.num_tets = int(self.indices.shape[0])
        self.uv_N = int(np.ceil(np.sqrt((self.num_tets * 2 + 1) // 2)))
        # 24 r^2 slots hold the reference's random init's surface
        self.max_tris = max_tris or 24 * grid_res * grid_res
        if str(FLAGS.get('sdf_init', 'random')) == 'sphere':
            v = self.verts.cpu().numpy().T                     # [3, Nv]
            sdf = (0.45 * scale
                   - np.linalg.norm(v, axis=0)).astype(np.float32)
        else:
            rng = np.random.RandomState(seed)
            sdf = rng.rand(self.verts.shape[0]).astype(np.float32) - 0.1
        self.init_params = {
            'sdf': torch.as_tensor(sdf, device=device),
            'deform': torch.zeros_like(self.verts),
        }

    def parameters(self):
        return self.init_params

    def getAABB(self):
        return (torch.amin(self.verts, dim=0), torch.amax(self.verts, dim=0))

    @torch.no_grad()
    def tri_count(self, params):
        """(surface triangles of params' SDF, max_tris slots): the fixed
        buffer truncates past max_tris."""
        ntt = torch.as_tensor(NUM_TRIANGLES_TABLE, device=self.verts.device)
        n = ntt.long()[tet_index(params['sdf'], self.indices)].sum()
        return int(n), self.max_tris

    def getMesh(self, params, material, build_bvh=True, whole=False):
        """The surface in training's fixed max_tris slots or, when whole,
        in buffers sized to it (every triangle; one host sync), and its
        BVH."""
        with tracing.span('geometry.mesh'):
            v_deformed = (self.verts + 2.0 / (self.grid_res * 2)
                          * torch.tanh(params['deform']))
            with tracing.span('geometry.marching_tets'):
                verts, faces, face_gidx, tri_mask, _ = marching_tets(
                    v_deformed, params['sdf'], self.indices, self.edge_uniq,
                    self.edge_map, None if whole else self.max_tris)
            v_tex, t_tex_idx = face_uvs(face_gidx, self.num_tets, self.uv_N)
            m = mesh_mod.Mesh(v_pos=verts, t_pos_idx=faces, v_tex=v_tex,
                              t_tex_idx=t_tex_idx, tri_mask=tri_mask,
                              material=material)
            m = mesh_mod.auto_normals(m)
            m = mesh_mod.compute_tangents(m)
            bvh = (bvh_mod.build(m.v_pos, m.t_pos_idx,
                                 tri_mask=tri_mask > 0)
                   if build_bvh else None)
            return m, bvh

    def tick(self, params, material, lgt, target, loss_fn, iteration, FLAGS,
             denoiser_sigma, perms, generator, rnd_seed, uniforms=None,
             offsets=None):
        """Render target's view under the shadow ramp and return (img_loss,
        reg_loss) (reference dmtet.py:210-246).  The jitter, the position
        noise of the neural material and the MC uniforms come from
        generator and rnd_seed, or from offsets (per-layer (jitter offset,
        position noise) pairs) and uniforms when given."""
        color_ref = target['img']
        opt_mesh, bvh = self.getMesh(params, material)
        shadow_ramp, sdf_weight = ramps(iteration, FLAGS)
        buffers = render_mod.render_mesh(
            FLAGS, opt_mesh, target['mvp'], target['campos'], lgt,
            target['resolution'], bvh, perms, generator, spp=target['spp'],
            num_layers=FLAGS['layers'], msaa=True,
            background=target['background'], denoiser_sigma=denoiser_sigma,
            shadow_scale=shadow_ramp, rnd_seed=rnd_seed, uniforms=uniforms,
            offsets=offsets)

        with tracing.span('train.loss'):
            img_loss = torch.mean(
                (buffers['shaded'][..., 3:] - color_ref[..., 3:]) ** 2)
            img_loss = img_loss + loss_fn(
                buffers['shaded'][..., 0:3] * color_ref[..., 3:],
                color_ref[..., 0:3] * color_ref[..., 3:])

            reg_loss = sdf_reg_loss(params['sdf'], self.edge_uniq) * sdf_weight
            reg_loss = reg_loss + regularizer.shading_loss(
                buffers['diffuse_light'], buffers['specular_light'], color_ref,
                FLAGS['lambda_diffuse'], FLAGS['lambda_specular'])
            reg_loss = reg_loss + regularizer.material_smoothness_grad(
                buffers['kd_grad'], buffers['ks_grad'], buffers['normal_grad'],
                lambda_kd=FLAGS['lambda_kd'], lambda_ks=FLAGS['lambda_ks'],
                lambda_nrm=FLAGS['lambda_nrm'])
            reg_loss = reg_loss + regularizer.chroma_loss(
                buffers['kd'], color_ref, FLAGS['lambda_chroma'])
            return img_loss, reg_loss
