"""Wavefront OBJ load (counterpart of
nvdiffrecmc_tpu/render/obj.py): polygon triangulation, mtllib loading (or an
override), v-flip of texcoords, the uber-material merge of a mesh whose
faces use several materials."""

import os

import numpy as np
import torch

from ..device import resolve
from . import material as material_mod
from . import mesh as mesh_mod
from . import texture


def _idx(token, k):
    sp = token.split('/')
    if k >= len(sp) or sp[k] == '':
        return -1
    return int(sp[k]) - 1


def read_obj(filename):
    """Parse geometry only.  Returns (vertices, texcoords, normals, faces,
    tfaces, nfaces, face_materials, mtl_names) as python lists;
    mtl_names holds the `usemtl` names in the order they first appear,
    face_materials the index into it in force for each triangle (None
    before any)."""
    with open(filename, 'r') as f:
        lines = f.readlines()
    vertices, texcoords, normals = [], [], []
    faces, tfaces, nfaces, mfaces, names = [], [], [], [], []
    active = None
    for line in lines:
        parts = line.split()
        if not parts:
            continue
        prefix = parts[0].lower()
        if prefix == 'v':
            vertices.append([float(v) for v in parts[1:4]])
        elif prefix == 'vt':
            val = [float(v) for v in parts[1:3]]
            texcoords.append([val[0], 1.0 - val[1]])
        elif prefix == 'vn':
            normals.append([float(v) for v in parts[1:4]])
        elif prefix == 'usemtl':
            if parts[1] not in names:
                names.append(parts[1])
            active = names.index(parts[1])
        elif prefix == 'f':
            vs = parts[1:]
            v0, t0, n0 = _idx(vs[0], 0), _idx(vs[0], 1), _idx(vs[0], 2)
            for i in range(len(vs) - 2):  # triangulate
                v1, t1, n1 = (_idx(vs[i + 1], k) for k in range(3))
                v2, t2, n2 = (_idx(vs[i + 2], k) for k in range(3))
                mfaces.append(active)
                faces.append([v0, v1, v2])
                tfaces.append([t0, t1, t2])
                nfaces.append([n0, n1, n2])
    return vertices, texcoords, normals, faces, tfaces, nfaces, mfaces, names


def mesh_from_lists(vertices, texcoords, normals, faces, tfaces, nfaces,
                    material=None, device=None):
    device = resolve(device)

    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    def i32(x):
        return torch.as_tensor(np.array(x, np.int32), device=device)
    has_tex, has_nrm = len(texcoords) > 0, len(normals) > 0
    return mesh_mod.Mesh(
        v_pos=f32(vertices), t_pos_idx=i32(faces),
        v_nrm=f32(normals) if has_nrm else None,
        t_nrm_idx=i32(nfaces) if has_nrm else None,
        v_tex=f32(texcoords) if has_tex else None,
        t_tex_idx=i32(tfaces) if has_tex else None,
        material=material)


def load_obj(filename, clear_ks=True, mtl_override=None, device=None):
    """The mesh of an OBJ file with its material: the one its faces use,
    from the file's mtllib, or from mtl_override (read with clear_ks on)
    when given; where the usemtl lines name several, their merge
    (material.merge_materials) with the texcoords rewritten into its
    atlas."""
    device = resolve(device)
    obj_path = os.path.dirname(filename)
    all_materials = [{
        'name': '_default_mat',
        'bsdf': 'pbr',
        'kd': texture.Texture2D(data=torch.tensor(
            [0.5, 0.5, 0.5], device=device)[None, None, None, :]),
        'ks': texture.Texture2D(data=torch.tensor(
            [0.0, 0.0, 0.0], device=device)[None, None, None, :]),
    }]
    if mtl_override is not None:
        all_materials += material_mod.load_mtl(mtl_override, device=device)
    else:
        with open(filename, 'r') as f:
            for line in f:
                if line.split() and line.split()[0] == 'mtllib':
                    all_materials += material_mod.load_mtl(
                        os.path.join(obj_path, line.split()[1]), clear_ks,
                        device=device)

    (vertices, texcoords, normals, faces, tfaces, nfaces, mfaces,
     names) = read_obj(filename)
    # the materials the usemtl names resolve to, in the order they first
    # appear (two names may resolve to one, the default material)
    used, index = [], []
    for name in names:
        mat = material_mod._find_mat(all_materials, name)
        if not any(mat is u for u in used):
            used.append(mat)
        index.append(next(i for i, u in enumerate(used) if u is mat))
    mfaces = [None if k is None else index[k] for k in mfaces]
    if len(used) > 1:
        uber, texcoords, tfaces = material_mod.merge_materials(
            used, texcoords, tfaces, mfaces)
    else:
        uber = used[0] if used else all_materials[0]
    return mesh_from_lists(vertices, texcoords, normals, faces, tfaces,
                           nfaces, material=uber, device=device)
