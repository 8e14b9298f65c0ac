"""Material dicts + .mtl reading (counterpart of
nvdiffrecmc_tpu/render/material.py): 'bsdf' (str), 'kd'/'ks'/'normal'
(Texture2D).  kd is stored sRGB and converted to linear on load; the ks occlusion (red) channel is zeroed when clear_ks.
`merge_materials` stacks the materials of a multi-material mesh into one
uber-material atlas."""

import os
import re

import numpy as np
import torch

from ..device import resolve
from ..ops import vecmath
from . import texture


def load_mtl(fn, clear_ks=True, device=None):
    device = resolve(device)
    mtl_path = os.path.dirname(fn)
    with open(fn, 'r') as f:
        lines = f.readlines()

    materials = []
    mat = None
    for line in lines:
        split_line = re.split(r' +|\t+|\n+', line.strip())
        if not split_line or split_line[0] == '':
            continue
        prefix = split_line[0].lower()
        data = split_line[1:]
        if 'newmtl' in prefix:
            mat = {'name': data[0]}
            materials.append(mat)
        elif materials:
            if ('bsdf' in prefix or 'map_kd' in prefix or 'map_ks' in prefix
                    or 'bump' in prefix):
                mat[prefix] = data[0]
            else:
                mat[prefix] = np.array([float(d) for d in data],
                                       dtype=np.float32)

    def const(v):
        return texture.Texture2D(data=torch.as_tensor(
            v, device=device)[None, None, None, :])

    for mat in materials:
        if 'bsdf' not in mat:
            mat['bsdf'] = 'pbr'
        if 'map_kd' in mat:
            mat['kd'] = texture.load_texture2D(
                os.path.join(mtl_path, mat['map_kd']), device=device)
        else:
            mat['kd'] = const(mat['kd'])
        if 'map_ks' in mat:
            mat['ks'] = texture.load_texture2D(
                os.path.join(mtl_path, mat['map_ks']), channels=3,
                device=device)
        else:
            mat['ks'] = const(mat['ks'])
        if 'bump' in mat:
            mat['normal'] = texture.load_texture2D(
                os.path.join(mtl_path, mat['bump']),
                lambda_fn=lambda x: x * 2 - 1, channels=3, device=device)

        mat['kd'] = texture.srgb_to_rgb(mat['kd'])

        if clear_ks:
            mips = []
            for m in mat['ks'].getMips():
                m = m.clone()
                m[..., 0] = 0.0
                mips.append(m)
            mat['ks'] = texture.Texture2D(
                data=mips if isinstance(mat['ks'].data, list) else mips[0],
                min_max=mat['ks'].min_max)
    return materials


def _find_mat(materials, name):
    for mat in materials:
        if mat['name'] == name:
            return mat
    return materials[0]  # default


def merge_materials(materials, texcoords, tfaces, mfaces):
    """One uber-material for a mesh whose faces use several materials (the
    JAX package's merge_materials): every material's base level upscaled
    to the largest kd resolution (vecmath.scale_img_nhwc), ks and normal
    cut or padded to 3 channels, the atlases stacked along H in the order
    of `materials`, and one new texcoord per face corner, (u, (v + m) /
    n) for a face of material m of n (None, a face before any usemtl:
    material 0; a corner without a texcoord: (0, (0 + m) / n)).
    Returns (uber, texcoords [F * 3] lists, tfaces [F] lists of 3)."""
    assert len(materials) > 0
    for mat in materials:
        assert mat['bsdf'] == materials[0]['bsdf'], \
            "All materials must have the same BSDF (uber shader)"
        assert ('normal' in mat) is ('normal' in materials[0]), \
            "All materials must have either normal maps or no normal maps"
    max_res = np.amax(np.stack([np.array(m['kd'].getRes())
                                for m in materials]), axis=0)

    def _upscale(tex2d, channels):
        img = tex2d.getMips()[0][0]
        C = img.shape[-1]
        if channels is not None and C != channels:
            img = img[..., :channels] if C > channels else torch.cat(
                [img] + [img[..., -1:]] * (channels - C), -1)
        return vecmath.scale_img_nhwc(img[None], max_res)

    uber = {'name': 'uber_material', 'bsdf': materials[0]['bsdf']}
    for key, channels in (('kd', None), ('ks', 3), ('normal', 3)):
        if key in materials[0]:
            uber[key] = texture.Texture2D(data=torch.cat(
                [_upscale(m[key], channels) for m in materials], dim=1))

    n = len(materials)
    tc = np.asarray(texcoords, dtype=np.float32).reshape(-1, 2)
    new_tc, new_tf = [], []
    for face_idx, mat_idx in enumerate(mfaces):
        m = 0 if mat_idx is None else mat_idx
        ids = []
        for tid in tfaces[face_idx]:
            uv = tc[tid] if tid >= 0 else np.zeros(2, np.float32)
            ids.append(len(new_tc))
            new_tc.append(np.array([uv[0], (uv[1] + m) / n], np.float32))
        new_tf.append(ids)
    return uber, new_tc, new_tf
