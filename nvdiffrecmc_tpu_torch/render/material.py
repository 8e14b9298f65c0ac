"""Material dicts + .mtl IO (counterpart of
nvdiffrecmc_tpu/render/material.py): 'bsdf' (str), 'kd'/'ks'/'normal'
(Texture2D).  kd is stored sRGB and converted to linear on load (and back
on save); the ks occlusion (red) channel is zeroed when clear_ks."""

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


def save_mtl(fn, material):
    """fn (newmtl defaultMat) and, beside it, texture_kd.png (sRGB),
    texture_ks.png and texture_n.png (normals mapped to [0, 1])."""
    folder = os.path.dirname(fn)
    with open(fn, 'w') as f:
        f.write('newmtl defaultMat\n')
        if material is not None:
            f.write('bsdf   %s\n' % material['bsdf'])
            if 'kd' in material:
                f.write('map_Kd texture_kd.png\n')
                texture.save_texture2D(os.path.join(folder, 'texture_kd.png'),
                                       texture.rgb_to_srgb(material['kd']))
            if 'ks' in material:
                f.write('map_Ks texture_ks.png\n')
                texture.save_texture2D(os.path.join(folder, 'texture_ks.png'),
                                       material['ks'])
            if 'normal' in material:
                texture.save_texture2D(
                    os.path.join(folder, 'texture_n.png'), material['normal'],
                    lambda_fn=lambda x: (vecmath.safe_normalize(x) + 1) * 0.5)
                f.write('bump texture_n.png\n')
        else:
            f.write('Kd 1 1 1\nKs 0 0 0\nKa 0 0 0\nTf 1 1 1\nNi 1\nNs 0\n')


def _find_mat(materials, name):
    for mat in materials:
        if mat['name'] == name:
            return mat
    return materials[0]  # default
