"""Carry the JAX package's scene objects over to the port.

Every function reads its input through numpy (np.asarray works on JAX
arrays without importing JAX here), so both packages can render one scene:
a Mesh's fields, a material dict's textures with their mips, a light
dict's base and sampling tables, and the trainer's parameters (pass 1's
among them, in the port's layouts)."""

import dataclasses

import numpy as np
import torch

from .device import resolve
from .render import mesh as mesh_mod
from .render import texture as texture_mod


def tensor(x, device=None):
    """numpy-convertible array -> tensor on `device` (float32 stays
    float32, integer index arrays become int32)."""
    device = resolve(device)
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    elif a.dtype != np.bool_:
        a = a.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def texture(tex, device=None):
    """A Texture2D-like object (`data`: one [1,H,W,C] array or a list of
    mips; `min_max`) -> texture.Texture2D."""
    device = resolve(device)
    data = tex.data
    data = ([tensor(m, device) for m in data] if isinstance(data, list)
            else tensor(data, device))
    min_max = None if tex.min_max is None else tuple(
        tensor(v, device) for v in tex.min_max)
    return texture_mod.Texture2D(data=data, min_max=min_max)


def material(mat, device=None):
    """Material dict: textures converted, other entries copied."""
    device = resolve(device)
    out = {}
    for k, v in mat.items():
        out[k] = texture(v, device) if hasattr(v, 'getMips') else v
    return out


def mesh(m, device=None):
    """Mesh-like object -> mesh.Mesh.  Index buffers that are one object on
    the JAX side stay one tensor here (render.gbuffer_layer tests it)."""
    device = resolve(device)
    fields = {}
    seen = {}
    for f in dataclasses.fields(mesh_mod.Mesh):
        v = getattr(m, f.name, None)
        if f.name == 'material':
            fields[f.name] = None if v is None else material(v, device)
        elif v is None:
            fields[f.name] = None
        elif id(v) in seen:
            fields[f.name] = seen[id(v)]
        else:
            fields[f.name] = seen[id(v)] = tensor(v, device)
    return mesh_mod.Mesh(**fields)


def light(lgt, device=None):
    """Light dict {'base', 'pdf', 'rows', 'cols'} -> the same of tensors."""
    device = resolve(device)
    return {k: tensor(lgt[k], device) for k in ('base', 'pdf', 'rows', 'cols')}


def mlp_texture(p, device=None):
    """hashgrid.MLPTexture3DParams of the JAX package (table [L, T, F],
    weights) -> the port's neural material {'table': [L*T, F], 'w0', ...}."""
    device = resolve(device)
    table = np.asarray(p.table)
    out = {'table': tensor(table.reshape(-1, table.shape[-1]), device)}
    out.update(('w%d' % i, tensor(w, device))
               for i, w in enumerate(p.weights))
    return out


def params(p, device=None):
    """The JAX trainer's {'geo', 'mat', 'light'} parameters (nested dicts
    or lists of arrays) -> the same structure of tensors, in the port's
    layouts: a 'kd_ks' neural material becomes the 'mat' dict of
    mlp_texture, the DMTet 'deform' [3, Nv] becomes [Nv, 3]."""
    device = resolve(device)
    if isinstance(p, dict):
        if 'kd_ks' in p:
            return mlp_texture(p['kd_ks'], device)
        return {k: (tensor(np.asarray(v).T, device) if k == 'deform'
                    else params(v, device)) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [params(v, device) for v in p]
    return tensor(p, device)
