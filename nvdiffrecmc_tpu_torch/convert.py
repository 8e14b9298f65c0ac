"""Carry the JAX package's scene objects over to the port.

Every function reads its input through numpy (np.asarray works on JAX
arrays without importing JAX here), so both packages can render one scene:
a Mesh's fields, a material dict's textures with their mips, and a light
dict's base and sampling tables."""

import dataclasses

import numpy as np
import torch

from .render import mesh as mesh_mod
from .render import texture as texture_mod


def tensor(x, device=None):
    """numpy-convertible array -> tensor on `device` (float32 stays
    float32, integer index arrays become int32)."""
    a = np.asarray(x)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int32)
    elif a.dtype != np.bool_:
        a = a.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def texture(tex, device=None):
    """A Texture2D-like object (`data`: one [1,H,W,C] array or a list of
    mips; `min_max`) -> texture.Texture2D."""
    data = tex.data
    data = ([tensor(m, device) for m in data] if isinstance(data, list)
            else tensor(data, device))
    min_max = None if tex.min_max is None else tuple(
        tensor(v, device) for v in tex.min_max)
    return texture_mod.Texture2D(data=data, min_max=min_max)


def material(mat, device=None):
    """Material dict: textures converted, other entries copied."""
    out = {}
    for k, v in mat.items():
        out[k] = texture(v, device) if hasattr(v, 'getMips') else v
    return out


def mesh(m, device=None):
    """Mesh-like object -> mesh.Mesh.  Index buffers that are one object on
    the JAX side stay one tensor here (render.gbuffer_layer tests it)."""
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
    return {k: tensor(lgt[k], device) for k in ('base', 'pdf', 'rows', 'cols')}


def params(p, device=None):
    """The JAX trainer's {'geo', 'mat', 'light'} parameters (nested dicts
    or lists of arrays) -> the same structure of tensors."""
    if isinstance(p, dict):
        return {k: params(v, device) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [params(v, device) for v in p]
    return tensor(p, device)
