"""Mesh container + attribute pipeline (counterpart of
nvdiffrecmc_tpu/render/mesh.py): a dataclass of tensors on one device."""

import dataclasses
from typing import Any

import torch

from ..ops import mesh_ops


@dataclasses.dataclass
class Mesh:
    v_pos: Any = None
    t_pos_idx: Any = None
    v_nrm: Any = None
    t_nrm_idx: Any = None
    v_tex: Any = None
    t_tex_idx: Any = None
    v_tng: Any = None
    t_tng_idx: Any = None
    tri_mask: Any = None            # [T] float {0,1} or None (all valid)
    material: Any = None


def aabb(mesh: Mesh):
    return (torch.amin(mesh.v_pos, dim=0), torch.amax(mesh.v_pos, dim=0))


def auto_normals(mesh: Mesh) -> Mesh:
    v_nrm = mesh_ops.auto_normals(mesh.v_pos, mesh.t_pos_idx, mesh.tri_mask)
    return dataclasses.replace(mesh, v_nrm=v_nrm, t_nrm_idx=mesh.t_pos_idx)


def compute_tangents(mesh: Mesh) -> Mesh:
    v_tng = mesh_ops.compute_tangents(
        mesh.v_pos, mesh.v_nrm, mesh.v_tex, mesh.t_pos_idx, mesh.t_nrm_idx,
        mesh.t_tex_idx, mesh.tri_mask)
    return dataclasses.replace(mesh, v_tng=v_tng, t_tng_idx=mesh.t_nrm_idx)
