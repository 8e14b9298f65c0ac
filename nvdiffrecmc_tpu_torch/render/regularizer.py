"""Regularization losses (counterpart of
nvdiffrecmc_tpu/render/regularizer.py).  Kinks take JAX's gradients
(ops/vecmath)."""

import torch

from ..ops import mesh_ops
from ..ops.vecmath import (abs_pos0, clip_split, dot, maximum_split,
                           rgb_to_srgb)


def _luma(x):
    return ((x[..., 0:1] + x[..., 1:2] + x[..., 2:3]) / 3).repeat(
        *([1] * (x.dim() - 1)), 3)


def _value(x):
    return torch.amax(x[..., 0:3], dim=-1, keepdim=True).repeat(
        *([1] * (x.dim() - 1)), 3)


def chroma_loss(kd, color_ref, lambda_chroma):
    eps = 0.001
    ref_chroma = color_ref[..., 0:3] / maximum_split(_value(color_ref), eps)
    opt_chroma = kd[..., 0:3] / maximum_split(_value(kd), eps)
    return torch.mean(abs_pos0((opt_chroma - ref_chroma)
                               * color_ref[..., 3:])) * lambda_chroma


def shading_loss(diffuse_light, specular_light, color_ref, lambda_diffuse,
                 lambda_specular):
    """Monochrome-shading regularizer."""
    diffuse_luma = _luma(diffuse_light)
    specular_luma = _luma(specular_light)
    ref_luma = _value(color_ref)
    eps = 0.001
    img = rgb_to_srgb(torch.log(clip_split(
        (diffuse_luma + specular_luma) * color_ref[..., 3:], 0.0, 65535.0)
        + 1))
    target = rgb_to_srgb(torch.log(clip_split(
        ref_luma * color_ref[..., 3:], 0.0, 65535.0) + 1))
    error = (abs_pos0(img - target) * diffuse_luma
             / maximum_split(diffuse_luma + specular_luma, eps))
    loss = torch.mean(error) * lambda_diffuse
    loss = loss + (torch.mean(specular_luma)
                   / maximum_split(torch.mean(diffuse_luma), eps)
                   * lambda_specular)
    return loss


def material_smoothness_grad(kd_grad, ks_grad, nrm_grad, lambda_kd=0.25,
                             lambda_ks=0.1, lambda_nrm=0.0):
    kd_luma_grad = (kd_grad[..., 0] + kd_grad[..., 1] + kd_grad[..., 2]) / 3
    loss = torch.mean(kd_luma_grad * kd_grad[..., -1]) * lambda_kd
    loss = loss + torch.mean(ks_grad[..., :-1] * ks_grad[..., -1:]) \
        * lambda_ks
    loss = loss + torch.mean(nrm_grad[..., :-1] * nrm_grad[..., -1:]) \
        * lambda_nrm
    return loss


def laplace_regularizer_const(v_pos, t_pos_idx, tri_mask=None):
    return mesh_ops.laplace_uniform(v_pos, t_pos_idx, tri_mask)


def normal_consistency(v_pos, t_pos_idx, edge_to_face):
    """Normal difference across edges (defined but unused in the
    reference).  edge_to_face: [E, 2] face pairs per edge."""
    fn = mesh_ops.face_normals(v_pos, t_pos_idx)
    e2f = edge_to_face.long()
    term = clip_split(dot(fn[e2f[:, 0]], fn[e2f[:, 1]]), -1.0, 1.0)
    return torch.mean(abs_pos0((1.0 - term) * 0.5))


def avg_edge_length(v_pos, t_pos_idx):
    """The mean edge length of a mesh, a float (its edges listed on the
    host)."""
    e = mesh_ops.compute_edges_np(t_pos_idx.cpu().numpy())
    return float(mesh_ops.avg_edge_length(
        v_pos, torch.as_tensor(e, device=v_pos.device)))
