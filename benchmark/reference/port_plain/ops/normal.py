"""Shading-normal preparation (counterpart of nvdiffrecmc_tpu/ops/normal.py):
normalize smooth normal/tangent, optional tangent-space perturbation,
two-sided flip, bend backfacing normals toward the geometric normal."""

import torch

from .vecmath import dot, safe_normalize

NORMAL_THRESHOLD = 0.1


def _bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading):
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(front, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm * (1.0 - t) + smooth_nrm * t


def _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl):
    smooth_bitang = safe_normalize(torch.linalg.cross(smooth_tng, smooth_nrm))
    bitang_sign = -1.0 if opengl else 1.0
    shading_nrm = (smooth_tng * perturbed_nrm[..., 0:1]
                   + bitang_sign * smooth_bitang * perturbed_nrm[..., 1:2]
                   + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3], min=0.0))
    return safe_normalize(shading_nrm)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm,
                           smooth_tng, geom_nrm, two_sided_shading=True,
                           opengl=True):
    """Returns the final shading normal [..., 3]; perturbed_nrm may be None."""
    smooth_nrm = safe_normalize(smooth_nrm)
    smooth_tng = safe_normalize(smooth_tng)
    view_vec = safe_normalize(view_pos - pos)
    if perturbed_nrm is None:
        shading_nrm = smooth_nrm
    else:
        shading_nrm = _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng,
                                      opengl)
    return _bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)
