"""Batched 4x4 point / vector transforms (counterpart of
nvdiffrecmc_tpu/ops/xfm.py)."""

import torch


def xfm_points(points, matrix):
    """points [N, V, 3] or [V, 3]; matrix [N, 4, 4] or [4, 4].
    Returns clip-space positions [N, V, 4]."""
    if points.dim() == 2:
        points = points[None]
    if matrix.dim() == 2:
        matrix = matrix[None]
    hom = torch.cat((points, torch.ones_like(points[..., :1])), dim=-1)
    return torch.einsum('nij,nvj->nvi', matrix, hom)


def xfm_vectors(vectors, matrix):
    """Transform direction vectors (w=0) by homogeneous matrices."""
    if vectors.dim() == 2:
        vectors = vectors[None]
    if matrix.dim() == 2:
        matrix = matrix[None]
    return torch.einsum('nij,nvj->nvi', matrix[..., :3, :3], vectors)
