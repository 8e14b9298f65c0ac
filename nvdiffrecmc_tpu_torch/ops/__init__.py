"""Compute ops of the port: the BSDF stack, shading normals, losses,
transforms, textures, rasterizer, BVH and any-hit tracer, Monte-Carlo
shading, denoiser, cubemap prefiltering.  The names below are re-exported
as the JAX package's ops/__init__.py re-exports them."""

from .bsdf import (
    lambert, frostbite, fresnel_schlick, ndf_ggx, lambda_ggx,
    masking_smith_ggx_correlated, pbr_specular, pbr_bsdf,
    SPECULAR_EPSILON, MIN_ROUGHNESS,
)
from .normal import prepare_shading_normal, NORMAL_THRESHOLD
from .loss import image_loss, tonemap_log_srgb
from .xfm import xfm_points, xfm_vectors
from . import vecmath
