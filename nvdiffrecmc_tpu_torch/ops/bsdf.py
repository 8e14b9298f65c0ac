"""Physically-based BSDF stack in plain PyTorch (counterpart of
nvdiffrecmc_tpu/ops/bsdf.py): Lambert and Frostbite diffuse, Schlick
Fresnel, the GGX NDF and correlated Smith masking, Cook-Torrance
specular, the point-light PBR BSDF and its demodulated variant.

The SPECULAR_EPSILON clamps keep the JAX package's gradients: zero outside
the clamp's range, and half to each side at a tie, as jnp.clip gives them
(vecmath.clip_split, maximum_split).  All functions broadcast over leading
dims; vectors are [..., 3]."""

import math

import torch

from .vecmath import clip_split, dot, maximum_split, safe_normalize

SPECULAR_EPSILON = 1e-4
MIN_ROUGHNESS = 0.08


def lambert(nrm, wi):
    """max(dot(n, wi), 0) / pi -> [..., 1]"""
    return maximum_split(dot(nrm, wi), 0.0) / math.pi


def frostbite(nrm, wi, wo, linear_roughness):
    """Normalized Disney/Frostbite diffuse with double Fresnel."""
    wiDotN = dot(wi, nrm)
    woDotN = dot(wo, nrm)

    h = safe_normalize(wo + wi)
    wiDotH = dot(wi, h)

    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wiDotH * wiDotH * linear_roughness
    f0 = 1.0

    wi_scatter = fresnel_schlick(f0, f90, wiDotN)
    wo_scatter = fresnel_schlick(f0, f90, woDotN)
    res = wi_scatter * wo_scatter * energy_factor
    return torch.where((wiDotN > 0.0) & (woDotN > 0.0), res,
                       torch.zeros_like(res))


def fresnel_schlick(f0, f90, cos_theta):
    _c = clip_split(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - _c) ** 5.0


def ndf_ggx(alpha_sqr, cos_theta):
    _c = clip_split(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (_c * alpha_sqr - _c) * _c + 1.0
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    _c = clip_split(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    cos_sqr = _c * _c
    tan_sqr = (1.0 - cos_sqr) / cos_sqr
    return 0.5 * (torch.sqrt(1.0 + alpha_sqr * tan_sqr) - 1.0)


def masking_smith_ggx_correlated(alpha_sqr, cos_theta_i, cos_theta_o):
    lambda_i = lambda_ggx(alpha_sqr, cos_theta_i)
    lambda_o = lambda_ggx(alpha_sqr, cos_theta_o)
    return 1.0 / (1.0 + lambda_i + lambda_o)


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness=MIN_ROUGHNESS):
    """Cook-Torrance GGX specular: F*D*G / (4*woDotN), front-facing-gated."""
    _alpha = clip_split(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = _alpha * _alpha

    h = safe_normalize(wo + wi)
    woDotN = dot(wo, nrm)
    wiDotN = dot(wi, nrm)
    woDotH = dot(wo, h)
    nDotH = dot(nrm, h)

    D = ndf_ggx(alpha_sqr, nDotH)
    G = masking_smith_ggx_correlated(alpha_sqr, woDotN, wiDotN)
    F = fresnel_schlick(col, 1.0, woDotH)

    w = F * D * G * 0.25 / maximum_split(woDotN, SPECULAR_EPSILON)

    frontfacing = (woDotN > SPECULAR_EPSILON) & (wiDotN > SPECULAR_EPSILON)
    return torch.where(frontfacing, w, torch.zeros_like(w))


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos,
             min_roughness=MIN_ROUGHNESS, BSDF=0):
    """The point-light PBR BSDF (diffuse by BSDF: 0 Lambert, 1
    Frostbite)."""
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)

    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1.0 - spec_str)
    kd_eff = kd * (1.0 - metallic)

    if BSDF == 0:
        diffuse = kd_eff * lambert(nrm, wi)
    else:
        diffuse = kd_eff * frostbite(nrm, wi, wo, roughness)
    specular = pbr_specular(ks, nrm, wo, wi, roughness * roughness,
                            min_roughness=min_roughness)
    return diffuse + specular


def pbr_bsdf_demodulated(kd, arm, pos, nrm, view_pos, wi,
                         min_roughness=MIN_ROUGHNESS):
    """The Monte-Carlo tracer's variant: the diffuse term without kd (the
    Lambert scalar on 3 channels), the specular term with its full colour;
    wi is a normalized world-space light direction."""
    wo = safe_normalize(view_pos - pos)
    alpha = arm[..., 1:2] * arm[..., 1:2]
    spec_col = ((0.04 * (1.0 - arm[..., 2:3]) + kd * arm[..., 2:3])
                * (1.0 - arm[..., 0:1]))

    diff = lambert(nrm, wi)
    diffuse = diff.expand(*diff.shape[:-1], 3)
    specular = pbr_specular(spec_col, nrm, wo, wi, alpha,
                            min_roughness=min_roughness)
    return diffuse, specular
