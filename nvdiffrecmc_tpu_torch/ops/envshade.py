"""Monte-Carlo environment shading with light/BSDF multiple importance
sampling and traced shadow rays (counterpart of
nvdiffrecmc_tpu/ops/envshade.py).  `env_shade` is the entry point; the
work is done by pallas_shade.env_shade_fused on every device (the JAX
package's O(P)-memory scan path for n_samples > 16 is not ported)."""

import numpy as np
import torch

from .vecmath import dot, safe_normalize

_MASK32 = 0xFFFFFFFF


def _kensler_permute_pow2(i, l, p):
    """Pseudorandom bijection on [0, l) for power-of-two l (Kensler,
    'Correlated Multi-Jittered Sampling').  uint32 arithmetic carried in
    int64 and masked to 32 bits after every product."""
    w = l - 1
    i = torch.as_tensor(i).to(torch.int64) & _MASK32
    p = torch.as_tensor(p).to(torch.int64) & _MASK32
    i = i ^ p
    i = (i * 0xe170893d) & _MASK32
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = (i * 0x0929eb3f) & _MASK32
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = (i * (1 | (p >> 27))) & _MASK32
    i = (i * 0x6935fa69) & _MASK32
    i = i ^ ((i & w) >> 11)
    i = (i * 0x74dcca23) & _MASK32
    i = i ^ ((i & w) >> 2)
    i = (i * 0x9e501cc3) & _MASK32
    i = i ^ ((i & w) >> 2)
    i = (i * 0xc860a3df) & _MASK32
    return (i & w).to(torch.int32)


def _luminance(c):
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def _spec_albedo(col, wo, N):
    """Fresnel-weighted specular albedo for lobe selection."""
    W = safe_normalize(N)
    cosNO = dot(wo, W)[..., 0]
    c = torch.clamp(cosNO, 1e-4, 1.0 - 1e-4)
    scale = (1.0 - c) ** 5
    f = col * (1.0 - scale[..., None]) + scale[..., None]
    return torch.where(cosNO > 0.0, _luminance(f), 0.0)


def env_shade(mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks,
              light_base, light_pdf_tex, rows, cols, bvh, perms, rnd_seed,
              shadow_scale, BSDF=0, n_samples_x=8, uniforms=None):
    """Monte-Carlo direct lighting.  mask [B,H,W]; ro/gb_* [B,H,W,3];
    light_base [Hl,Wl,3]; light_pdf_tex/cols [Hl,Wl]; rows [Hl]; bvh:
    LeafBVH; uniforms: optional [n2, 8, P] (drawn from rnd_seed when None).
    Returns (diffuse_accum, specular_accum) [B,H,W,3], demodulated."""
    from .pallas_shade import env_shade_fused
    return env_shade_fused(mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd,
                           gb_ks, light_base, light_pdf_tex, rows, cols, bvh,
                           perms, rnd_seed, shadow_scale, BSDF=BSDF,
                           n_samples_x=n_samples_x, uniforms=uniforms)


def make_perms(n_samples_x, n_tables=32768, seed=0x5eed, device=None):
    """Host-side stratified-permutation tables [n_tables, n^2] int64."""
    rng = np.random.RandomState(seed)
    n2 = n_samples_x * n_samples_x
    return torch.as_tensor(np.argsort(rng.rand(n_tables, n2), axis=-1),
                           device=device)
