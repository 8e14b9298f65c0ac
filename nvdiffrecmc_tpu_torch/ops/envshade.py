"""Monte-Carlo environment shading with light/BSDF multiple importance
sampling and traced shadow rays (counterpart of
nvdiffrecmc_tpu/ops/envshade.py).

`env_shade` is the entry point.  Up to 256 strata it runs the fused
pipeline (pallas_shade.env_shade_fused: the sample and trace + shade
kernels, with a backward).  Past that it runs an O(P)-memory stratum
loop, shaped as the JAX package's: per stratum, one launch of the sample
kernel on that stratum's uniforms (pallas_shade.sample_all, the light and
BSDF samples and their MIS pdfs), one launch of the standalone any-hit
tracer on both ray sets (pallas_tracer.any_hit_pallas), then the
demodulated shading (pallas_shade._shade_stratum).  The JAX loop samples in jnp with
exact atan2/acos; the sample kernel uses the polynomial ones of the JAX
package's Pallas sampler, which its own validation runs.  The loop is
forward only: its backward (training at n_samples > 16) is not ported.

Random draws come from a torch.Generator seeded with rnd_seed, or from
explicit `uniforms` (the fused pipeline's [n2, 8, P] layout, test sizes
only: 8.6 GB at 512x512 and 1,024 strata), so tests can feed both
packages the same numbers.  The JAX loop's direction-octant ray sort (an
exact permutation) is a TPU tactic and is not carried over."""

import numpy as np
import torch

from ..device import resolve
from . import pallas_shade, tracer
from .vecmath import dot, safe_normalize

BIG = 3e37
_MASK32 = 0xFFFFFFFF

# The fused pipeline materializes [n2, {8,16}, P] sample/uniform arrays; past
# this stratum count env_shade runs the O(P)-memory stratum loop instead.
# The JAX package's switch point; at 1,024 strata and 512x512 the fused
# arrays would take ~28 GB, so on an 80 GB card it is a choice, not a limit.
_FUSED_MAX_N2 = 256


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


# ---------------------------------------------------------------------------
# Main entry
# ---------------------------------------------------------------------------

_LOGGED_BACKENDS = set()


def _log_backend(n_samples_x, shape, device):
    """One line per shade configuration, so every number is attributable
    to the pipeline that ran."""
    n2 = n_samples_x * n_samples_x
    resolved = 'fused'
    if n2 > _FUSED_MAX_N2:
        resolved = 'pallas (n2=%d > fused max %d)' % (n2, _FUSED_MAX_N2)
    key = (resolved, tuple(shape), device.type)
    if key not in _LOGGED_BACKENDS:
        _LOGGED_BACKENDS.add(key)
        print('env_shade: backend=%s n2=%d shape=%s platform=%s'
              % (resolved, n2, tuple(shape), device.type), flush=True)


def env_shade(mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks,
              light_base, light_pdf_tex, rows, cols, bvh, perms, rnd_seed,
              shadow_scale, BSDF=0, n_samples_x=8, uniforms=None):
    """Monte-Carlo direct lighting.  mask [B,H,W]; ro/gb_* [B,H,W,3];
    light_base [Hl,Wl,3]; light_pdf_tex/cols [Hl,Wl]; rows [Hl]; bvh:
    LeafBVH; perms [NPERM, n2] (read when n2 is not a power of two).  Up to
    256 strata the fused pipeline, past that the stratum loop.  uniforms:
    [n2, 8, P] as pallas_shade.make_uniforms makes them, or None: drawn from
    rnd_seed (the loop draws stratum by stratum).  Returns (diffuse_accum,
    specular_accum) [B,H,W,3], demodulated."""
    _log_backend(n_samples_x, mask.shape, gb_pos.device)
    if n_samples_x * n_samples_x <= _FUSED_MAX_N2:
        return pallas_shade.env_shade_fused(
            mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks,
            light_base, light_pdf_tex, rows, cols, bvh, perms, rnd_seed,
            shadow_scale, BSDF=BSDF, n_samples_x=n_samples_x,
            uniforms=uniforms)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (light_base, gb_pos, gb_normal,
                                      gb_view_pos, gb_kd, gb_ks)):
        raise NotImplementedError(
            'env_shade: the stratum loop (n_samples_x^2 > %d) has no '
            'backward yet' % _FUSED_MAX_N2)
    return _env_shade_loop(mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd,
                           gb_ks, light_base, light_pdf_tex, rows, cols, bvh,
                           perms, rnd_seed, shadow_scale, BSDF, n_samples_x,
                           uniforms)


def _env_shade_loop(mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks,
                    light_base, light_pdf_tex, rows, cols, bvh, perms,
                    rnd_seed, shadow_scale, BSDF, n_samples_x, uniforms):
    """The O(P)-memory stratum loop (forward): per stratum the sample
    kernel on that stratum's uniforms, one trace of both ray sets, the
    fused pipeline's shading."""
    B, H, W = mask.shape
    P = B * H * W
    dev = gb_pos.device
    m = mask.reshape(P) > 0
    pos, nrm, view, kd, ks = (x.reshape(P, 3) for x in
                              (gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks))
    gb8 = pallas_shade.lobe_rows(pos, nrm, view, kd, ks)
    g = dict(pos=pos.unbind(-1), nrm=nrm.unbind(-1), view=view.unbind(-1),
             kd=kd.unbind(-1), ks=ks.unbind(-1))
    rows, cols = rows.contiguous(), cols.contiguous()
    tables = (rows, cols, pallas_shade.sample_guide(rows, cols),
              light_pdf_tex.contiguous(), light_base.contiguous())
    origins = torch.where(m[:, None], ro.reshape(P, 3), BIG)
    all_o = torch.cat([origins, origins])
    m2 = torch.cat([m, m])[:, None]

    n2 = n_samples_x * n_samples_x
    ss = float(shadow_scale)
    occlusion_fn = tracer.make_occlusion_fn()
    if uniforms is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rnd_seed))
        seeds = pallas_shade.perm_seeds(gen, P, n_samples_x, perms, dev)
        pad = torch.zeros((1, P), device=dev)
    elif tuple(uniforms.shape) != (n2, 8, P):
        raise ValueError('uniforms must be [%d, 8, %d], got %s'
                         % (n2, P, tuple(uniforms.shape)))

    diff = spec = 0.0
    for i in range(n2):
        if uniforms is None:
            u8 = torch.cat([torch.rand((5, P), generator=gen, device=dev),
                            pallas_shade.stratum_cells(i, n_samples_x, *seeds,
                                                       perms), pad])[None]
        else:
            u8 = uniforms[i:i + 1]
        samp = pallas_shade.sample_all(u8, gb8, *tables, n_samples_x)[0]

        # one trace for both ray sets; masked pixels get a zero direction
        # and an origin at BIG, which never hit
        all_d = torch.where(m2, samp[0:6].reshape(2, 3, P).transpose(1, 2)
                            .reshape(2 * P, 3), 0.0)
        vis = (~occlusion_fn(all_o, all_d, bvh)).float() * ss + (1.0 - ss)
        d, s = pallas_shade._shade_stratum(samp, g, vis[:P], vis[P:], BSDF,
                                           1.0 / n2)
        diff = diff + torch.stack(d, -1)
        spec = spec + torch.stack(s, -1)

    mf = m[:, None].float()
    return (diff * mf).reshape(B, H, W, 3), (spec * mf).reshape(B, H, W, 3)


def make_perms(n_samples_x, n_tables=32768, seed=0x5eed, device=None):
    """Host-side stratified-permutation tables [n_tables, n^2] int64."""
    device = resolve(device)
    rng = np.random.RandomState(seed)
    n2 = n_samples_x * n_samples_x
    return torch.as_tensor(np.argsort(rng.rand(n_tables, n2), axis=-1),
                           device=device)
