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
package's Pallas sampler, which its own validation runs.  The loop has a
backward (training at n_samples > 16), as the JAX loop is a checkpointed
scan: its forward keeps no per-stratum array, and its backward walks the
strata again in the forward's draw order, per stratum the sample kernel,
one trace of both ray sets, the shade-backward kernel (each stratum
weighed 1 / n2 of the whole estimator) and the light scatter, summing the
G-buffer and light gradients.

Random draws come from a torch.Generator seeded with rnd_seed, or from
explicit `uniforms` (the fused pipeline's [n2, 8, P] layout, test sizes
only: 8.6 GB at 512x512 and 1,024 strata), so tests can feed both
packages the same numbers.  Decorrelated shading (`bwd`: a seed or
uniforms) keeps the forward and draws the backward's samples from that
seed (or takes those uniforms), in both paths.  The JAX loop's
direction-octant ray sort (an exact permutation) is a TPU tactic and is
not carried over."""

import numpy as np
import torch

from .. import tracing
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
              shadow_scale, BSDF=0, n_samples_x=8, uniforms=None,
              bwd=None):
    """Monte-Carlo direct lighting.  mask [B,H,W]; ro/gb_* [B,H,W,3];
    light_base [Hl,Wl,3]; light_pdf_tex/cols [Hl,Wl]; rows [Hl]; bvh:
    LeafBVH; perms [NPERM, n2] (read when n2 is not a power of two).  Up to
    256 strata the fused pipeline, past that the stratum loop.  uniforms:
    [n2, 8, P] as pallas_shade.make_uniforms makes them, or None: drawn from
    rnd_seed (the loop draws stratum by stratum).  bwd, a seed or
    uniforms [n2, 8, P]: decorrelated shading, whose backward samples on
    its own uniforms (those, or drawn from the seed as the forward's are
    drawn from rnd_seed).  Returns (diffuse_accum, specular_accum) [B,H,W,3],
    demodulated, differentiable in light_base, gb_pos, gb_normal,
    gb_view_pos, gb_kd and gb_ks."""
    _log_backend(n_samples_x, mask.shape, gb_pos.device)
    if n_samples_x * n_samples_x <= _FUSED_MAX_N2:
        return pallas_shade.env_shade_fused(
            mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks,
            light_base, light_pdf_tex, rows, cols, bvh, perms, rnd_seed,
            shadow_scale, BSDF=BSDF, n_samples_x=n_samples_x,
            uniforms=uniforms, bwd=bwd)
    return _env_shade_loop(mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd,
                           gb_ks, light_base, light_pdf_tex, rows, cols, bvh,
                           perms, rnd_seed, shadow_scale, BSDF, n_samples_x,
                           uniforms, bwd)


class _Strata:
    """The stratum loop's draws: stratum i's uniforms [1, 8, P], from
    explicit uniforms [n2, 8, P] or from a generator seeded seed (the
    pixels' permutation seeds first, then 5 rows of uniforms per stratum,
    in stratum order, so that a second walk from the same seed draws the
    same numbers)."""

    def __init__(self, uniforms, seed, P, n_samples_x, perms, dev):
        n2 = n_samples_x * n_samples_x
        self.uniforms, self.n_samples_x = uniforms, n_samples_x
        self.perms = perms
        if uniforms is not None:
            if tuple(uniforms.shape) != (n2, 8, P):
                raise ValueError('uniforms must be [%d, 8, %d], got %s'
                                 % (n2, P, tuple(uniforms.shape)))
            return
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(seed))
        self.seeds = pallas_shade.perm_seeds(self.gen, P, n_samples_x, perms,
                                             dev)
        self.pad = torch.zeros((1, P), device=dev)

    def draw(self, i):
        if self.uniforms is not None:
            return self.uniforms[i:i + 1]
        P = self.pad.shape[1]
        return torch.cat([
            torch.rand((5, P), generator=self.gen, device=self.pad.device),
            pallas_shade.stratum_cells(i, self.n_samples_x, *self.seeds,
                                       self.perms), self.pad])[None]


class _EnvShadeLoop(torch.autograd.Function):
    """The stratum loop, differentiable in the inputs of _EnvShadeFused:
    (base, pos, nrm, view, kd, ks).  The forward saves the draws' seed (or
    the explicit uniforms) and no per-stratum array; the backward walks
    the strata again (from the backward's seed or uniforms when
    decorrelated) and adds up each stratum's shade backward and light
    scatter."""

    @staticmethod
    def forward(ctx, base, pos, nrm, view, kd, ks, m, ro, rows, cols, pdf,
                bvh, perms, seed, uniforms, ss, BSDF, n_samples_x, bwd):
        P = m.shape[0]
        n2 = n_samples_x * n_samples_x
        gb8 = pallas_shade.lobe_rows(pos, nrm, view, kd, ks)
        g = dict(pos=pos.unbind(-1), nrm=nrm.unbind(-1),
                 view=view.unbind(-1), kd=kd.unbind(-1), ks=ks.unbind(-1))
        guide = pallas_shade.sample_guide(rows, cols)
        tables = (rows, cols, guide, pdf, base)
        all_o, m2 = _ray_origins(m, ro)
        occlusion_fn = tracer.make_occlusion_fn()
        strata = _Strata(uniforms, seed, P, n_samples_x, perms, pos.device)
        diff = spec = 0.0
        for i in range(n2):
            samp = pallas_shade.sample_all(strata.draw(i), gb8, *tables,
                                           n_samples_x)[0]
            vis = _visibility(samp, all_o, m2, bvh, occlusion_fn, ss)
            d, s = pallas_shade._shade_stratum(samp, g, vis[:P], vis[P:],
                                               BSDF, 1.0 / n2)
            diff = diff + torch.stack(d, -1)
            spec = spec + torch.stack(s, -1)
        if bwd is not None:
            seed, uniforms = (None, bwd) if torch.is_tensor(bwd) \
                else (bwd, None)
        ctx.save_for_backward(base, pos, nrm, view, kd, ks, m, ro, rows,
                              cols, pdf, guide,
                              *([] if uniforms is None else [uniforms]))
        ctx.meta = (bvh, perms, seed, ss, BSDF, n_samples_x)
        mf = m[:, None].float()
        tracing.count('shadow_rays', mf, n2)
        return diff * mf, spec * mf

    @staticmethod
    def backward(ctx, g_diff, g_spec):
        (base, pos, nrm, view, kd, ks, m, ro, rows, cols, pdf,
         guide) = ctx.saved_tensors[:12]
        uniforms = ctx.saved_tensors[12] if len(ctx.saved_tensors) > 12 \
            else None
        bvh, perms, seed, ss, BSDF, n_samples_x = ctx.meta
        P = m.shape[0]
        n2 = n_samples_x * n_samples_x
        m_row = m[None].float()
        gb8 = pallas_shade.lobe_rows(pos, nrm, view, kd, ks)
        gb = torch.cat([ro.T, pos.T, nrm.T, view.T, kd.T, ks.T,
                        m_row]).contiguous()
        g6 = torch.cat([g_diff.T * m_row, g_spec.T * m_row]).contiguous()
        tables = (rows, cols, guide, pdf, base)
        all_o, m2 = _ray_origins(m, ro)
        occlusion_fn = tracer.make_occlusion_fn()
        strata = _Strata(uniforms, seed, P, n_samples_x, perms, pos.device)
        dgb = torch.zeros((pallas_shade.DGB_ROWS, P), device=pos.device)
        d_base = torch.zeros_like(base)
        for i in range(n2):
            samp = pallas_shade.sample_all(strata.draw(i), gb8, *tables,
                                           n_samples_x)
            vis = _visibility(samp[0], all_o, m2, bvh, occlusion_fn, ss)
            dgb_i, drad = pallas_shade.shade_bwd(samp, gb, vis[None], g6,
                                                 BSDF, 1.0 / n2)
            dgb = dgb + dgb_i
            d_base = d_base + pallas_shade.light_scatter(
                drad, base.shape[0], base.shape[1])
        d = [dgb[3 * k:3 * k + 3].T for k in range(5)]
        return (d_base,) + tuple(d) + (None,) * 13


def _ray_origins(m, ro):
    """Both ray sets' origins [2P, 3] (masked pixels at BIG, which never
    hit) and the mask of their directions [2P, 1]."""
    origins = torch.where(m[:, None], ro, BIG)
    return torch.cat([origins, origins]), torch.cat([m, m])[:, None]


def _visibility(samp, all_o, m2, bvh, occlusion_fn, ss):
    """[2P] visibility of stratum samp's light and BSDF rays (one trace;
    masked pixels get a zero direction), lerped by the shadow scale."""
    P = samp.shape[1]
    all_d = torch.where(m2, samp[0:6].reshape(2, 3, P).transpose(1, 2)
                        .reshape(2 * P, 3), 0.0).contiguous()
    return (~occlusion_fn(all_o, all_d, bvh)).float() * ss + (1.0 - ss)


def _env_shade_loop(mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks,
                    light_base, light_pdf_tex, rows, cols, bvh, perms,
                    rnd_seed, shadow_scale, BSDF, n_samples_x, uniforms,
                    bwd=None):
    """The O(P)-memory stratum loop: per stratum the sample kernel on that
    stratum's uniforms, one trace of both ray sets, the fused pipeline's
    shading; its backward walks the strata again (_EnvShadeLoop)."""
    B, H, W = mask.shape
    P = B * H * W
    m = mask.detach().reshape(P) > 0
    pos, nrm, view, kd, ks = (x.reshape(P, 3) for x in
                              (gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks))
    diff, spec = _EnvShadeLoop.apply(
        light_base.contiguous(), pos, nrm, view, kd, ks, m,
        ro.detach().reshape(P, 3), rows.detach().contiguous(),
        cols.detach().contiguous(), light_pdf_tex.detach().contiguous(),
        bvh, perms, rnd_seed, uniforms, float(shadow_scale), BSDF,
        n_samples_x, bwd)
    return diff.reshape(B, H, W, 3), spec.reshape(B, H, W, 3)


def make_perms(n_samples_x, n_tables=32768, seed=0x5eed, device=None):
    """Host-side stratified-permutation tables [n_tables, n^2] int64."""
    device = resolve(device)
    rng = np.random.RandomState(seed)
    n2 = n_samples_x * n_samples_x
    return torch.as_tensor(np.argsort(rng.rand(n_tables, n2), axis=-1),
                           device=device)
