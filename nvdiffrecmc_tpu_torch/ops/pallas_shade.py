"""Monte-Carlo environment shading: sampling, shadow-ray tracing and
demodulated shading, and their backward (counterpart of
nvdiffrecmc_tpu/ops/pallas_shade.py).

Four kernels, each beside its plain PyTorch version:

- `sample_all` (csrc/sample.cu; plain: `sample_all_plain`): per (stratum,
  pixel), one light-importance sample by inverting the row CDF and then that
  row's column CDF, one BSDF sample (cosine or GGX-VNDF lobe), the MIS pdf
  sums, the nearest-texel radiance of both directions and their texel ids.
- `trace_shade` (csrc/shade.cu; plain: `trace_shade_plain`): per pixel,
  for every stratum in order, trace the light ray then the BSDF ray (any
  hit, from `ro`), and accumulate the demodulated diffuse and specular
  radiance with visibility and with everything visible.  The visibility of
  every ray is returned as `visw` so the backward never re-traces.
- `shade_bwd` (csrc/shade_bwd.cu; plain: `shade_bwd_plain`): the adjoint
  of the per-stratum shading given the visibility, for the G-buffer rows
  and each ray's radiance.
- `light_scatter` (csrc/light_scatter.cu; plain: `light_scatter_plain`):
  each ray's radiance cotangent added into the texel it read.

`env_shade_fused` is an autograd Function over those: the forward samples
and traces, the backward replays the sampling from the saved uniforms,
applies the shadow lerp to the saved visibility, and runs shade backward
and the light scatter.  Uniforms come from outside ([n2, 8, P],
`make_uniforms`) so the JAX package and the port can consume the same
random numbers.  The light tables are read in float32 (the TPU kernels
round the column CDF, the pdf, the radiance and the light gradient to bf16
inside their one-hot matmuls; the port does not).

Layouts at the public functions follow the JAX package: u8 [n2, 8, P]
(u0..u4, cell_l, cell_b, pad), gb8 [8, P] (nrm3, wo3, alpha, p_diffuse),
samp [n2, 16, P] (S_* rows below), gb [19, P] (GB_* rows), drad [n2, 8, P]
(d_lrad3, d_brad3, tex_l, tex_b)."""

import math

import torch

from .. import kernels
from . import tracer
from .envshade import _luminance, _spec_albedo, _kensler_permute_pow2
from .vecmath import clip_split, maximum_split

TWO_PI = 2.0 * math.pi
ONE_MINUS_EPS = 0.99999994
BIG = 3e37

# rows of the samp array
S_LDIR, S_BDIR, S_LPDF, S_BPDF = 0, 3, 6, 7
S_LRAD, S_BRAD, S_LTEX, S_BTEX = 8, 11, 14, 15

# rows of the gb pack read by trace_shade
GB_RO, GB_POS, GB_NRM, GB_VIEW, GB_KD, GB_KS, GB_MASK = 0, 3, 6, 9, 12, 15, 18
GB_ROWS = 19


# ---------------------------------------------------------------------------
# Scalar math in component form (a 3-vector is a tuple of tensors).  The
# CUDA sources compute the same expressions in the same order.
# ---------------------------------------------------------------------------

def acos_poly(x):
    ax = torch.abs(x)
    p = ((-0.0187293 * ax + 0.0742610) * ax - 0.2121144) * ax + 1.5707288
    r = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * p
    return torch.where(x >= 0.0, r, math.pi - r)


def atan2_poly(y, x):
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    t = mn / torch.clamp(mx, min=1e-30)
    s = t * t
    r = ((-0.0464964749 * s + 0.15931422) * s - 0.327622764) * s * t + t
    r = torch.where(ay > ax, 0.5 * math.pi - r, r)
    r = torch.where(x < 0.0, math.pi - r, r)
    return torch.where(y < 0.0, -r, r)


def dir_to_uv(dx, dy, dz):
    u = atan2_poly(dx, -dz) / TWO_PI + 0.5
    v = acos_poly(torch.clamp(dy, -1.0, 1.0)) / math.pi
    return u, v


def uv_to_dir(u, v):
    phi = (u * 2.0 - 1.0) * math.pi
    theta = v * math.pi
    st = torch.sin(theta)
    return (st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi))


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def normalize3(a, eps=1e-20):
    inv = torch.rsqrt(torch.clamp(dot3(a, a), min=eps))
    return (a[0] * inv, a[1] * inv, a[2] * inv)


def onb(n):
    nx, ny, nz = n
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    b1 = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    b2 = (b, sign + ny * ny * a, -ny)
    return b1, b2


def _ndf_ggx(alpha, ct):
    a2 = alpha * alpha
    d = (ct * a2 - ct) * ct + 1.0
    return a2 / (d * d * math.pi)


def _g1_ggx(alpha_sqr, ct):
    c2 = ct * ct
    t2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha_sqr * t2))
    return torch.where(ct > 0.0, g, 0.0)


def ggx_pdf_c(n, wo, wi, alpha):
    w = normalize3(n)
    u, v = onb(w)
    wo_l = (dot3(wo, u), dot3(wo, v), dot3(wo, w))
    wi_l = (dot3(wi, u), dot3(wi, v), dot3(wi, w))
    m = normalize3((wi_l[0] + wo_l[0], wi_l[1] + wo_l[1], wi_l[2] + wo_l[2]))
    woDotH = dot3(m, wo_l)
    D = _ndf_ggx(alpha, m[2])
    G1 = _g1_ggx(alpha * alpha, wo_l[2])
    pdf = G1 * D * torch.clamp(woDotH, min=0.0) / torch.clamp(wo_l[2], min=1e-12)
    pdf = pdf / torch.clamp(4.0 * woDotH, min=1e-12)
    ok = (wo_l[2] > 0.0) & (wi_l[2] > 0.0)
    return torch.where(ok, pdf, 0.0)


def _acc_pdf(pdf, opdf, b):
    return pdf + torch.where(b > 1e-6, opdf * b, 0.0)


def bsdf_pdf_c(p_diffuse, n, wo, wi, alpha):
    NdotL = dot3(n, wi)
    NdotV = dot3(n, wo)
    cosine_pdf = torch.clamp(NdotL, min=0.0) / math.pi
    g_pdf = ggx_pdf_c(n, wo, wi, alpha)
    pdf = _acc_pdf(torch.zeros_like(NdotL), cosine_pdf, p_diffuse)
    pdf = _acc_pdf(pdf, g_pdf, 1.0 - p_diffuse)
    return torch.where(torch.minimum(NdotV, NdotL) < 1e-6, 1.0, pdf)


def cosine_sample_c(n, u, v):
    nn = normalize3(n)
    dx, dy = onb(nn)
    phi = TWO_PI * u
    ct = torch.sqrt(v)
    st = torch.sqrt(torch.clamp(1.0 - v, min=0.0))
    x = torch.cos(phi) * st
    y = torch.sin(phi) * st
    pdf = torch.clamp(ct / math.pi, min=1e-6)
    vec = tuple(dx[k] * x + dy[k] * y + nn[k] * ct for k in range(3))
    return normalize3(vec), pdf


def ggx_sample_c(n, wo, u, v, alpha):
    w = normalize3(n)
    uax, vax = onb(w)
    wo_l = normalize3((dot3(wo, uax), dot3(wo, vax), dot3(wo, w)))
    cosNO = wo_l[2]

    Vh = normalize3((alpha * wo_l[0], alpha * wo_l[1], wo_l[2]))
    lensq = Vh[0] * Vh[0] + Vh[1] * Vh[1]
    inv_len = torch.rsqrt(torch.clamp(lensq, min=1e-30))
    near_z = Vh[2] >= 0.9999
    T1 = (torch.where(near_z, 1.0, -Vh[1] * inv_len),
          torch.where(near_z, 0.0, Vh[0] * inv_len),
          torch.zeros_like(Vh[2]))
    T2 = cross3(Vh, T1)

    r = torch.sqrt(u)
    phi = TWO_PI * v
    t1 = r * torch.cos(phi)
    t2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + Vh[2])
    t2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - t1 * t1, min=0.0)) + s * t2
    t3 = torch.sqrt(torch.clamp(1.0 - t1 * t1 - t2 * t2, min=0.0))
    Nh = tuple(T1[k] * t1 + T2[k] * t2 + Vh[k] * t3 for k in range(3))
    h = normalize3((alpha * Nh[0], alpha * Nh[1], torch.clamp(Nh[2], min=0.0)))

    G1 = _g1_ggx(alpha * alpha, wo_l[2])
    D = _ndf_ggx(alpha, h[2])
    woDotH = dot3(wo_l, h)
    pdf = G1 * D * torch.clamp(woDotH, min=0.0) / torch.clamp(wo_l[2], min=1e-12)
    wi_l = tuple(h[k] * 2.0 * woDotH - wo_l[k] for k in range(3))
    pdf = pdf / torch.clamp(4.0 * woDotH, min=1e-12)
    wi = normalize3(tuple(uax[k] * wi_l[0] + vax[k] * wi_l[1] + w[k] * wi_l[2]
                          for k in range(3)))
    front = cosNO > 0.0
    return (tuple(torch.where(front, c, 0.0) for c in wi),
            torch.where(front, pdf, 0.0))


def bsdf_sample_c(p_diffuse, n, wo, u, v, z, alpha):
    d_dir, d_pdf = cosine_sample_c(n, u, v)
    d_pdf = d_pdf * p_diffuse
    d_pdf = _acc_pdf(d_pdf, ggx_pdf_c(n, wo, d_dir, alpha), 1.0 - p_diffuse)
    nn = normalize3(n)
    deg = p_diffuse < 1e-4
    d_dir = tuple(torch.where(deg, nc, dc) for nc, dc in zip(nn, d_dir))
    d_pdf = torch.where(deg, 1.0, d_pdf)

    s_dir, s_pdf = ggx_sample_c(n, wo, u, v, alpha)
    s_pdf = s_pdf * (1.0 - p_diffuse)
    cosine_pdf = torch.clamp(dot3(n, s_dir), min=0.0) / math.pi
    s_pdf = _acc_pdf(s_pdf, cosine_pdf, p_diffuse)

    take_d = z < p_diffuse
    out = tuple(torch.where(take_d, dc, sc) for dc, sc in zip(d_dir, s_dir))
    return out, torch.where(take_d, d_pdf, s_pdf)


# ---------------------------------------------------------------------------
# Sampling (kernel 2)
# ---------------------------------------------------------------------------

def _invert_cdf(flat, row_off, K, x):
    """Invert the CDFs flat[row_off : row_off + K] at x.  The index is
    count(cdf <= x) clamped to K-1, found by binary search (the CDFs are
    non-decreasing).  Returns (idx float, pdf, frac)."""
    x = torch.clamp(x, max=ONE_MINUS_EPS)
    lo = torch.zeros_like(row_off)
    hi = torch.full_like(row_off, K)
    for _ in range(int(K).bit_length()):
        active = lo < hi
        mid = (lo + hi) // 2
        go = flat[row_off + torch.clamp(mid, max=K - 1)] <= x
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    idx = torch.clamp(lo, max=K - 1)
    hi_v = flat[row_off + idx]
    lo_v = torch.where(idx > 0, flat[row_off + torch.clamp(idx - 1, min=0)],
                       0.0)
    pdf = hi_v - lo_v
    frac = torch.clamp((x - lo_v) / torch.clamp(pdf, min=1e-12),
                       max=ONE_MINUS_EPS)
    return idx, pdf, frac


def sample_all_plain(u8, gb8, rows, cols, pdf_tex, base, n_samples_x):
    """Plain PyTorch version of the sample kernel.  Returns samp [n2,16,P]."""
    Hl, Wl = cols.shape
    u0, u1, u2, u3, u4, cell_l, cell_b = (u8[:, k] for k in range(7))
    nrm = (gb8[0][None], gb8[1][None], gb8[2][None])
    wo = (gb8[3][None], gb8[4][None], gb8[5][None])
    alpha = gb8[6][None]
    p_diffuse = gb8[7][None]

    n = float(n_samples_x)
    sx = (cell_l - n * torch.floor(cell_l / n) + u0) / n
    sy = (torch.floor(cell_l / n) + u1) / n

    zero = torch.zeros(sy.shape, dtype=torch.int64, device=sy.device)
    y, pdf_row, ry = _invert_cdf(rows.reshape(-1), zero, Hl, sy)
    yi = y.to(torch.int64)
    x, pdf_col, rx = _invert_cdf(cols.reshape(-1), yi * Wl, Wl, sx)
    xi = x.to(torch.int64)
    uu = (x.float() + rx) / Wl
    vv = (y.float() + ry) / Hl
    l_dir = uv_to_dir(uu, vv)
    w_solid = (Wl * Hl) / (2.0 * math.pi * math.pi
                           * torch.clamp(torch.sin(vv * math.pi), min=1e-4))
    l_pdf = pdf_row * pdf_col * w_solid
    l_bsdf_pdf = bsdf_pdf_c(p_diffuse, nrm, wo, l_dir, alpha)

    bx = (cell_b - n * torch.floor(cell_b / n) + u2) / n
    by = (torch.floor(cell_b / n) + u3) / n
    b_dir, b_pdf = bsdf_sample_c(p_diffuse, nrm, wo, bx, by, u4, alpha)

    ub, vb = dir_to_uv(*b_dir)
    x2 = torch.clamp(torch.clamp(torch.floor(ub * Wl), max=float(Wl - 1)),
                     min=0.0)
    y2 = torch.clamp(torch.clamp(torch.floor(vb * Hl), max=float(Hl - 1)),
                     min=0.0)
    x2i, y2i = x2.to(torch.int64), y2.to(torch.int64)
    w2 = (Wl * Hl) / (2.0 * math.pi * math.pi
                      * torch.clamp(torch.sin(vb * math.pi), min=1e-4))
    b_light_pdf = pdf_tex.reshape(-1)[y2i * Wl + x2i] * w2

    base_f = base.reshape(-1, 3)
    l_rad = base_f[yi * Wl + xi]
    b_rad = base_f[y2i * Wl + x2i]
    rows16 = [l_dir[0], l_dir[1], l_dir[2], b_dir[0], b_dir[1], b_dir[2],
              l_pdf + l_bsdf_pdf, b_light_pdf + b_pdf,
              l_rad[..., 0], l_rad[..., 1], l_rad[..., 2],
              b_rad[..., 0], b_rad[..., 1], b_rad[..., 2],
              (yi * Wl + xi).float(), (y2i * Wl + x2i).float()]
    return torch.stack(rows16, dim=1)


def _sample_cuda(u8, gb8, rows, cols, pdf_tex, base, n_samples_x):
    n2, _, P = u8.shape
    Hl, Wl = cols.shape
    dev = u8.device
    f32 = torch.float32
    kernels.require(u8, 'u8', f32, (n_samples_x * n_samples_x, 8, P))
    kernels.require(gb8, 'gb8', f32, (8, P), dev)
    kernels.require(rows, 'rows', f32, (Hl,), dev)
    kernels.require(cols, 'cols', f32, (Hl, Wl), dev)
    kernels.require(pdf_tex, 'pdf_tex', f32, (Hl, Wl), dev)
    kernels.require(base, 'base', f32, (Hl, Wl, 3), dev)
    out = torch.empty((n2, 16, P), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels.lib().nvk_sample(
            u8.data_ptr(), gb8.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            pdf_tex.data_ptr(), base.data_ptr(), out.data_ptr(), n_samples_x,
            P, Hl, Wl, kernels.stream_ptr(u8))
    kernels.LAUNCHES['sample'] += 1
    kernels.check(rc, 'nvk_sample')
    return out


def sample_all(u8, gb8, rows, cols, pdf_tex, base, n_samples_x):
    """Stage A: u8 [n2, 8, P]; gb8 [8, P]; rows [Hl]; cols/pdf_tex
    [Hl, Wl]; base [Hl, Wl, 3].  Returns samp [n2, 16, P]."""
    if u8.is_cuda:
        return _sample_cuda(u8, gb8, rows, cols, pdf_tex, base, n_samples_x)
    return sample_all_plain(u8, gb8, rows, cols, pdf_tex, base, n_samples_x)


def make_uniforms(generator, n2, P, n_samples_x, perms=None, device=None):
    """[n2, 8, P]: rows 0-4 uniforms, 5/6 stratified cell ids (Kensler
    permutation for power-of-two strata, else table-based), row 7 zero."""
    u = torch.rand((n2, 5, P), generator=generator, device=device)
    n2i = n_samples_x * n_samples_x
    pow2 = (n2i & (n2i - 1)) == 0
    table = not pow2 and perms is not None
    hi = perms.shape[0] if table else 2 ** 31 - 1
    light_perm = torch.randint(0, hi, (P,), generator=generator, device=device)
    bsdf_perm = torch.randint(0, hi, (P,), generator=generator, device=device)
    if table:
        cell_l = perms[light_perm][:, :n2].T
        cell_b = perms[bsdf_perm][:, :n2].T
    else:
        idx = torch.arange(n2, device=device)[:, None]
        cell_l = _kensler_permute_pow2(idx, n2i, light_perm[None])
        cell_b = _kensler_permute_pow2(idx, n2i, bsdf_perm[None])
    cells = torch.stack([cell_l.float(), cell_b.float()], dim=1)
    pad = torch.zeros((n2, 1, P), device=device)
    return torch.cat([u, cells, pad], dim=1)


# ---------------------------------------------------------------------------
# Demodulated BSDF and per-stratum shading
# ---------------------------------------------------------------------------

SPECULAR_EPSILON = 1e-4
MIN_ROUGHNESS = 0.08


# the shading's clamps split the gradient at a tie as JAX's do; a tie is
# real at roughness 0.08 (0.08f * 0.08f == 0.0064f)
def _clip01(x):
    return clip_split(x, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)


def eval_demodulated_c(kd, ks, pos, nrm, view, wi, BSDF):
    """Returns (diffuse scalar, specular 3-tuple) for direction wi.
    BSDF: 0 = pbr, 1 = diffuse, 2 = white (Lambert only)."""
    diff = maximum_split(dot3(nrm, wi), 0.0) / math.pi
    if BSDF != 0:
        z = torch.zeros_like(diff)
        return diff, (z, z, z)

    wo = normalize3((view[0] - pos[0], view[1] - pos[1], view[2] - pos[2]))
    occ, rough, metal = ks
    alpha = clip_split(rough * rough, MIN_ROUGHNESS * MIN_ROUGHNESS, 1.0)
    alpha_sqr = alpha * alpha
    spec_col = tuple((0.04 * (1.0 - metal) + kd_c * metal) * (1.0 - occ)
                     for kd_c in kd)

    h = normalize3((wo[0] + wi[0], wo[1] + wi[1], wo[2] + wi[2]))
    woDotN = dot3(wo, nrm)
    wiDotN = dot3(wi, nrm)
    woDotH = dot3(wo, h)
    nDotH = dot3(nrm, h)

    _c = _clip01(nDotH)
    d_ = (_c * alpha_sqr - _c) * _c + 1.0
    D = alpha_sqr / (d_ * d_ * math.pi)

    def lam(ct):
        c = _clip01(ct)
        c2 = c * c
        return 0.5 * (torch.sqrt(1.0 + alpha_sqr * (1.0 - c2) / c2) - 1.0)

    G = 1.0 / (1.0 + lam(woDotN) + lam(wiDotN))
    fc = torch.pow(1.0 - _clip01(woDotH), 5.0)
    w = D * G * 0.25 / maximum_split(woDotN, SPECULAR_EPSILON)
    front = ((woDotN > SPECULAR_EPSILON)
             & (wiDotN > SPECULAR_EPSILON)).to(diff.dtype)
    spec = tuple((sc + (1.0 - sc) * fc) * w * front for sc in spec_col)
    return diff, spec


def _shade_stratum(samp16, gb, vis_l, vis_b, BSDF, sample_frac):
    """One stratum's (diff3, spec3) contribution.  samp16: [16, P] or a
    list of its 16 rows; gb: dict of component rows; vis_* [P] in [0, 1]."""
    l_dir = (samp16[0], samp16[1], samp16[2])
    b_dir = (samp16[3], samp16[4], samp16[5])
    l_mis = 1.0 / torch.clamp(samp16[6], min=1e-4)
    b_mis = 1.0 / torch.clamp(samp16[7], min=1e-4)
    l_rad = (samp16[8], samp16[9], samp16[10])
    b_rad = (samp16[11], samp16[12], samp16[13])

    out_d = [0.0, 0.0, 0.0]
    out_s = [0.0, 0.0, 0.0]
    for wi, mis, rad, vis in ((l_dir, l_mis, l_rad, vis_l),
                              (b_dir, b_mis, b_rad, vis_b)):
        dd, ss = eval_demodulated_c(gb['kd'], gb['ks'], gb['pos'],
                                    gb['nrm'], gb['view'], wi, BSDF)
        wgt = vis * mis * sample_frac
        for c in range(3):
            out_d[c] = out_d[c] + dd * (rad[c] * wgt)
            out_s[c] = out_s[c] + ss[c] * (rad[c] * wgt)
    return tuple(out_d), tuple(out_s)


def _gb_rows(gb):
    def v3(k):
        return (gb[k], gb[k + 1], gb[k + 2])
    return dict(ro=v3(GB_RO), pos=v3(GB_POS), nrm=v3(GB_NRM),
                view=v3(GB_VIEW), kd=v3(GB_KD), ks=v3(GB_KS),
                mask=gb[GB_MASK])


# ---------------------------------------------------------------------------
# Trace + shade forward (kernel 3)
# ---------------------------------------------------------------------------

def trace_shade_plain(samp, gb, bvh, BSDF=0, tmin=0.0):
    """Plain PyTorch version of the trace+shade kernel.  samp [n2, 16, P];
    gb [19, P] (GB_* rows).  Returns out [12, P] (diff|spec with
    visibility, then diff|spec all-visible; zero at masked pixels) and
    visw [n2, 2P] (light rays, then BSDF rays; 1 = unoccluded)."""
    n2, _, P = samp.shape
    g = _gb_rows(gb)
    m = g['mask'] > 0.0
    idx = torch.nonzero(m)[:, 0]
    ro = gb[GB_RO:GB_RO + 3].T[idx]
    out = torch.zeros((12, P), device=samp.device)
    visw = torch.ones((n2, 2 * P), device=samp.device)
    ones = torch.ones(P, device=samp.device)
    for s in range(n2):
        l_dir = samp[s, S_LDIR:S_LDIR + 3].T[idx]
        b_dir = samp[s, S_BDIR:S_BDIR + 3].T[idx]
        occ = tracer.any_hit(torch.cat([ro, ro]), torch.cat([l_dir, b_dir]),
                             bvh, tmin=tmin)
        n = idx.shape[0]
        visw[s, idx] = 1.0 - occ[:n].float()
        visw[s, P + idx] = 1.0 - occ[n:].float()
        d_v, s_v = _shade_stratum(samp[s], g, visw[s, :P], visw[s, P:], BSDF,
                                  1.0 / n2)
        d_a, s_a = _shade_stratum(samp[s], g, ones, ones, BSDF, 1.0 / n2)
        out = out + torch.stack(d_v + s_v + d_a + s_a)
    return torch.where(m[None], out, 0.0), visw


def _trace_shade_cuda(samp, gb, bvh, BSDF, tmin):
    n2, _, P = samp.shape
    dev = samp.device
    f32 = torch.float32
    L, C = bvh.leaf_size, bvh.n_leaves
    S = bvh.super_lo.shape[0]
    kernels.require(samp, 'samp', f32, (n2, 16, P))
    kernels.require(gb, 'gb', f32, (GB_ROWS, P), dev)
    kernels.require(bvh.tri, 'bvh.tri', f32, (C * L, 24), dev)
    kernels.require(bvh.aabb_lo, 'bvh.aabb_lo', f32, (C, 3), dev)
    kernels.require(bvh.aabb_hi, 'bvh.aabb_hi', f32, (C, 3), dev)
    kernels.require(bvh.super_lo, 'bvh.super_lo', f32, (S, 3), dev)
    kernels.require(bvh.super_hi, 'bvh.super_hi', f32, (S, 3), dev)
    out = torch.empty((12, P), dtype=f32, device=dev)
    visw = torch.empty((n2, 2 * P), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels.lib().nvk_trace_shade(
            samp.data_ptr(), gb.data_ptr(), bvh.tri.data_ptr(),
            bvh.aabb_lo.data_ptr(), bvh.aabb_hi.data_ptr(),
            bvh.super_lo.data_ptr(), bvh.super_hi.data_ptr(), out.data_ptr(),
            visw.data_ptr(), n2, P, C, S, L, int(BSDF), float(tmin),
            kernels.stream_ptr(samp))
    kernels.LAUNCHES['trace_shade'] += 1
    kernels.check(rc, 'nvk_trace_shade')
    return out, visw


def trace_shade(samp, gb, bvh, BSDF=0, tmin=0.0):
    """Stage C: see trace_shade_plain for the contract."""
    if samp.is_cuda:
        return _trace_shade_cuda(samp, gb, bvh, BSDF, tmin)
    return trace_shade_plain(samp, gb, bvh, BSDF, tmin)


# ---------------------------------------------------------------------------
# Shade backward (kernel 5) and light scatter (kernel 6)
# ---------------------------------------------------------------------------

DGB_ROWS = 15    # rows of dgb: d(pos3, nrm3, view3, kd3, ks3)


def shade_bwd_plain(samp, gb, vw, g6, BSDF=0):
    """Plain PyTorch version of the shade-backward kernel: torch.autograd
    .grad of `_shade_stratum`, stratum by stratum.  samp [n2, 16, P]; gb
    [19, P]; vw [n2, 2P] (visibility after the shadow lerp); g6 [6, P]
    (d_diffuse, d_specular).  Returns dgb [15, P] and drad [n2, 8, P];
    masked pixels get zeros."""
    n2, _, P = samp.shape
    g = _gb_rows(gb)
    covered = g['mask'] > 0.0
    keys = ('pos', 'nrm', 'view', 'kd', 'ks')
    leaves = {k: tuple(r.detach().clone().requires_grad_() for r in g[k])
              for k in keys}
    flat = [r for k in keys for r in leaves[k]]
    dgb = torch.zeros((DGB_ROWS, P), device=samp.device)
    drad = torch.zeros((n2, 8, P), device=samp.device)
    for s in range(n2):
        rows16 = [samp[s, k] for k in range(16)]
        rad = [samp[s, S_LRAD + k].detach().clone().requires_grad_()
               for k in range(6)]
        rows16[S_LRAD:S_LRAD + 6] = rad
        with torch.enable_grad():
            d3, s3 = _shade_stratum(rows16, dict(g, **leaves), vw[s, :P],
                                    vw[s, P:], BSDF, 1.0 / n2)
            loss = sum((g6[c] * d3[c]).sum() + (g6[3 + c] * s3[c]).sum()
                       for c in range(3))
            grads = torch.autograd.grad(loss, flat + rad, allow_unused=True)
        grads = [torch.zeros(P, device=samp.device) if x is None else x
                 for x in grads]
        dgb = dgb + torch.stack(grads[:DGB_ROWS])
        drad[s, 0:6] = torch.stack(grads[DGB_ROWS:])
        drad[s, 6:8] = samp[s, S_LTEX:S_LTEX + 2]
    dgb = torch.where(covered[None], dgb, 0.0)
    drad[:, 0:6] = torch.where(covered[None, None], drad[:, 0:6], 0.0)
    return dgb, drad


def _shade_bwd_cuda(samp, gb, vw, g6, BSDF):
    n2, _, P = samp.shape
    dev = samp.device
    f32 = torch.float32
    kernels.require(samp, 'samp', f32, (n2, 16, P))
    kernels.require(gb, 'gb', f32, (GB_ROWS, P), dev)
    kernels.require(vw, 'vw', f32, (n2, 2 * P), dev)
    kernels.require(g6, 'g6', f32, (6, P), dev)
    dgb = torch.empty((DGB_ROWS, P), dtype=f32, device=dev)
    drad = torch.empty((n2, 8, P), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels.lib().nvk_shade_bwd(
            samp.data_ptr(), gb.data_ptr(), vw.data_ptr(), g6.data_ptr(),
            dgb.data_ptr(), drad.data_ptr(), n2, P, int(BSDF),
            kernels.stream_ptr(samp))
    kernels.LAUNCHES['shade_bwd'] += 1
    kernels.check(rc, 'nvk_shade_bwd')
    return dgb, drad


def shade_bwd(samp, gb, vw, g6, BSDF=0):
    """Stage C': see shade_bwd_plain for the contract."""
    if samp.is_cuda:
        return _shade_bwd_cuda(samp, gb, vw, g6, BSDF)
    return shade_bwd_plain(samp, gb, vw, g6, BSDF)


def light_scatter_plain(drad, Hl, Wl):
    """Plain PyTorch version of the light-scatter kernel (index_add_, the
    twin of the JAX package's light_scatter_jnp).  drad [n2, 8, P] ->
    d_base [Hl, Wl, 3], in drad's dtype."""
    out = torch.zeros((Hl * Wl, 3), dtype=drad.dtype, device=drad.device)
    for ray in range(2):
        tex = drad[:, 6 + ray].long().reshape(-1)
        gr = drad[:, 3 * ray:3 * ray + 3].permute(0, 2, 1).reshape(-1, 3)
        out.index_add_(0, tex, gr)
    return out.reshape(Hl, Wl, 3)


def _light_scatter_cuda(drad, Hl, Wl):
    n2, _, P = drad.shape
    kernels.require(drad, 'drad', torch.float32, (n2, 8, P))
    out = torch.zeros((Hl, Wl, 3), dtype=torch.float32, device=drad.device)
    with torch.cuda.device(drad.device):
        rc = kernels.lib().nvk_light_scatter(
            drad.data_ptr(), out.data_ptr(), n2, P, Hl * Wl,
            kernels.stream_ptr(drad))
    kernels.LAUNCHES['light_scatter'] += 1
    kernels.check(rc, 'nvk_light_scatter')
    return out


def light_scatter(drad, Hl, Wl):
    """Stage D: drad [n2, 8, P] -> d_base [Hl, Wl, 3]."""
    if drad.is_cuda:
        return _light_scatter_cuda(drad, Hl, Wl)
    return light_scatter_plain(drad, Hl, Wl)


# ---------------------------------------------------------------------------
# The fused env shade: forward A (sample) -> C (trace + shade); backward A
# (replayed) -> C' (shade adjoint, no re-trace) -> D (light scatter)
# ---------------------------------------------------------------------------

class _EnvShadeFused(torch.autograd.Function):
    """Differentiable in (base, pos, nrm, view, kd, ks), each [P, 3] but
    base [Hl, Wl, 3]; every other input is treated as a constant (the
    shadow boundary, the ray origins and the sampling get no gradient, as
    in the reference, kernel.cu:96-99)."""

    @staticmethod
    def forward(ctx, base, pos, nrm, view, kd, ks, u8, gb8, ro, m_row, rows,
                cols, pdf, bvh, ss, BSDF, n_samples_x, tmin):
        samp = sample_all(u8, gb8, rows, cols, pdf, base, n_samples_x)
        gb = torch.cat([ro.T, pos.T, nrm.T, view.T, kd.T, ks.T,
                        m_row]).contiguous()
        out, visw = trace_shade(samp, gb, bvh, BSDF, tmin)
        # the samples are replayed in backward, not kept (n2 * 16 * P)
        ctx.save_for_backward(base, visw, gb, u8, gb8, rows, cols, pdf)
        ctx.meta = (ss, BSDF, n_samples_x)
        diff = (ss * out[0:3] + (1.0 - ss) * out[6:9]) * m_row
        spec = (ss * out[3:6] + (1.0 - ss) * out[9:12]) * m_row
        return diff.T, spec.T

    @staticmethod
    def backward(ctx, g_diff, g_spec):
        base, visw, gb, u8, gb8, rows, cols, pdf = ctx.saved_tensors
        ss, BSDF, n_samples_x = ctx.meta
        samp = sample_all(u8, gb8, rows, cols, pdf, base, n_samples_x)
        vw = visw * ss + (1.0 - ss)
        m_row = gb[GB_MASK:GB_MASK + 1]
        g6 =torch.cat([g_diff.T * m_row, g_spec.T * m_row]).contiguous()
        dgb, drad = shade_bwd(samp, gb, vw.contiguous(), g6, BSDF)
        d_base = light_scatter(drad, base.shape[0], base.shape[1])
        d = [dgb[3 * k:3 * k + 3].T for k in range(5)]
        return (d_base,) + tuple(d) + (None,) * 12


def env_shade_fused(mask, ro, gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks,
                    light_base, light_pdf_tex, rows, cols, bvh, perms,
                    rnd_seed, shadow_scale, BSDF=0, n_samples_x=8, tmin=0.0,
                    uniforms=None):
    """Monte-Carlo direct lighting.  mask [B,H,W]; ro/gb_* [B,H,W,3];
    light tables as light.update_pdf; uniforms [n2, 8, P] or None (then
    drawn from a generator seeded with rnd_seed).  Returns the demodulated
    (diffuse, specular) [B,H,W,3], differentiable in light_base, gb_pos,
    gb_normal, gb_view_pos, gb_kd and gb_ks."""
    B, H, W = mask.shape
    P = B * H * W
    dev = gb_pos.device
    n2 = n_samples_x * n_samples_x
    m_row = (mask.detach().reshape(1, P) > 0).float()
    pos, nrm, view, kd, ks = (x.reshape(P, 3) for x in
                              (gb_pos, gb_normal, gb_view_pos, gb_kd, gb_ks))
    ro_f = ro.detach().reshape(P, 3)

    # lobe-selection quantities (no gradient, kernel.cu:495-502)
    with torch.no_grad():
        wo = view - pos
        wo = wo / torch.clamp(torch.linalg.vector_norm(wo, dim=-1,
                                                       keepdim=True),
                              min=1e-20)
        alpha = ks[:, 1] * ks[:, 1]
        metallic = ks[:, 2]
        spec_col = 0.04 * (1.0 - metallic[:, None]) + kd * metallic[:, None]
        dw = (1.0 - metallic) * _luminance(kd)
        sw = _spec_albedo(spec_col, wo, nrm)
        denom = dw + sw
        p_diffuse = torch.where(denom > 0.0,
                                dw / torch.clamp(denom, min=1e-20), 1.0)
        gb8 = torch.cat([nrm.T, wo.T, alpha[None],
                         p_diffuse[None]]).contiguous()

    if uniforms is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(rnd_seed))
        uniforms = make_uniforms(gen, n2, P, n_samples_x, perms, device=dev)
    diff, spec = _EnvShadeFused.apply(
        light_base.contiguous(), pos, nrm, view, kd, ks,
        uniforms.contiguous(), gb8, ro_f, m_row, rows.detach().contiguous(),
        cols.detach().contiguous(), light_pdf_tex.detach().contiguous(), bvh,
        float(shadow_scale), BSDF, n_samples_x, tmin)
    return diff.reshape(B, H, W, 3), spec.reshape(B, H, W, 3)
