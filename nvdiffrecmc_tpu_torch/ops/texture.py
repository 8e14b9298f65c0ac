"""Mip-mapped texture sampling (counterpart of
nvdiffrecmc_tpu/ops/texture.py).

Every bilinear tap reads its four corners, and every trilinear tap its
eight, with one `pallas_scatter.rows_gather` call, so the texture gradient
is one row scatter (a CUDA kernel on the card), as in the JAX package.  The
JAX package's 2x2 corner-patch encoding is a TPU tactic (its gathers cost
per row) and is not carried over.  The mip level is chosen without a
gradient; gradients flow through the blend weights and the texels."""

import numpy as np
import torch

from ..device import constant
from .pallas_scatter import rows_gather
from .vecmath import bilinear_at


class _Mip(torch.autograd.Function):
    """2x2 average pooling whose backward is the reference's: the output
    gradient times 0.25, bilinearly upsampled with a clamped border
    (nvdiffrecmc_tpu/ops/texture.py _mip_bwd)."""

    @staticmethod
    def forward(ctx, tex):
        n, h, w, c = tex.shape
        ctx.shape = tex.shape
        return tex.reshape(n, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))

    @staticmethod
    def backward(ctx, dout):
        n, h, w, c = ctx.shape
        dev = dout.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h \
            * (h // 2) - 0.5
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w \
            * (w // 2) - 0.5
        return bilinear_at(dout * 0.25, ys, xs)


def texture2d_mip(tex):
    """Downsample [N,H,W,C] by 2x2 average pooling."""
    return _Mip.apply(tex)


def build_mip_chain(tex):
    """List of mips [N,H,W,C] down to 1x1 (pow2 dims)."""
    mips = [tex]
    while mips[-1].shape[1] > 1 and mips[-1].shape[2] > 1:
        mips.append(texture2d_mip(mips[-1]))
    return mips


def _wrap_uv(u, n, mode):
    if mode == 'wrap':
        return torch.remainder(u, n)
    return torch.minimum(torch.clamp(u, min=0), n - 1)


def _tap_indices(x, y, h, w, boundary_mode):
    """Bilinear tap corners and fractions at level resolution (h, w); h and
    w are ints or per-pixel int tensors."""
    wf = w.float() if torch.is_tensor(w) else float(w)
    hf = h.float() if torch.is_tensor(h) else float(h)
    xs = x * wf - 0.5
    ys = y * hf - 0.5
    x0f = torch.floor(xs)
    y0f = torch.floor(ys)
    fx = (xs - x0f)[..., None]
    fy = (ys - y0f)[..., None]
    x0i = x0f.to(torch.int64)
    y0i = y0f.to(torch.int64)
    if not torch.is_tensor(w):
        w = torch.full_like(x0i, w)
        h = torch.full_like(y0i, h)
    x0 = _wrap_uv(x0i, w, boundary_mode)
    y0 = _wrap_uv(y0i, h, boundary_mode)
    x1 = _wrap_uv(x0i + 1, w, boundary_mode)
    y1 = _wrap_uv(y0i + 1, h, boundary_mode)
    return x0, x1, y0, y1, fx, fy


def _blend(a, b, c, d, fx, fy):
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def bilinear_sample(tex, uv, boundary_mode='wrap'):
    """Sample [N,H,W,C] texture at uv [N,h,w,2]; texel centers at
    (i+0.5)/W, boundary wrap or clamp (dr.texture filter_mode='linear')."""
    n, H, W, C = tex.shape
    x0, x1, y0, y1, fx, fy = _tap_indices(uv[..., 0], uv[..., 1], H, W,
                                          boundary_mode)
    # collapsed taps (clamp beyond the border) read one texel, unblended
    fx = torch.where((x1 == x0)[..., None], 0.0, fx)
    fy = torch.where((y1 == y0)[..., None], 0.0, fy)
    base = (torch.arange(n, device=tex.device) * (H * W))[:, None, None]
    idx = torch.stack([base + y0 * W + x0, base + y0 * W + x1,
                       base + y1 * W + x0, base + y1 * W + x1], dim=-1)
    abcd = rows_gather(tex.reshape(n * H * W, C), idx)     # [N,h,w,4,C]
    return _blend(abcd[..., 0, :], abcd[..., 1, :], abcd[..., 2, :],
                  abcd[..., 3, :], fx, fy)


def _pack_mips(mips):
    """Flatten a mip list into ([N, L, C] texels, sizes, offsets)."""
    n, c = mips[0].shape[0], mips[0].shape[3]
    flat = torch.cat([m.reshape(n, -1, c) for m in mips], dim=1)
    sizes = np.array([[m.shape[1], m.shape[2]] for m in mips], dtype=np.int64)
    offsets = np.concatenate(
        [[0], np.cumsum(sizes[:, 0] * sizes[:, 1])])[:-1].astype(np.int64)
    return flat, sizes, offsets


def texture_sample(mips, uv, uv_da=None, filter_mode='linear-mipmap-linear',
                   boundary_mode='wrap'):
    """Trilinear mip-mapped sampling.  mips: list of [N,H,W,C]; uv
    [N,h,w,2]; uv_da [N,h,w,4] = (du/dX, dv/dX, du/dY, dv/dY)."""
    if filter_mode == 'linear' or len(mips) == 1 or uv_da is None:
        return bilinear_sample(mips[0], uv, boundary_mode)

    n, H, W, C = mips[0].shape
    n_levels = len(mips)
    dx = torch.stack([uv_da[..., 0] * W, uv_da[..., 1] * H], dim=-1)
    dy = torch.stack([uv_da[..., 2] * W, uv_da[..., 3] * H], dim=-1)
    footprint = torch.maximum(torch.sum(dx * dx, -1), torch.sum(dy * dy, -1))
    lod = 0.5 * torch.log2(torch.clamp(footprint, min=1e-20))
    lod = torch.clamp(lod, 0.0, n_levels - 1.0).detach()
    l0 = torch.clamp(torch.floor(lod).to(torch.int64), 0, n_levels - 1)
    l1 = torch.clamp(l0 + 1, 0, n_levels - 1)
    frac = (lod - l0.float())[..., None]

    flat, sizes, offsets = _pack_mips(mips)
    dev = uv.device
    sizes_t = constant(sizes, torch.int64, dev)
    offsets_t = constant(offsets, torch.int64, dev)
    L = flat.shape[1]
    bbase = (torch.arange(n, device=dev) * L)[:, None, None]
    x, y = uv[..., 0], uv[..., 1]
    idx, fxy = [], []
    for lvl in (l0, l1):
        h, w = sizes_t[lvl, 0], sizes_t[lvl, 1]
        off = offsets_t[lvl] + bbase
        x0, x1, y0, y1, fx, fy = _tap_indices(x, y, h, w, boundary_mode)
        idx += [off + y0 * w + x0, off + y0 * w + x1,
                off + y1 * w + x0, off + y1 * w + x1]
        fxy.append((fx, fy))
    # the eight corners of both levels in one gather (one scatter backward)
    c8 = rows_gather(flat.reshape(n * L, C), torch.stack(idx, dim=-1))
    taps = [_blend(c8[..., 4 * k, :], c8[..., 4 * k + 1, :],
                   c8[..., 4 * k + 2, :], c8[..., 4 * k + 3, :], *fxy[k])
            for k in range(2)]
    return taps[0] * (1 - frac) + taps[1] * frac


def texture_sample_multi(mips_list, uv, uv_da=None,
                         filter_mode='linear-mipmap-linear',
                         boundary_mode='wrap'):
    """Sample several same-resolution mip pyramids with one tap set.
    Returns a list of sampled [N,h,w,C_i], one per pyramid."""
    chans = [m[0].shape[-1] for m in mips_list]
    cat = [torch.cat([m[k] for m in mips_list], dim=-1)
           for k in range(len(mips_list[0]))]
    out = texture_sample(cat, uv, uv_da, filter_mode, boundary_mode)
    offs = np.concatenate([[0], np.cumsum(chans)])
    return [out[..., offs[i]:offs[i + 1]] for i in range(len(mips_list))]
