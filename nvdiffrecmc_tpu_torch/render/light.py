"""HDR lat-long environment light and its importance-sampling tables
(counterpart of nvdiffrecmc_tpu/render/light.py).  Radiance .hdr files are
read and written with numpy (flat and adaptive-RLE scanlines)."""

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..device import resolve
from ..ops import vecmath
from ..ops.texture import bilinear_sample


def create_trainable_env_rnd(base_res, scale=0.5, bias=0.25, seed=0,
                             device=None):
    """A [base_res, base_res, 3] light: uniform noise * scale + bias, from
    numpy's RandomState(seed) as in the JAX package."""
    device = resolve(device)
    rng = np.random.RandomState(seed)
    base = rng.rand(base_res, base_res, 3).astype(np.float32) * scale + bias
    return torch.as_tensor(base, device=device)


def generate_image(base, res):
    """The probe bilinearly resampled to a lat-long image [res0, res1, 3]."""
    texcoord = vecmath.pixel_grid(res[1], res[0], device=base.device)
    return bilinear_sample(base[None], texcoord[None])[0]


def pdf_scale(base):
    return (base.shape[0] * base.shape[1]) / (2.0 * math.pi * math.pi)


class LightTables(NamedTuple):
    pdf: torch.Tensor    # [H, W] normalized sampling pdf (sums to 1)
    rows: torch.Tensor   # [H] row CDF
    cols: torch.Tensor   # [H, W] per-row column CDFs


def update_pdf(base):
    """Sampling tables from the probe: pdf = max(base, channel) *
    sin(theta), normalized; cols = per-row cumsum; rows = cumsum of row
    sums; both CDFs normalized."""
    with tracing.span('light.tables'):
        base = base.detach()
        H = base.shape[0]
        Y = (torch.arange(H, dtype=torch.float32, device=base.device)
             + 0.5) / H
        pdf = torch.amax(base, dim=-1) * torch.sin(Y * math.pi)[:, None]
        pdf = pdf / torch.clamp(torch.sum(pdf), min=1e-20)

        cols = torch.cumsum(pdf, dim=1)
        rows = torch.cumsum(cols[:, -1], dim=0)

        col_tot = cols[:, -1:]
        cols = cols / torch.where(col_tot > 0, col_tot,
                                  torch.ones_like(col_tot))
        row_tot = rows[-1]
        rows = rows / torch.where(row_tot > 0, row_tot,
                                  torch.ones_like(row_tot))
        return LightTables(pdf=pdf, rows=rows, cols=cols)


def _decode_scanlines(payload, H, W):
    """RGBE scanlines -> uint8 [H, W, 4]."""
    img = np.zeros((H, W, 4), dtype=np.uint8)
    buf = payload
    p = 0
    for y in range(H):
        if (buf[p] == 2 and buf[p + 1] == 2
                and (buf[p + 2] << 8 | buf[p + 3]) == W):
            p += 4
            for c in range(4):
                row = img[y, :, c]
                x = 0
                while x < W:
                    cnt = buf[p]
                    p += 1
                    if cnt > 128:    # run
                        row[x:x + cnt - 128] = buf[p]
                        p += 1
                        x += cnt - 128
                    else:            # literal
                        row[x:x + cnt] = np.frombuffer(buf, np.uint8, cnt, p)
                        p += cnt
                        x += cnt
        else:                        # flat scanline
            img[y] = np.frombuffer(buf, np.uint8, 4 * W, p).reshape(W, 4)
            p += 4 * W
    return img


def _read_hdr(path):
    with open(path, 'rb') as f:
        data = f.read()
    if not (data.startswith(b'#?RADIANCE') or data.startswith(b'#?RGBE')):
        raise ValueError('not a Radiance HDR file: %s' % path)
    pos = data.find(b'\n\n')
    if pos < 0:
        raise ValueError('bad HDR header')
    res_end = data.find(b'\n', pos + 2)
    res = data[pos + 2:res_end].split()
    if res[0] != b'-Y' or res[2] != b'+X':
        raise ValueError('unsupported HDR orientation %r' % b' '.join(res))
    H, W = int(res[1]), int(res[3])
    rgbe = _decode_scanlines(data[res_end + 1:], H, W).astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e.astype(np.int32) - 136), 0.0)
    return np.where(e[..., None] > 0, (rgbe[..., :3] + 0.5) * scale[..., None],
                    0.0)


def _rle_channel(x):
    """One channel of a scanline (uint8 [W]) as adaptive-RLE bytes: runs of
    4 or more equal bytes as (128 + n, byte), n <= 127; the rest as
    literal (n, bytes...), n <= 128."""
    W = x.shape[0]
    starts = np.flatnonzero(np.concatenate(([True], x[1:] != x[:-1])))
    lengths = np.diff(np.append(starts, W))
    out = bytearray()

    def literal(a, b):
        for s in range(a, b, 128):
            e = min(s + 128, b)
            out.append(e - s)
            out.extend(x[s:e].tobytes())
    done = 0
    for s, n in zip(starts[lengths >= 4], lengths[lengths >= 4]):
        literal(done, s)
        for k in range(0, n, 127):
            out.append(128 + min(n - k, 127))
            out.append(int(x[s]))
        done = s + n
    literal(done, W)
    return bytes(out)


def _write_hdr(path, img):
    """float [H, W, 3] as a Radiance .hdr: RGBE with the exponent of the
    largest channel, mantissas floored; adaptive-RLE scanlines for widths
    8-32767, flat ones otherwise."""
    img = np.asarray(img, dtype=np.float32)
    H, W, _ = img.shape
    maxc = np.max(img, axis=-1)
    e = np.zeros((H, W), np.int32)
    m = maxc > 1e-32
    e[m] = np.ceil(np.log2(maxc[m])).astype(np.int32) + 1
    scale = np.ldexp(1.0, -e + 8)
    rgbe = np.zeros((H, W, 4), np.uint8)
    with np.errstate(invalid='ignore'):
        q = np.clip(np.floor(img * scale[..., None]), 0, 255).astype(np.uint8)
    rgbe[..., :3] = np.where(m[..., None], q, 0)
    rgbe[..., 3] = np.where(m, e + 128, 0).astype(np.uint8)
    with open(path, 'wb') as f:
        f.write(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n')
        f.write(('-Y %d +X %d\n' % (H, W)).encode())
        if not 8 <= W <= 32767:
            f.write(rgbe.tobytes())
            return
        head = bytes((2, 2, W >> 8, W & 255))
        for y in range(H):
            f.write(head + b''.join(_rle_channel(rgbe[y, :, c])
                                    for c in range(4)))


def save_env_map(fn, base):
    """The probe as a 512 x 1024 lat-long .hdr."""
    with torch.no_grad():
        color = generate_image(base, [512, 1024])
    _write_hdr(fn, color.cpu().numpy())


def load_env(fn, scale=1.0, device=None):
    """Load an .hdr probe as a float32 [H, W, 3] tensor."""
    device = resolve(device)
    ext = os.path.splitext(fn)[1].lower()
    assert ext == '.hdr', 'Unknown envlight extension %s' % ext
    img = _read_hdr(fn) * scale
    return torch.as_tensor(np.asarray(img, dtype=np.float32), device=device)
