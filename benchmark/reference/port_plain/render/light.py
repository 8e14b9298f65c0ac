"""HDR lat-long environment light and its importance-sampling tables
(counterpart of nvdiffrecmc_tpu/render/light.py).  Radiance .hdr files are
read with numpy (flat and adaptive-RLE scanlines)."""

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve


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
    base = base.detach()
    H = base.shape[0]
    Y = (torch.arange(H, dtype=torch.float32, device=base.device) + 0.5) / H
    pdf = torch.amax(base, dim=-1) * torch.sin(Y * math.pi)[:, None]
    pdf = pdf / torch.clamp(torch.sum(pdf), min=1e-20)

    cols = torch.cumsum(pdf, dim=1)
    rows = torch.cumsum(cols[:, -1], dim=0)

    col_tot = cols[:, -1:]
    cols = cols / torch.where(col_tot > 0, col_tot, torch.ones_like(col_tot))
    row_tot = rows[-1]
    rows = rows / torch.where(row_tot > 0, row_tot, torch.ones_like(row_tot))
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


def load_env(fn, scale=1.0, device=None):
    """Load an .hdr probe as a float32 [H, W, 3] tensor."""
    device = resolve(device)
    ext = os.path.splitext(fn)[1].lower()
    assert ext == '.hdr', 'Unknown envlight extension %s' % ext
    img = _read_hdr(fn) * scale
    return torch.as_tensor(np.asarray(img, dtype=np.float32), device=device)
