"""2D texture container with auto or explicit (custom) mip chains,
trainable textures and the image reader (8-bit PNG) (counterpart of
nvdiffrecmc_tpu/render/texture.py).

PNG files are decoded with the standard library's zlib and numpy:
8-bit gray, gray+alpha, RGB and RGBA, non-interlaced, filter types 0-4."""

import dataclasses
import os
import struct
import zlib
from typing import Any

import numpy as np
import torch

from ..device import resolve
from ..ops import texture as tex_ops
from ..ops import vecmath


@dataclasses.dataclass
class Texture2D:
    data: Any                       # [1,H,W,C] tensor or list of them (mips)
    min_max: Any = None             # (min [C], max [C]) or None

    def getRes(self):
        return self.getMips()[0].shape[1:3]

    def getMips(self):
        return self.data if isinstance(self.data, list) else [self.data]

    def buildMips(self):
        """The effective mip list (auto chain for a single base level)."""
        if isinstance(self.data, list):
            return self.data
        d = self.data
        if d.shape[1] > 1 and d.shape[2] > 1:
            return tex_ops.build_mip_chain(d)
        return [d]

    def sample(self, texc, texc_deriv=None,
               filter_mode='linear-mipmap-linear'):
        return tex_ops.texture_sample(self.buildMips(), texc, texc_deriv,
                                      filter_mode)

    def _replace_mips(self, new):
        return dataclasses.replace(
            self, data=new if isinstance(self.data, list) else new[0])

    def clamp(self):
        """A copy projected onto min_max (the post-step projection)."""
        if self.min_max is None:
            return self
        C = self.getMips()[0].shape[-1]
        mn, mx = (torch.as_tensor(b, dtype=torch.float32,
                                  device=self.getMips()[0].device)[:C]
                  for b in self.min_max)
        return self._replace_mips([torch.clamp(m, mn, mx)
                                   for m in self.getMips()])

    def normalize(self):
        """A copy with every texel scaled to unit length."""
        return self._replace_mips([vecmath.safe_normalize(m)
                                   for m in self.getMips()])


def create_trainable(init, res=None, auto_mipmaps=True, min_max=None,
                     device=None):
    """A Texture2D whose data is a fresh tensor, resized to res (bilinear
    magnification, area minification).  auto_mipmaps: its mips are built
    from it when sampled; else data is the explicit chain (custom mips):
    the base level halved with scale_img_nhwc down to 1x1, every level a
    tensor of its own.  init: an array [C], [H, W, C] or [1, H, W, C], or
    a Texture2D (its base level, and its min_max unless one is given)."""
    device = resolve(device)
    if isinstance(init, Texture2D):
        min_max = init.min_max if min_max is None else min_max
        init = init.getMips()[0]
    init = _to_nhwc(init, device)
    if res is not None:
        init = vecmath.scale_img_nhwc(init, res)
    if auto_mipmaps:
        return Texture2D(data=init.contiguous().clone(), min_max=min_max)
    chain = [init]
    while chain[-1].shape[1] > 1 or chain[-1].shape[2] > 1:
        size = [max(chain[-1].shape[1] // 2, 1),
                max(chain[-1].shape[2] // 2, 1)]
        chain.append(vecmath.scale_img_nhwc(chain[-1], size))
    return Texture2D(data=[m.contiguous().clone() for m in chain],
                     min_max=min_max)


def srgb_to_rgb(texture: Texture2D):
    return texture._replace_mips([vecmath.srgb_to_rgb(m)
                                  for m in texture.getMips()])


_PNG_SIG = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter_paeth(line, prior, bpp):
    out = bytearray(line)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return out


def _unfilter_average(line, prior, bpp):
    out = bytearray(line)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        out[x] = (out[x] + ((a + prior[x]) >> 1)) & 0xFF
    return out


def decode_png(data):
    """Decode PNG bytes into a uint8 array [H, W, C]."""
    if not data.startswith(_PNG_SIG):
        raise ValueError('not a PNG file')
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, ctype = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', body)
        elif ctype == b'IDAT':
            idat.append(body)
        elif ctype == b'IEND':
            break
    if hdr is None:
        raise ValueError('PNG without IHDR')
    W, H, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace != 0:
        raise ValueError('unsupported PNG (depth %d, color type %d, '
                         'interlace %d)' % (depth, color, interlace))
    C = _PNG_CHANNELS[color]
    stride = W * C
    raw = zlib.decompress(b''.join(idat))
    if len(raw) != H * (stride + 1):
        raise ValueError('truncated PNG image data')
    img = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        ftype, line = row[0], np.frombuffer(row[1:], np.uint8)
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(W, C).astype(np.int64),
                            axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = (line.astype(np.int64) + prior).astype(np.uint8)
        elif ftype == 3:      # Average
            cur = np.frombuffer(_unfilter_average(line.tobytes(),
                                                  prior.tobytes(), C), np.uint8)
        elif ftype == 4:      # Paeth
            cur = np.frombuffer(_unfilter_paeth(line.tobytes(),
                                                prior.tobytes(), C), np.uint8)
        else:
            raise ValueError('bad PNG filter type %d' % ftype)
        img[y] = cur
        prior = img[y]
    return img.reshape(H, W, C)


def read_image(path):
    """An 8-bit image file as uint8 [H, W, C] (C = 1 for grayscale): PNG or
    JPEG by the file's signature, not its name (the counterpart of the JAX
    package's imageio.v2.imread).  Anything else raises ValueError naming
    the file."""
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(_PNG_SIG):
        try:
            return decode_png(data)
        except ValueError as e:
            raise ValueError('%s: %s' % (path, e)) from e
    if data.startswith(b'\xff\xd8'):
        raise ValueError('the reference reads PNG only: %s' % path)
    raise ValueError('%s: neither a PNG nor a JPEG file (the port reads 8-bit '
                     'PNG and baseline JPEG)' % path)


def load_image(fn):
    """An 8-bit PNG or JPEG -> float32 [H, W, C] in [0, 1]."""
    return read_image(fn).astype(np.float32) / 255.0


def _to_nhwc(init, device):
    init = torch.as_tensor(init, dtype=torch.float32, device=device)
    if init.dim() == 1:
        init = init[None, None, None, :]
    elif init.dim() == 3:
        init = init[None]
    return init


def load_texture2D(fn, lambda_fn=None, channels=None, device=None):
    """The texture at fn, or, where <base>_0<ext> exists, the mip list
    <base>_0<ext>, <base>_1<ext>, ... of a saved mip chain."""
    device = resolve(device)

    def _load(path):
        img = load_image(path)
        if channels is not None:
            img = img[..., 0:channels]
        img = _to_nhwc(img, device)
        return img if lambda_fn is None else lambda_fn(img)
    base, ext = os.path.splitext(fn)
    if os.path.exists(base + '_0' + ext):
        mips = []
        while os.path.exists(base + ('_%d' % len(mips)) + ext):
            mips.append(_load(base + ('_%d' % len(mips)) + ext))
        return Texture2D(data=mips)
    return Texture2D(data=_load(fn))
