"""Small vector / image math helpers (PyTorch counterpart of
nvdiffrecmc_tpu/ops/vecmath.py): NHWC images, host-side numpy camera
matrices."""

import numpy as np
import torch


def dot(x, y):
    """Channelwise dot product over the last axis, keepdims."""
    return torch.sum(x * y, dim=-1, keepdim=True)


def length(x, eps=1e-20):
    return torch.sqrt(torch.clamp(dot(x, x), min=eps))


def safe_normalize(x, eps=1e-20):
    return x / length(x, eps)


def pixel_grid(width, height, device=None):
    """[H, W, 2] grid of normalized pixel-center coordinates (x, y) in [0,1]."""
    y = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    x = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    yy, xx = torch.meshgrid(y, x, indexing='ij')
    return torch.stack((xx, yy), dim=-1)


# ---------------------------------------------------------------------------
# sRGB transforms
# ---------------------------------------------------------------------------

def _rgb_to_srgb(f):
    return torch.where(
        f <= 0.0031308, f * 12.92,
        torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055)


def rgb_to_srgb(f):
    if f.shape[-1] == 4:
        return torch.cat((_rgb_to_srgb(f[..., 0:3]), f[..., 3:4]), dim=-1)
    return _rgb_to_srgb(f)


def _srgb_to_rgb(f):
    return torch.where(
        f <= 0.04045, f / 12.92,
        torch.pow((torch.clamp(f, min=0.04045) + 0.055) / 1.055, 2.4))


def srgb_to_rgb(f):
    if f.shape[-1] == 4:
        return torch.cat((_srgb_to_rgb(f[..., 0:3]), f[..., 3:4]), dim=-1)
    return _srgb_to_rgb(f)


# ---------------------------------------------------------------------------
# Image scaling (NHWC)
# ---------------------------------------------------------------------------

def avg_pool_nhwc(x, size):
    """Average pooling with window `size` (int or (h, w))."""
    if isinstance(size, int):
        size = (size, size)
    n, h, w, c = x.shape
    x = x.reshape(n, h // size[0], size[0], w // size[1], size[1], c)
    return x.mean(dim=(2, 4))


def _nearest_resize(x, H, W):
    n, h, w, c = x.shape
    ri = torch.clamp((torch.arange(H, device=x.device) * h) // H, 0, h - 1)
    ci = torch.clamp((torch.arange(W, device=x.device) * w) // W, 0, w - 1)
    return x[:, ri][:, :, ci]


def scale_img_nhwc(x, size, mag='bilinear', min='area'):
    """Resize an NHWC image to `size` = (H, W).  The port carries the
    nearest-neighbour mode the MSAA path uses; the bilinear and area modes
    of the JAX package are not ported yet and raise."""
    n, h, w, c = x.shape
    H, W = int(size[0]), int(size[1])
    if h == H and w == W:
        return x
    mode = min if (h > H and w > W) else mag
    if mode != 'nearest':
        raise NotImplementedError('scale_img_nhwc: mode %r is not ported'
                                  % mode)
    return _nearest_resize(x, H, W)


# ---------------------------------------------------------------------------
# Camera / matrix helpers (host-side numpy)
# ---------------------------------------------------------------------------

def perspective(fovy=0.7854, aspect=1.0, n=0.1, f=1000.0):
    y = np.tan(fovy / 2)
    return np.array([[1 / (y * aspect), 0, 0, 0],
                     [0, 1 / -y, 0, 0],
                     [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
                     [0, 0, -1, 0]], dtype=np.float32)


def translate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (x, y, z)
    return m


def rotate_x(a):
    s, c = np.sin(a), np.cos(a)
    return np.array([[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def rotate_y(a):
    s, c = np.sin(a), np.cos(a)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def random_rotation_translation(t, rng=None):
    rng = rng or np.random
    m = rng.normal(size=[3, 3])
    m[1] = np.cross(m[0], m[2])
    m[2] = np.cross(m[0], m[1])
    m = m / np.linalg.norm(m, axis=1, keepdims=True)
    m = np.pad(m, [[0, 1], [0, 1]], mode='constant')
    m[3, 3] = 1.0
    m[:3, 3] = rng.uniform(-t, t, size=[3])
    return m.astype(np.float32)
