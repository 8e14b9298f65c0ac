"""Small vector / image math helpers (PyTorch counterpart of
nvdiffrecmc_tpu/ops/vecmath.py): NHWC images, host-side numpy camera
matrices."""

import numpy as np
import torch

from ..device import resolve


def dot(x, y):
    """Channelwise dot product over the last axis, keepdims."""
    return torch.sum(x * y, dim=-1, keepdim=True)


def reflect(x, n):
    return 2.0 * dot(x, n) * n - x


def length(x, eps=1e-20):
    return torch.sqrt(torch.clamp(dot(x, x), min=eps))


def safe_normalize(x, eps=1e-20):
    return x / length(x, eps)


# At a kink the port's gradients follow the JAX package's: jnp.maximum and
# jnp.clip give half the gradient to each side of a tie (torch.clamp all
# of it to the input), jnp.abs gives +1 at 0 (torch.abs 0).  Kinks are hit
# exactly on the training path: an edge exactly between two pixel
# centers in antialias, alpha = 0.08^2 in the shading, a black pixel in
# shadow equal to a black target in the losses, a constant texture in the
# smoothness terms.
def maximum_split(x, lo):
    return torch.maximum(x, torch.full_like(x, lo))


def clip_split(x, lo, hi):
    return torch.minimum(maximum_split(x, lo), torch.full_like(x, hi))


def abs_pos0(x):
    return torch.where(x >= 0, x, -x)


def pixel_grid(width, height, device=None):
    """[H, W, 2] grid of normalized pixel-center coordinates (x, y) in [0,1]."""
    device = resolve(device)
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
# Metrics (the JAX package's PSNR convention)
# ---------------------------------------------------------------------------

def mse_to_psnr(mse):
    return -10.0 / np.log(10.0) * np.log(mse)


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


def bilinear_at(x, ys, xs):
    """x [N,h,w,C] sampled bilinearly at the fractional rows ys [H] and
    columns xs [W] (texel centers at integers), clamped at the border ->
    [N,H,W,C]."""
    h, w = x.shape[1], x.shape[2]
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    fy = torch.clamp(ys - y0, 0.0, 1.0)[None, :, None, None]
    fx = torch.clamp(xs - x0, 0.0, 1.0)[None, None, :, None]
    a = x[:, y0][:, :, x0]
    b = x[:, y0][:, :, x1]
    cc = x[:, y1][:, :, x0]
    d = x[:, y1][:, :, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + cc * fy * (1 - fx) + d * fy * fx)


def _overlap_matrix(out_n, in_n, device):
    """[out_n, in_n] fractional-overlap weights of output cell i with input
    cell j (each row sums to 1): exact area averaging for any ratio."""
    scale = in_n / out_n
    lo = torch.arange(out_n, device=device)[:, None] * scale
    hi = lo + scale
    j0 = torch.arange(in_n, device=device)[None, :]
    ov = torch.minimum(hi, j0 + 1.0) - torch.maximum(lo, j0)
    return torch.clamp(ov, min=0.0) / scale


def _area_resize(x, H, W):
    """Area-average resize by any ratio: Wy @ x @ Wx^T with the per-axis
    overlap weights."""
    wy = _overlap_matrix(H, x.shape[1], x.device)          # [H, h]
    wx = _overlap_matrix(W, x.shape[2], x.device)          # [W, w]
    y = torch.einsum('Hh,nhwc->nHwc', wy, x)
    return torch.einsum('Ww,nHwc->nHWc', wx, y)


def scale_img_nhwc(x, size, mag='bilinear', min='area'):
    """Resize an NHWC image to `size` = (H, W): magnification bilinear
    (align corners) or nearest, minification nearest or area (average
    pooling for integer ratios, overlap weights for others)."""
    n, h, w, c = x.shape
    H, W = int(size[0]), int(size[1])
    if h == H and w == W:
        return x
    if h > H and w > W:
        if min == 'nearest':
            return _nearest_resize(x, H, W)
        if h % H == 0 and w % W == 0:
            return avg_pool_nhwc(x, (h // H, w // W))
        return _area_resize(x, H, W)
    if mag == 'nearest':
        return _nearest_resize(x, H, W)
    return bilinear_at(x, torch.linspace(0.0, h - 1.0, H, device=x.device),
                       torch.linspace(0.0, w - 1.0, W, device=x.device))


# ---------------------------------------------------------------------------
# Camera / matrix helpers (host-side numpy)
# ---------------------------------------------------------------------------

def dilate(x, x_avg, mask, N):
    """Fill the texels outside mask [1,H,W,1] with the Gaussian-weighted
    average of the masked texels of x [1,H,W,C] in an N x N window (N
    odd), or with x_avg where the window holds none (the seam fill of the
    bake, reference util.py:71-89)."""
    variance = (1.0 / 2.5) ** 2
    g = torch.linspace(-1.0, 1.0, N, device=x.device)
    gy, gx = torch.meshgrid(g, g, indexing='ij')
    kern = (0.5 * np.pi * variance) * torch.exp(
        -(gx ** 2 + gy ** 2) / (2 * variance))
    kern = kern / torch.sum(kern)

    def conv(img):      # depthwise, zero padded to the input's size
        c = img.shape[-1]
        out = torch.nn.functional.conv2d(
            img.permute(0, 3, 1, 2), kern.expand(c, 1, N, N),
            padding=N // 2, groups=c)
        return out.permute(0, 2, 3, 1)

    epsilon = 1e-6
    mask_flt = conv(mask)
    x_flt = conv(x * mask)
    x_flt = torch.where(mask_flt > epsilon,
                        x_flt / torch.clamp(mask_flt, min=epsilon), x_avg)
    return x_flt * (1 - mask) + x * mask


def fovx_to_fovy(fovx, aspect):
    return np.arctan(np.tan(fovx / 2) / aspect) * 2.0


def focal_length_to_fovy(focal_length, sensor_height):
    return 2 * np.arctan(0.5 * sensor_height / focal_length)


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


def scale_mtx(s):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = m[1, 1] = m[2, 2] = s
    return m


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


def lines_focal(o, d):
    """Least-squares focal point of the lines o + t d ([N, 3] each): where
    the views of an LLFF rig look (reference util.py:261-266)."""
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    I = np.eye(3, dtype=o.dtype)
    outer = d[..., :, None] @ d[..., None, :] - I[None]
    S = outer.sum(axis=0)
    C = (outer @ o[..., :, None]).sum(axis=0)[:, 0]
    return np.linalg.pinv(S) @ C


def checkerboard(res, checker_size):
    """[H, W, 3] float32 numpy checkerboard of grey levels 0.33 / 0.66."""
    tiles_y = (res[0] + (checker_size * 2) - 1) // (checker_size * 2)
    tiles_x = (res[1] + (checker_size * 2) - 1) // (checker_size * 2)
    check = np.kron([[1, 0] * tiles_x, [0, 1] * tiles_x] * tiles_y,
                    np.ones((checker_size, checker_size))) * 0.33 + 0.33
    check = check[:res[0], :res[1]]
    return np.stack((check, check, check), axis=-1).astype(np.float32)


def time_to_text(x):
    if x > 3600:
        return "%.2f h" % (x / 3600)
    if x > 60:
        return "%.2f m" % (x / 60)
    return "%.2f s" % x
