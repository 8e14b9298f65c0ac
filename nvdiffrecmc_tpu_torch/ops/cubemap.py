"""Cubemap prefiltering (counterpart of nvdiffrecmc_tpu/ops/cubemap.py):
the diffuse (cosine) and specular (GGX NDF) convolutions of a cubemap over
the whole sphere, each texel weighted by its solid angle and the result
normalized by the accumulated weight.  No path of either package calls
them; the reference ships their wrappers without kernels.

The convolution is built for `chunk` output texels at a time, as the JAX
package builds it: weights [chunk, N] from the texel directions, then one
[chunk, N] @ [N, 4] product against the cubemap (N = 6 res^2) with the
weight as a fourth channel.  The product is torch.matmul: JAX computes it
outside any Pallas kernel.  Gradients flow to the cubemap through the
product; the weights depend only on the texel geometry."""

import functools

import numpy as np
import torch

from ..device import resolve

# face -> (axis, u axis, v axis): direction = normalize(n + u ue + v ve),
# in OpenGL's cubemap order +x, -x, +y, -y, +z, -z
_FACES = [
    ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, -1.0, 0.0)),
    ((-1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, -1.0, 0.0)),
    ((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)),
    ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, -1.0)),
    ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
    ((0.0, 0.0, -1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0)),
]


def cubemap_dirs(res, device=None):
    """Unit direction of every texel centre: [6, res, res, 3] float32."""
    t = (np.arange(res, dtype=np.float64) + 0.5) / res * 2.0 - 1.0
    v, u = np.meshgrid(t, t, indexing='ij')     # v = row, u = column
    out = np.zeros((6, res, res, 3))
    for f, (n, ue, ve) in enumerate(_FACES):
        d = (np.asarray(n)[None, None] + u[..., None] * np.asarray(ue)
             + v[..., None] * np.asarray(ve))
        out[f] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(out.astype(np.float32), device=resolve(device))


def _area_elem(x, y):
    return np.arctan2(x * y, np.sqrt(x * x + y * y + 1.0))


def cubemap_solid_angles(res, device=None):
    """Exact solid angle of every texel: [6, res, res] float32 (the same on
    every face; 4 pi in all)."""
    g = np.arange(res + 1, dtype=np.float64) / res * 2.0 - 1.0
    yy, xx = np.meshgrid(g, g, indexing='ij')
    a = _area_elem(xx, yy)
    sa = a[1:, 1:] - a[1:, :-1] - a[:-1, 1:] + a[:-1, :-1]
    return torch.as_tensor(np.broadcast_to(sa[None], (6, res, res))
                           .astype(np.float32), device=resolve(device))


def _convolve(cubemap, weight_fn, chunk=2048):
    """out[i] = sum_j w(d_i . d_j) sa_j cubemap[j] / sum_j w sa_j, for
    chunk output texels at a time; weight_fn maps cos(theta) [chunk, N]
    to nonnegative weights."""
    res = cubemap.shape[1]
    N = 6 * res * res
    dirs = cubemap_dirs(res, cubemap.device).reshape(N, 3)
    sa = cubemap_solid_angles(res, cubemap.device).reshape(N)
    rgba = torch.cat([cubemap.reshape(N, 3),
                      torch.ones((N, 1), dtype=cubemap.dtype,
                                 device=cubemap.device)], dim=-1)
    rgba = rgba * sa[:, None]
    out = torch.cat([weight_fn(d @ dirs.T) @ rgba
                     for d in dirs.split(chunk)])
    rgb = out[:, 0:3] / torch.clamp(out[:, 3:4], min=1e-20)
    return rgb.reshape(6, res, res, 3)


def diffuse_cubemap(cubemap, chunk=2048):
    """The cosine-convolved irradiance of cubemap [6, res, res, 3]; the
    same shape."""
    return _convolve(cubemap, lambda ct: torch.clamp(ct, min=0.0),
                     chunk=chunk)


def _ndf_ggx(alpha_sqr, ct):
    ct = torch.clamp(ct, 0.0, 1.0)
    d = (ct * alpha_sqr - ct) * ct + 1.0
    return alpha_sqr / (d * d * np.pi)


@functools.lru_cache(maxsize=None)
def _ndf_cutoff(roughness, cutoff):
    """cos(theta) that holds `cutoff` of the GGX NDF's energy, by the
    reference's numpy cumsum."""
    n = 1000000
    ct = np.cos(np.linspace(0, np.pi / 2.0, n))
    a2 = roughness ** 4
    d = (ct * a2 - ct) * ct + 1.0
    dens = a2 / (d * d * np.pi)
    D = np.cumsum(dens)
    idx = int(np.argmax(D >= D[-1] * cutoff))
    return float(ct[idx])


def specular_cubemap(cubemap, roughness, cutoff=0.99, chunk=2048):
    """cubemap [6, res, res, 3] prefiltered by the GGX NDF at roughness;
    the weight is zero past the angle that holds `cutoff` of the NDF (the
    same integral as the reference's bounded loop)."""
    if not (cubemap.shape[0] == 6 and cubemap.shape[1] == cubemap.shape[2]):
        raise ValueError('bad shape for a cubemap: %s'
                         % (tuple(cubemap.shape),))
    ct_min = _ndf_cutoff(float(roughness), float(cutoff))
    a2 = float(roughness) ** 4

    def w(ct):
        return torch.where(ct >= ct_min, _ndf_ggx(a2, ct),
                           torch.zeros_like(ct))

    return _convolve(cubemap, w, chunk=chunk)
