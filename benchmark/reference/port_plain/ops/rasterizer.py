"""Triangle rasterizer with depth peeling, and attribute interpolation
(counterpart of nvdiffrecmc_tpu/ops/rasterizer.py; same homogeneous,
clipless coverage test and the same output conventions):

- pixel (row r, col c) center maps to NDC (2(c+.5)/W - 1, 2(r+.5)/H - 1);
- rast [N, H, W, 4] = (u, v, z/w, float(tri_id + 1)); empty pixels 0;
- u weights vertex 0, v vertex 1, 1-u-v vertex 2.

The discrete resolve is ops/pallas_raster.py (a CUDA kernel on the card);
barycentrics and their screen derivatives are recomputed here for the
winning triangle.  Every vertex and face gather goes through
pallas_scatter.rows_gather(_b), whose backward is the row scatter kernel."""

from typing import Optional

import torch

from . import pallas_raster
from .pallas_scatter import rows_gather, rows_gather_b


def _tri_setup(v_clip, tri):
    """Per-triangle coefficients.  v_clip [V, 4]; tri [T, 3].
    Returns A [T, 3, 3] (adjugate rows), az [T, 3], asum [T, 3], det [T],
    valid [T]."""
    p = v_clip[tri.long()]                            # [T, 3, 4]
    x, y, z, w = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    a00 = y[:, 1] * w[:, 2] - y[:, 2] * w[:, 1]
    a01 = x[:, 2] * w[:, 1] - x[:, 1] * w[:, 2]
    a02 = x[:, 1] * y[:, 2] - x[:, 2] * y[:, 1]
    a10 = y[:, 2] * w[:, 0] - y[:, 0] * w[:, 2]
    a11 = x[:, 0] * w[:, 2] - x[:, 2] * w[:, 0]
    a12 = x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2]
    a20 = y[:, 0] * w[:, 1] - y[:, 1] * w[:, 0]
    a21 = x[:, 1] * w[:, 0] - x[:, 0] * w[:, 1]
    a22 = x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0]
    A = torch.stack([a00, a01, a02, a10, a11, a12, a20, a21, a22],
                    dim=-1).reshape(-1, 3, 3)
    det = x[:, 0] * a00 + y[:, 0] * a01 + w[:, 0] * a02
    det_safe = torch.where(torch.abs(det) > 1e-20, det,
                           torch.full_like(det, 1e-20))
    az = (A[:, 0] * z[:, 0:1] + A[:, 1] * z[:, 1:2]
          + A[:, 2] * z[:, 2:3]) / det_safe[:, None]
    asum = A[:, 0] + A[:, 1] + A[:, 2]
    valid = torch.abs(det) > 1e-12
    return A, az, asum, det, valid


def _recompute_bary(v_clip, tri, tid, H, W):
    """(u, v, z) + screen derivatives for the winning triangles.
    v_clip [N, V, 4]; tid [N, H, W] int32 (tri_id + 1, 0 empty)."""
    t = torch.clamp(tid.long() - 1, 0, tri.shape[0] - 1)
    tv = tri.long()[t]                                # [N, H, W, 3]
    p = rows_gather_b(v_clip, tv)                     # [N, H, W, 3, 4]
    x, y, z, w = p[..., 0], p[..., 1], p[..., 2], p[..., 3]

    a0 = torch.stack([y[..., 1] * w[..., 2] - y[..., 2] * w[..., 1],
                      x[..., 2] * w[..., 1] - x[..., 1] * w[..., 2],
                      x[..., 1] * y[..., 2] - x[..., 2] * y[..., 1]], -1)
    a1 = torch.stack([y[..., 2] * w[..., 0] - y[..., 0] * w[..., 2],
                      x[..., 0] * w[..., 2] - x[..., 2] * w[..., 0],
                      x[..., 2] * y[..., 0] - x[..., 0] * y[..., 2]], -1)
    a2 = torch.stack([y[..., 0] * w[..., 1] - y[..., 1] * w[..., 0],
                      x[..., 1] * w[..., 0] - x[..., 0] * w[..., 1],
                      x[..., 0] * y[..., 1] - x[..., 1] * y[..., 0]], -1)

    sx, sy = pallas_raster._pixel_ndc_xy(H, W, v_clip.device)
    px = sx[None, None, :]
    py = sy[None, :, None]

    def edge(a):
        return a[..., 0] * px + a[..., 1] * py + a[..., 2]
    e0, e1, e2 = edge(a0), edge(a1), edge(a2)
    s = e0 + e1 + e2
    tiny = torch.full_like(s, 1e-15)
    s_safe = torch.where(torch.abs(s) > 1e-15, s,
                         torch.where(s >= 0, tiny, -tiny))
    u = e0 / s_safe
    v = e1 / s_safe
    det = x[..., 0] * a0[..., 0] + y[..., 0] * a0[..., 1] + w[..., 0] * a0[..., 2]
    det = torch.where(torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20))
    zndc = (e0 * z[..., 0] + e1 * z[..., 1] + e2 * z[..., 2]) / det

    def duv(axis):
        de0, de1 = a0[..., axis], a1[..., axis]
        ds = a0[..., axis] + a1[..., axis] + a2[..., axis]
        du = (de0 * s - e0 * ds) / (s_safe * s_safe)
        dv = (de1 * s - e1 * ds) / (s_safe * s_safe)
        return du, dv

    dudx, dvdx = duv(0)
    dudy, dvdy = duv(1)
    scale_x = 2.0 / W
    scale_y = 2.0 / H
    db = torch.stack([dudx * scale_x, dudy * scale_y,
                      dvdx * scale_x, dvdy * scale_y], dim=-1)
    mask = (tid > 0)[..., None]
    rast = torch.where(mask, torch.stack([u, v, zndc, tid.float()], -1),
                       0.0)
    return rast, torch.where(mask, db, 0.0)


def rasterize(v_clip, tri, resolution, prev_rast: Optional[torch.Tensor] = None):
    """v_clip [N, V, 4]; tri [T, 3] int32; resolution (H, W); prev_rast:
    the previous depth-peel layer's rast (None for layer 0).
    Returns (rast [N,H,W,4], rast_db [N,H,W,4])."""
    H, W = int(resolution[0]), int(resolution[1])
    N = v_clip.shape[0]
    dev = v_clip.device
    if prev_rast is None:
        prev_z = torch.full((N, H * W), -1e30, device=dev)
        prev_id = torch.zeros((N, H * W), dtype=torch.int32, device=dev)
    else:
        pz = prev_rast[..., 2].reshape(N, H * W)
        pid = prev_rast[..., 3].reshape(N, H * W).to(torch.int32)
        # pixels empty in the previous layer stay empty
        prev_z = torch.where(pid > 0, pz, torch.full_like(pz, 1e30))
        prev_id = pid
    z, tid = pallas_raster.resolve_batch(v_clip, tri, H, W, prev_z, prev_id)
    return _recompute_bary(v_clip, tri, tid, H, W)


def interpolate(attr, rast, attr_idx, rast_db=None):
    """attr [V, C] or [N, V, C]; rast [N,H,W,4]; attr_idx [T, 3].
    Returns (out [N,H,W,C], out_da [N,H,W,2C] or None)."""
    tid = rast[..., 3].to(torch.int64)
    t = torch.clamp(tid - 1, 0, attr_idx.shape[0] - 1)
    idx = attr_idx.long()[t]                          # [N,H,W,3]
    if attr.dim() == 2:
        av = rows_gather(attr, idx)                   # [N,H,W,3,C]
    else:
        av = rows_gather_b(attr, idx)
    u = rast[..., 0:1]
    v = rast[..., 1:2]
    w = 1.0 - u - v
    out = av[..., 0, :] * u + av[..., 1, :] * v + av[..., 2, :] * w
    mask = (tid > 0)[..., None]
    out = torch.where(mask, out, 0.0)
    if rast_db is None:
        return out, None
    d0 = av[..., 0, :] - av[..., 2, :]
    d1 = av[..., 1, :] - av[..., 2, :]
    dadx = d0 * rast_db[..., 0:1] + d1 * rast_db[..., 2:3]
    dady = d0 * rast_db[..., 1:2] + d1 * rast_db[..., 3:4]
    out_da = torch.where(mask, torch.cat([dadx, dady], dim=-1),
                         0.0)
    return out, out_da


def interpolate_face(attr_face, rast):
    """Per-face attribute [T, C] or [N, T, C] at each pixel: [N,H,W,C]."""
    tid = rast[..., 3].to(torch.int64)
    if attr_face.dim() == 2:
        t = torch.clamp(tid - 1, 0, attr_face.shape[0] - 1)
        av = rows_gather(attr_face, t)
    else:
        t = torch.clamp(tid - 1, 0, attr_face.shape[1] - 1)
        av = rows_gather_b(attr_face, t)
    return torch.where((tid > 0)[..., None], av, 0.0)
