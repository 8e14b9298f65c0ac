"""Analytic-edge antialiasing, forward (counterpart of
nvdiffrecmc_tpu/ops/antialias.py): for every horizontal/vertical neighbor
pixel pair whose triangle ids differ, find where the foreground triangle's
silhouette edge crosses the segment between the two centers and blend the
encroached pixel toward its neighbor."""

import torch

from ..device import constant
from .pallas_scatter import rows_gather_b
from .vecmath import clip_split


def _screen_xy(v_clip, H, W):
    """Clip -> pixel coordinates (x right, y down, centers at +0.5)."""
    wc = v_clip[..., 3:4]
    w = torch.where(torch.abs(wc) > 1e-9, wc, torch.full_like(wc, 1e-9))
    ndc = v_clip[..., 0:2] / w
    x = (ndc[..., 0] + 1.0) * (W * 0.5)
    y = (ndc[..., 1] + 1.0) * (H * 0.5)
    return torch.stack([x, y], dim=-1)


def _pair_blend(color, tid, z, tri_xy, axis):
    """Additive correction [N,H,W,C] for neighbor pairs along axis
    (1 = vertical pairs (r, r+1), 2 = horizontal pairs (c, c+1))."""
    N, H, W, C = color.shape
    if axis == 2:
        idp, idq = tid[:, :, :-1], tid[:, :, 1:]
        zp, zq = z[:, :, :-1], z[:, :, 1:]
        cp, cq = color[:, :, :-1], color[:, :, 1:]
    else:
        idp, idq = tid[:, :-1, :], tid[:, 1:, :]
        zp, zq = z[:, :-1, :], z[:, 1:, :]
        cp, cq = color[:, :-1, :], color[:, 1:, :]

    differs = idp != idq
    p_fg = torch.where(idq == 0, True, torch.where(idp == 0, False, zp < zq))
    active = differs & ((idp > 0) | (idq > 0))

    fg_id = torch.where(p_fg, idp, idq)
    fg_t = torch.clamp(fg_id - 1, 0, tri_xy.shape[1] - 1)
    T = tri_xy.shape[1]
    # the gradient of the foreground triangles' vertices is a row scatter
    V = rows_gather_b(tri_xy.reshape(N, T, 6), fg_t).reshape(
        fg_t.shape + (3, 2))                          # [N,h,w,3,2]

    h, w = idp.shape[1], idp.shape[2]
    px = torch.arange(w, dtype=torch.float32, device=color.device)[None, None, :] + 0.5
    py = torch.arange(h, dtype=torch.float32, device=color.device)[None, :, None] + 0.5
    if axis == 2:
        qx, qy = px + 1.0, py
    else:
        qx, qy = px, py + 1.0
    px, py, qx, qy = (t.expand(idp.shape) for t in (px, py, qx, qy))

    a = constant((0, 1, 2), torch.int64, color.device)
    b = constant((1, 2, 0), torch.int64, color.device)
    ax = V[..., a, 0]
    ay = V[..., a, 1]
    bx = V[..., b, 0]
    by = V[..., b, 1]
    ex = bx - ax
    ey = by - ay
    Fp = ex * (py[..., None] - ay) - ey * (px[..., None] - ax)
    Fq = ex * (qy[..., None] - ay) - ey * (qx[..., None] - ax)

    sep = (Fp * Fq) < 0.0
    denom = Fp - Fq
    denom = torch.where(torch.abs(denom) > 1e-12, denom,
                        torch.full_like(denom, 1e-12))
    t_cross = clip_split(Fp / denom, 0.0, 1.0)

    t_from_p = torch.where(sep, t_cross, torch.full_like(t_cross, 2.0))
    t_from_q = torch.where(sep, t_cross, torch.full_like(t_cross, -2.0))
    d = torch.where(p_fg, torch.amin(t_from_p, dim=-1),
                    torch.amax(t_from_q, dim=-1))
    has_edge = torch.where(p_fg, d < 1.5, d > -1.5)
    active = active & has_edge
    d = clip_split(d, 0.0, 1.0)

    # an edge exactly between the two centers (d = 0.5) ties both clamps
    w_p = torch.where(active, clip_split(0.5 - d, 0.0, 0.5), 0.0)[..., None]
    w_q = torch.where(active, clip_split(d - 0.5, 0.0, 0.5), 0.0)[..., None]
    corr_p = (cq - cp) * w_p
    corr_q = (cp - cq) * w_q

    out = torch.zeros_like(color)
    if axis == 2:
        out[:, :, :-1] += corr_p
        out[:, :, 1:] += corr_q
    else:
        out[:, :-1, :] += corr_p
        out[:, 1:, :] += corr_q
    return out


def antialias(color, rast, v_clip, tri):
    """color [N,H,W,C]; rast [N,H,W,4]; v_clip [N,V,4]; tri [T,3]."""
    N, H, W, C = color.shape
    tid = rast[..., 3].detach().to(torch.int64)
    z = rast[..., 2].detach()
    tri_xy = _screen_xy(v_clip, H, W)[:, tri.long()]  # [N, T, 3, 2]
    out = color
    out = out + _pair_blend(color, tid, z, tri_xy, axis=2)
    out = out + _pair_blend(color, tid, z, tri_xy, axis=1)
    return out
