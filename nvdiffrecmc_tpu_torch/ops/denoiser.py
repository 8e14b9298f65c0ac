"""Cross-bilateral denoiser, forward (counterpart of
nvdiffrecmc_tpu/ops/denoiser.py): weights = gaussian(xy; sigma) *
pow(clamp(dot(n_tap, n_center)), 128) * exp(-|z_tap - z_center| /
max(dz_center * dist, eps)); premultiplied color + weight, normalized by the
caller (pallas_denoise.bilateral_denoiser_pair).  Taps outside the image
enter through a zero `valid` plane.  In grad mode the input is the output
gradient and the depth denominator takes the tap's dz instead of the
center's (the transpose of the forward weights, denoising.cu:114-118 of
the reference); the weights themselves carry no gradient."""

import math

import torch

FLT_EPS = 1e-4
MAX_SIGMA = 2.0  # sigma = max(2 * influence, eps), influence <= 1


def _max_radius(max_sigma=MAX_SIGMA):
    return 2 * math.ceil(max_sigma * 2.5) + 1  # = 11


def _pad(x, R):
    N, H, W, C = x.shape
    out = x.new_zeros((N, H + 2 * R, W + 2 * R, C))
    out[:, R:R + H, R:R + W] = x
    return out


def _taps(col, nrm, zdz, sigma, grad_mode=False):
    """Tap loop over the static (2R+1)^2 stencil, taps beyond the dynamic
    radius weighted 0.  Returns (accum_col [N,H,W,C], accum_w [N,H,W,1]);
    accum_w is meaningless in grad mode."""
    N, H, W, C = col.shape
    R = _max_radius()
    K = 2 * R + 1
    sig = torch.tensor(float(sigma), dtype=torch.float32)
    variance = sig * sig
    dyn_rad = 2.0 * math.ceil(float(sigma) * 2.5) + 1.0
    colp, nrmp, zdzp = _pad(col, R), _pad(nrm, R), _pad(zdz, R)
    validp = _pad(torch.ones_like(col[..., :1]), R)
    c_n = (nrm[..., 0:1], nrm[..., 1:2], nrm[..., 2:3])
    c_z, c_dz = zdz[..., 0:1], zdz[..., 1:2]
    acc_col = torch.zeros_like(col)
    acc_w = torch.zeros_like(col[..., :1])
    for k in range(K * K):
        fy, fx = k // K - R, k % K - R
        dist_sqr = torch.tensor(float(fx * fx + fy * fy), dtype=torch.float32)
        dist = torch.sqrt(dist_sqr)
        w_xy = torch.exp(-dist_sqr / (2.0 * variance))
        if abs(fx) > dyn_rad or abs(fy) > dyn_rad:
            w_xy = torch.zeros_like(w_xy)
        w_xy, dist = w_xy.to(col.device), dist.to(col.device)

        def tap(x):
            return x[:, fy + R:fy + R + H, fx + R:fx + R + W]
        t_nrm, t_zdz = tap(nrmp), tap(zdzp)
        ndot = (t_nrm[..., 0:1] * c_n[0] + t_nrm[..., 1:2] * c_n[1]
                + t_nrm[..., 2:3] * c_n[2])
        w_normal = torch.pow(torch.clamp(ndot, FLT_EPS, 1.0), 128.0)
        dz = t_zdz[..., 1:2] if grad_mode else c_dz
        denom = torch.clamp(dz * dist, min=FLT_EPS)
        w_depth = torch.exp(-torch.abs(t_zdz[..., 0:1] - c_z) / denom)
        w = w_xy * w_normal * w_depth * tap(validp)
        acc_col = acc_col + tap(colp) * w
        acc_w = acc_w + w
    return acc_col, acc_w
