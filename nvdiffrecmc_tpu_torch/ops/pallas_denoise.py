"""Cross-bilateral denoiser for a pair of color buffers that share their
guide planes (counterpart of nvdiffrecmc_tpu/ops/pallas_denoise.py,
forward): `_denoise_call` launches csrc/denoise.cu on CUDA tensors and
runs `denoise_pair_plain` (the plain PyTorch version, denoiser._taps) on
CPU tensors."""

import torch

from .. import kernels
from .denoiser import _taps


def denoise_pair_plain(col6, nrm, zdz, sigma):
    """[N,H,W,7]: premultiplied 6 color channels, then the weight sum."""
    acc, w = _taps(col6, nrm, zdz, sigma)
    return torch.cat([acc, w], dim=-1)


def _denoise_cuda(col6, nrm, zdz, sigma):
    N, H, W, _ = col6.shape
    dev = col6.device
    f32 = torch.float32
    kernels.require(col6, 'col6', f32, (N, H, W, 6))
    kernels.require(nrm, 'nrm', f32, (N, H, W, 3), dev)
    kernels.require(zdz, 'zdz', f32, (N, H, W, 2), dev)
    out = torch.empty((N, H, W, 7), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels.lib().nvk_denoise(
            col6.data_ptr(), nrm.data_ptr(), zdz.data_ptr(), out.data_ptr(),
            N, H, W, float(sigma), kernels.stream_ptr(col6))
    kernels.LAUNCHES['denoise'] += 1
    kernels.check(rc, 'nvk_denoise')
    return out


def _denoise_call(col6, nrm, zdz, sigma):
    """col6 [N,H,W,6]; nrm [N,H,W,3]; zdz [N,H,W,2] -> [N,H,W,7]."""
    if col6.is_cuda:
        return _denoise_cuda(col6.contiguous(), nrm.contiguous(),
                             zdz.contiguous(), sigma)
    return denoise_pair_plain(col6, nrm, zdz, sigma)


def bilateral_denoiser_pair(col_a, col_b, nrm, zdz, sigma):
    """Denoise two color buffers sharing guide planes; same per-buffer
    result as denoiser.bilateral_denoiser."""
    cw = _denoise_call(torch.cat([col_a, col_b], dim=-1), nrm, zdz, sigma)
    w = torch.clamp(cw[..., 6:7], min=1e-4)
    return cw[..., 0:3] / w, cw[..., 3:6] / w
