"""Cross-bilateral denoiser for a pair of color buffers that share their
guide planes (counterpart of nvdiffrecmc_tpu/ops/pallas_denoise.py).

`_premul_pair` is an autograd Function: its forward is the premultiplied
tap sum, its backward the same tap loop in grad mode over the color
gradient (the weight-sum gradient is dropped and nrm, zdz and sigma get
none, as in the JAX package).  Both directions launch csrc/denoise.cu on
CUDA tensors (`_denoise_cuda`, `_denoise_grad_cuda`) and run the plain
PyTorch version (`denoise_pair_plain`, denoiser._taps) on CPU tensors."""

import torch

from .. import kernels
from .denoiser import _taps


def denoise_pair_plain(col6, nrm, zdz, sigma, grad_mode=False):
    """[N,H,W,7]: premultiplied 6 color channels, then the weight sum
    (meaningless in grad mode)."""
    acc, w = _taps(col6, nrm, zdz, sigma, grad_mode)
    return torch.cat([acc, w], dim=-1)


def _launch(col6, nrm, zdz, sigma, grad_mode):
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
            N, H, W, float(sigma), int(grad_mode), kernels.stream_ptr(col6))
    name = 'denoise_grad' if grad_mode else 'denoise'
    kernels.LAUNCHES[name] += 1
    kernels.check(rc, 'nvk_denoise')
    return out


def _denoise_cuda(col6, nrm, zdz, sigma):
    return _launch(col6, nrm, zdz, sigma, False)


def _denoise_grad_cuda(g6, nrm, zdz, sigma):
    return _launch(g6, nrm, zdz, sigma, True)


def _denoise_call(col6, nrm, zdz, sigma, grad_mode=False):
    """col6 [N,H,W,6]; nrm [N,H,W,3]; zdz [N,H,W,2] -> [N,H,W,7]."""
    if col6.is_cuda:
        fn = _denoise_grad_cuda if grad_mode else _denoise_cuda
        return fn(col6.contiguous(), nrm.contiguous(), zdz.contiguous(),
                  sigma)
    return denoise_pair_plain(col6, nrm, zdz, sigma, grad_mode)


class _PremulPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, col6, nrm, zdz, sigma):
        nrm, zdz = nrm.detach(), zdz.detach()
        ctx.save_for_backward(nrm, zdz)
        ctx.sigma = sigma
        return _denoise_call(col6, nrm, zdz, sigma)

    @staticmethod
    def backward(ctx, dout):
        nrm, zdz = ctx.saved_tensors
        grad = _denoise_call(dout[..., 0:6], nrm, zdz, ctx.sigma,
                             grad_mode=True)[..., 0:6]
        return grad, None, None, None


def _premul_pair(col6, nrm, zdz, sigma):
    return _PremulPair.apply(col6, nrm, zdz, sigma)


def bilateral_denoiser_pair(col_a, col_b, nrm, zdz, sigma):
    """Denoise two color buffers sharing guide planes; same per-buffer
    result as denoiser.bilateral_denoiser."""
    cw = _premul_pair(torch.cat([col_a, col_b], dim=-1), nrm, zdz, sigma)
    w = torch.clamp(cw[..., 6:7], min=1e-4)
    return cw[..., 0:3] / w, cw[..., 3:6] / w
