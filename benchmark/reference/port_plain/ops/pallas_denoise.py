"""Cross-bilateral denoiser for a pair of color buffers that share their
guide planes (counterpart of nvdiffrecmc_tpu/ops/pallas_denoise.py), and
for one color buffer (denoiser.bilateral_denoiser, the modulated color).

`_Premul` is an autograd Function: its forward is the premultiplied tap
sum, its backward the same tap loop in grad mode over the color gradient
(the weight-sum gradient is dropped and nrm, zdz and sigma get none, as in
the JAX package).  Both directions launch csrc/denoise.cu on CUDA tensors,
its pair instance for 6 channels (`_denoise_cuda`, `_denoise_grad_cuda`)
and its one-buffer instance for 3 (`_denoise_one_cuda`,
`_denoise_one_grad_cuda`), and run the plain PyTorch version
(`denoise_pair_plain`, denoiser._taps) on CPU tensors."""

import torch

from .denoiser import _taps


def denoise_pair_plain(col, nrm, zdz, sigma, grad_mode=False):
    """[N,H,W,C+1]: the C premultiplied color channels (6 for the pair,
    3 for one buffer), then the weight sum (meaningless in grad mode)."""
    acc, w = _taps(col, nrm, zdz, sigma, grad_mode)
    return torch.cat([acc, w], dim=-1)


def _denoise_call(col, nrm, zdz, sigma, grad_mode=False):
    """col [N,H,W,C] (C = 6 or 3); nrm [N,H,W,3]; zdz [N,H,W,2] ->
    [N,H,W,C+1]."""
    return denoise_pair_plain(col, nrm, zdz, sigma, grad_mode)


class _Premul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, col, nrm, zdz, sigma):
        nrm, zdz = nrm.detach(), zdz.detach()
        ctx.save_for_backward(nrm, zdz)
        ctx.sigma = sigma
        return _denoise_call(col, nrm, zdz, sigma)

    @staticmethod
    def backward(ctx, dout):
        nrm, zdz = ctx.saved_tensors
        C = dout.shape[-1] - 1
        grad = _denoise_call(dout[..., 0:C], nrm, zdz, ctx.sigma,
                             grad_mode=True)[..., 0:C]
        return grad, None, None, None


def premul(col, nrm, zdz, sigma):
    """[N,H,W,C+1]: the premultiplied tap sums of col (C = 6 or 3) and
    the weight sum, differentiable in col."""
    return _Premul.apply(col, nrm, zdz, sigma)


def bilateral_denoiser_pair(col_a, col_b, nrm, zdz, sigma):
    """Denoise two color buffers sharing guide planes; same per-buffer
    result as denoiser.bilateral_denoiser."""
    cw = premul(torch.cat([col_a, col_b], dim=-1), nrm, zdz, sigma)
    w = torch.clamp(cw[..., 6:7], min=1e-4)
    return cw[..., 0:3] / w, cw[..., 3:6] / w
