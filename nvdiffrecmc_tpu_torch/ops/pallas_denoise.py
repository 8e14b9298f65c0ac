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

from .. import kernels
from .denoiser import _taps


def denoise_pair_plain(col, nrm, zdz, sigma, grad_mode=False):
    """[N,H,W,C+1]: the C premultiplied color channels (6 for the pair,
    3 for one buffer), then the weight sum (meaningless in grad mode)."""
    acc, w = _taps(col, nrm, zdz, sigma, grad_mode)
    return torch.cat([acc, w], dim=-1)


# channels -> (C entry, launch counter of the forward, of the grad mode)
_ENTRIES = {6: ('nvk_denoise', 'denoise', 'denoise_grad'),
            3: ('nvk_denoise_one', 'denoise_one', 'denoise_one_grad')}


def _launch(col, nrm, zdz, sigma, grad_mode):
    """csrc/denoise.cu; raises where the card refuses the launch."""
    N, H, W, C = col.shape
    entry, fwd, grad = _ENTRIES[C]
    dev = col.device
    f32 = torch.float32
    kernels.require(col, 'col', f32, (N, H, W, C))
    kernels.require(nrm, 'nrm', f32, (N, H, W, 3), dev)
    kernels.require(zdz, 'zdz', f32, (N, H, W, 2), dev)
    out = torch.empty((N, H, W, C + 1), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(kernels.lib(), entry)(
            col.data_ptr(), nrm.data_ptr(), zdz.data_ptr(), out.data_ptr(),
            N, H, W, float(sigma), int(grad_mode), kernels.stream_ptr(col))
    kernels.check(rc, entry)
    kernels.LAUNCHES[grad if grad_mode else fwd] += 1
    return out


def _denoise_cuda(col6, nrm, zdz, sigma):
    return _launch(col6, nrm, zdz, sigma, False)


def _denoise_grad_cuda(g6, nrm, zdz, sigma):
    return _launch(g6, nrm, zdz, sigma, True)


def _denoise_one_cuda(col3, nrm, zdz, sigma):
    return _launch(col3, nrm, zdz, sigma, False)


def _denoise_one_grad_cuda(g3, nrm, zdz, sigma):
    return _launch(g3, nrm, zdz, sigma, True)


def _denoise_call(col, nrm, zdz, sigma, grad_mode=False):
    """col [N,H,W,C] (C = 6 or 3); nrm [N,H,W,3]; zdz [N,H,W,2] ->
    [N,H,W,C+1]."""
    if col.is_cuda:
        if col.shape[-1] == 6:
            fn = _denoise_grad_cuda if grad_mode else _denoise_cuda
        else:
            fn = _denoise_one_grad_cuda if grad_mode else _denoise_one_cuda
        return fn(col.contiguous(), nrm.contiguous(), zdz.contiguous(),
                  sigma)
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
