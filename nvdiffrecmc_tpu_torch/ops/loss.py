"""Image losses with fused tonemapping (counterpart of
nvdiffrecmc_tpu/ops/loss.py): clamp both images to [0, 65535], optionally
tonemap with log-sRGB, then a per-pixel L1, MSE, SMAPE, relative MSE or
noise2noise term, averaged.  Kinks take JAX's gradients (vecmath)."""

import torch

from .vecmath import abs_pos0, clip_split, maximum_split

_LOSSES = ('l1', 'mse', 'relmse', 'smape', 'n2n')
_TONEMAPPERS = ('none', 'log_srgb')


def _srgb(x):
    return torch.where(
        x > 0.0031308,
        torch.pow(maximum_split(x, 0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
        12.92 * maximum_split(x, 0.0))


def tonemap_log_srgb(x):
    return _srgb(torch.log(clip_split(x, 0.0, 65535.0) + 1.0))


def image_loss(img, target, loss='l1', tonemapper='none'):
    """Mean scalar loss over [..., 3] RGB images."""
    assert loss in _LOSSES, loss
    assert tonemapper in _TONEMAPPERS, tonemapper
    img = clip_split(img, 0.0, 65535.0)
    target = clip_split(target, 0.0, 65535.0)
    if tonemapper == 'log_srgb':
        img = _srgb(torch.log(img + 1.0))
        target = _srgb(torch.log(target + 1.0))
    eps = 0.01
    if loss == 'mse':
        v = (img - target) ** 2
    elif loss == 'relmse':
        v = (img - target) ** 2 / (img * img + target * target + eps)
    elif loss == 'n2n':
        v = (img - target) ** 2 / (img * img + eps)
    elif loss == 'smape':
        v = abs_pos0(img - target) / (img + target + eps)
    else:
        v = abs_pos0(img - target)
    return torch.mean(v)
