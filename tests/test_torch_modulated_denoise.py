"""Port parity, the one-buffer denoiser (denoiser_demodulate false, which
denoises the shaded color after modulation): denoiser.bilateral_denoiser
(its plain version on the CPU) against the JAX package's
denoiser.bilateral_denoiser, value and gradient, at the slice's sigma 2.0
and a smaller one whose dynamic radius cuts the 23x23 stencil, on a
24x28 image (ragged against the kernel's 32x8 tiles); render.shade_post
with denoiser_demodulate false against the JAX shade_post, value and
gradient in the MC estimate and the material.

Tolerances: rtol 1e-5 (the exp of two libraries; JAX takes x^128 by pow,
the port by 7 squarings, as the pair's test states), and for gradients
atol 2e-5 besides (the cotangent has both signs, so a small result is a
sum of 529 terms of size ~1 that cancel).  The guide planes get no
gradient.  The one-buffer kernel's wrappers refuse CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import denoiser as j_dn
from nvdiffrecmc_tpu.render import render as j_render
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch.ops import denoiser as t_dn
from nvdiffrecmc_tpu_torch.ops import pallas_denoise as t_pd
from nvdiffrecmc_tpu_torch.render import render as t_render
from test_torch_denoise import make_buffers
from test_torch_envshade_loop import _one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize('sigma', [2.0, 0.7])
def test_bilateral_denoiser_matches_jax(sigma):
    col, _, nrm, zdz = make_buffers(seed=3)
    g = np.random.RandomState(4).randn(*col.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda c: j_dn.bilateral_denoiser(
        c, jnp.asarray(nrm), jnp.asarray(zdz), jnp.float32(sigma)),
        jnp.asarray(col))
    want_g, = vjp(jnp.asarray(g))
    c, n, z = (torch.as_tensor(x).requires_grad_() for x in (col, nrm, zdz))
    got = t_dn.bilateral_denoiser(c, n, z, sigma)
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=2e-5)
    assert n.grad is None and z.grad is None


def _pre(rng, h=16, w=20):
    def nrm():
        v = rng.randn(1, h, w, 3) + np.array([0.0, 0.0, 2.0])
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)
    f = np.float32
    ks = np.stack([np.zeros((h, w)), rng.uniform(0.1, 0.9, (h, w)),
                   rng.uniform(0.0, 1.0, (h, w))], -1)[None].astype(f)
    return dict(
        kd=rng.uniform(0.1, 0.9, (1, h, w, 3)).astype(f), ks=ks,
        alpha=np.ones((1, h, w, 1), f),
        gb_depth=np.concatenate([rng.uniform(0.5, 1.5, (1, h, w, 1)),
                                 rng.uniform(0.01, 0.06, (1, h, w, 1))],
                                -1).astype(f),
        gb_normal_shaded=nrm(), gb_geometric_normal=nrm(),
        gb_tangent=nrm(), kd_grad=np.zeros((1, h, w, 3), f),
        ks_grad=np.zeros((1, h, w, 3), f),
        nrm_grad=np.zeros((1, h, w, 3), f), perturbed_nrm=None)


@pytest.mark.parametrize('bsdf', ['pbr', 'diffuse'])
def test_shade_post_modulated_matches_jax(bsdf):
    """shade_post with denoiser_demodulate false: the pair denoiser is
    skipped, the modulated color denoised once."""
    rng = np.random.RandomState(7)
    pre = _pre(rng)
    accum = [rng.uniform(0.0, 2.0, pre['kd'].shape).astype(np.float32)
             for _ in range(2)]
    g = rng.randn(*pre['kd'].shape[:3], 4).astype(np.float32)
    sigma = 2.0
    jflags = {'denoiser_demodulate': False}

    def jf(kd, da, sa):
        p = {k: (jnp.asarray(v) if v is not None else None)
             for k, v in pre.items()}
        p['kd'] = kd
        return j_render.shade_post(jflags, p, da, sa, bsdf,
                                   jnp.float32(sigma))['shaded']
    want, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in [pre['kd']] + accum))
    want_g = vjp(jnp.asarray(g))

    FLAGS = t_config.make_flags(denoiser_demodulate=False)
    tp = {k: (torch.as_tensor(v) if v is not None else None)
          for k, v in pre.items()}
    leaves = [torch.as_tensor(x).requires_grad_()
              for x in [pre['kd']] + accum]
    tp['kd'] = leaves[0]
    got = t_render.shade_post(FLAGS, tp, leaves[1], leaves[2], bsdf,
                              sigma)['shaded']
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for leaf, w in zip(leaves, want_g):    # diffuse reads no specular
        got_g = torch.zeros_like(leaf) if leaf.grad is None else leaf.grad
        np.testing.assert_allclose(got_g.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=2e-5)
    # the demodulated default denoises the estimates, not the color
    demod = t_render.shade_post(t_config.make_flags(), tp, leaves[1],
                                leaves[2], bsdf, sigma)['shaded']
    assert not torch.allclose(demod, got)


@pytest.mark.parametrize('grad_mode', [False, True])
def test_one_buffer_wrappers_refuse_cpu_tensors(grad_mode):
    fn = t_pd._denoise_one_grad_cuda if grad_mode else t_pd._denoise_one_cuda
    with pytest.raises(ValueError, match='CUDA'):
        fn(torch.zeros(1, 8, 8, 3), torch.zeros(1, 8, 8, 3),
           torch.zeros(1, 8, 8, 2), 2.0)
