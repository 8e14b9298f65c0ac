"""Port parity, denoiser: the pair denoiser's plain version against the JAX
bilateral_denoiser_pair (CPU path) at rtol 1e-5, for the slice's sigma 2.0
and a smaller one whose dynamic radius cuts the 23x23 stencil; its
backward (grad mode) against the VJP of the JAX package's _premul_pair
(rtol 1e-5, atol 2e-5: the cotangent has both signs, so a small result
is a sum of 529 terms of size ~1 that cancel; no gradient reaches the
guide planes).  Every
kernel wrapper refuses CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import pallas_denoise as j_pd
from nvdiffrecmc_tpu_torch.ops import pallas_denoise as t_pd


def make_buffers(h=24, w=28, seed=0):
    rng = np.random.RandomState(seed)
    col = rng.rand(1, h, w, 3).astype(np.float32)
    col2 = rng.rand(1, h, w, 3).astype(np.float32) * 4
    nrm = rng.randn(1, h, w, 3).astype(np.float32) + np.array([0, 0, 2.0])
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    z = rng.rand(1, h, w, 1).astype(np.float32) * 2
    dz = rng.rand(1, h, w, 1).astype(np.float32) * 0.05 + 0.01
    return col, col2, nrm, np.concatenate([z, dz], -1)


@pytest.mark.parametrize('sigma', [2.0, 0.7])
def test_denoiser_pair_matches_jax(sigma):
    bufs = make_buffers()
    wa, wb = j_pd.bilateral_denoiser_pair(
        *(jnp.asarray(b) for b in bufs), jnp.float32(sigma))
    ga, gb = t_pd.bilateral_denoiser_pair(
        *(torch.as_tensor(b) for b in bufs), sigma)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize('sigma', [2.0, 0.7])
def test_denoiser_pair_grad_matches_jax(sigma):
    import jax
    col, col2, nrm, zdz = make_buffers(seed=1)
    col6 = np.concatenate([col, col2], -1)
    g7 = np.random.RandomState(2).randn(*col6.shape[:3], 7).astype(
        np.float32)
    _, vjp = jax.vjp(lambda c: j_pd._premul_pair(c, jnp.asarray(nrm),
                                                 jnp.asarray(zdz),
                                                 jnp.float32(sigma)),
                     jnp.asarray(col6))
    want, = vjp(jnp.asarray(g7))
    c6, n, z = (torch.as_tensor(x).requires_grad_()
                for x in (col6, nrm, zdz))
    out = t_pd._premul_pair(c6, n, z, sigma)
    out.backward(torch.as_tensor(g7))
    np.testing.assert_allclose(c6.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)
    assert n.grad is None and z.grad is None


@pytest.mark.parametrize('wrapper', ['resolve', 'sample', 'trace_shade',
                                     'denoise', 'denoise_grad', 'shade_bwd',
                                     'light_scatter', 'scatter'])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper takes CUDA tensors only: handed CPU tensors it
    raises before building or launching anything (the public entry points
    send CPU tensors to the plain versions instead)."""
    from nvdiffrecmc_tpu_torch.ops import (bvh, pallas_raster, pallas_scatter,
                                           pallas_shade)
    x = torch.zeros(4, 15, 128)
    calls = {
        'resolve': lambda: pallas_raster._resolve_cuda(
            x[None], torch.zeros(1, 4, 4), 8, 8, torch.zeros(1, 8, 8),
            torch.zeros(1, 8, 8, dtype=torch.int32)),
        'sample': lambda: pallas_shade._sample_cuda(
            torch.zeros(4, 8, 16), torch.zeros(8, 16), torch.zeros(4),
            torch.zeros(4, 8), torch.zeros(4, 8), torch.zeros(4, 8, 3), 2),
        'trace_shade': lambda: pallas_shade._trace_shade_cuda(
            torch.zeros(4, 16, 16), torch.zeros(19, 16),
            bvh.build(torch.rand(3, 3), torch.tensor([[0, 1, 2]]),
                      leaf_size=4), 0, 0.0),
        'denoise': lambda: t_pd._denoise_cuda(
            torch.zeros(1, 8, 8, 6), torch.zeros(1, 8, 8, 3),
            torch.zeros(1, 8, 8, 2), 2.0),
        'denoise_grad': lambda: t_pd._denoise_grad_cuda(
            torch.zeros(1, 8, 8, 6), torch.zeros(1, 8, 8, 3),
            torch.zeros(1, 8, 8, 2), 2.0),
        'shade_bwd': lambda: pallas_shade._shade_bwd_cuda(
            torch.zeros(4, 16, 16), torch.zeros(19, 16), torch.ones(4, 32),
            torch.zeros(6, 16), 0),
        'light_scatter': lambda: pallas_shade._light_scatter_cuda(
            torch.zeros(4, 8, 16), 4, 8),
        'scatter': lambda: pallas_scatter._scatter_cuda(
            torch.zeros(16, dtype=torch.int64), torch.zeros(16, 3), 8),
    }
    with pytest.raises(ValueError, match='CUDA'):
        calls[wrapper]()
