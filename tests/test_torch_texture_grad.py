"""Port parity, texture gradients: the texture and uv gradients of
texture_sample_multi (trilinear, through build_mip_chain) and of
bilinear_sample against the JAX package's (rtol 1e-4, atol 1e-5); the mip
op's backward, which is the reference's (the output gradient times 0.25,
upsampled bilinearly) and not the average pool's adjoint; and the mip
level, which carries no gradient into the uv derivatives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import texture as j_tex
from nvdiffrecmc_tpu_torch.ops import texture as t_tex


def _inputs(seed=0, h=20, w=24):
    rng = np.random.RandomState(seed)
    kd = rng.rand(1, 32, 32, 3).astype(np.float32)
    ks = rng.rand(1, 32, 32, 3).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (1, h, w, 2)).astype(np.float32)
    # footprints from magnification to far minification (every mip level)
    da = (rng.randn(1, h, w, 4) * np.exp(rng.uniform(-8, 1, (1, h, w, 1)))
          ).astype(np.float32)
    g = rng.randn(1, h, w, 6).astype(np.float32)
    return kd, ks, uv, da, g


def _leaves(*xs):
    return [torch.as_tensor(x).requires_grad_() for x in xs]


@pytest.mark.parametrize('boundary', ['wrap', 'clamp'])
def test_texture_sample_multi_grads_match_jax(boundary):
    kd, ks, uv, da, g = _inputs()

    def jfn(kd_, ks_, uv_):
        out = j_tex.texture_sample_multi(
            [j_tex.build_mip_chain(kd_), j_tex.build_mip_chain(ks_)], uv_,
            jnp.asarray(da), boundary_mode=boundary)
        return jnp.concatenate(out, -1)
    _, vjp = jax.vjp(jfn, jnp.asarray(kd), jnp.asarray(ks), jnp.asarray(uv))
    want = vjp(jnp.asarray(g))
    tkd, tks, tuv = _leaves(kd, ks, uv)
    out = t_tex.texture_sample_multi(
        [t_tex.build_mip_chain(tkd), t_tex.build_mip_chain(tks)], tuv,
        torch.as_tensor(da), boundary_mode=boundary)
    torch.cat(out, -1).backward(torch.as_tensor(g))
    for name, t, w in zip(['kd', 'ks', 'uv'], (tkd, tks, tuv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize('boundary', ['wrap', 'clamp'])
def test_bilinear_sample_grads_match_jax(boundary):
    kd, _, uv, _, g = _inputs(1)
    _, vjp = jax.vjp(lambda t, u: j_tex.bilinear_sample(t, u, boundary),
                     jnp.asarray(kd), jnp.asarray(uv))
    want = vjp(jnp.asarray(g[..., 0:3]))
    tkd, tuv = _leaves(kd, uv)
    t_tex.bilinear_sample(tkd, tuv, boundary).backward(
        torch.as_tensor(g[..., 0:3]))
    for name, t, w in zip(['tex', 'uv'], (tkd, tuv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_mip_backward_matches_jax():
    rng = np.random.RandomState(2)
    tex = rng.rand(2, 16, 8, 3).astype(np.float32)
    g = rng.randn(2, 8, 4, 3).astype(np.float32)
    out, vjp = jax.vjp(j_tex.texture2d_mip, jnp.asarray(tex))
    want, = vjp(jnp.asarray(g))
    t, = _leaves(tex)
    got = t_tex.texture2d_mip(t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=1e-6, atol=1e-7)
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_mip_level_has_no_gradient():
    kd, ks, uv, da, g = _inputs(3)
    tkd, tuv, tda = _leaves(kd, uv, da)
    out = t_tex.texture_sample(t_tex.build_mip_chain(tkd), tuv, tda)
    out.backward(torch.as_tensor(g[..., 0:3]))
    assert tda.grad is None or not bool(tda.grad.any())
    assert bool(tuv.grad.any()) and bool(tkd.grad.any())
