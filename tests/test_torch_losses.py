"""Port parity, losses and the training step's small pieces, values and
gradients against the JAX package (rtol 1e-5, atol 1e-6 unless stated):
image_loss for every loss and tonemapper, tonemap_log_srgb, shading_loss,
material_smoothness_grad, chroma_loss, laplace_uniform; bilinear
magnification in scale_img_nhwc, create_trainable, create_trainable_env_rnd
and initial_guess_material (exact); prepare_batch (exact) and the
learning-rate schedule (rtol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as j_train
from nvdiffrecmc_tpu.config import apply_schedule_scaling
from nvdiffrecmc_tpu.ops import loss as j_loss
from nvdiffrecmc_tpu.ops import mesh_ops as j_mesh_ops
from nvdiffrecmc_tpu.ops import vecmath as j_vecmath
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import regularizer as j_reg
from nvdiffrecmc_tpu.render import texture as j_texture
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch import train as t_train
from nvdiffrecmc_tpu_torch.ops import loss as t_loss
from nvdiffrecmc_tpu_torch.ops import mesh_ops as t_mesh_ops
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vecmath
from nvdiffrecmc_tpu_torch.render import light as t_light
from nvdiffrecmc_tpu_torch.render import regularizer as t_reg
from nvdiffrecmc_tpu_torch.render import texture as t_texture


def _check(jfn, tfn, *arrays, rtol=1e-5, atol=1e-6):
    """Value and gradients of a scalar function of the arrays."""
    val, grads = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.as_tensor(a).requires_grad_() for a in arrays]
    out = tfn(*leaves)
    out.backward()
    np.testing.assert_allclose(out.item(), float(val), rtol=rtol, atol=atol)
    for t, g in zip(leaves, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=rtol,
                                   atol=atol)


def _images(seed=0, shape=(1, 8, 9, 4)):
    rng = np.random.RandomState(seed)
    img = (rng.rand(*shape) * 3 - 0.5).astype(np.float32)
    ref = rng.rand(*shape).astype(np.float32)
    ref[..., 3] = (rng.rand(*shape[:-1]) > 0.3)
    return img, ref


@pytest.mark.parametrize('loss', ['l1', 'mse', 'relmse', 'smape', 'n2n'])
@pytest.mark.parametrize('tonemapper', ['none', 'log_srgb'])
def test_image_loss_matches_jax(loss, tonemapper):
    img, ref = _images()
    _check(lambda a, b: j_loss.image_loss(a, b, loss, tonemapper),
           lambda a, b: t_loss.image_loss(a, b, loss, tonemapper),
           img[..., :3], ref[..., :3])


def test_tonemap_log_srgb_matches_jax():
    img, _ = _images(1)
    _check(lambda a: jnp.sum(j_loss.tonemap_log_srgb(a)),
           lambda a: t_loss.tonemap_log_srgb(a).sum(), img)


def test_regularizers_match_jax():
    rng = np.random.RandomState(2)
    diff, spec = (rng.rand(1, 8, 9, 4).astype(np.float32) for _ in range(2))
    _, ref = _images(3)
    _check(lambda d, s: j_reg.shading_loss(d, s, jnp.asarray(ref), 0.15,
                                           0.0025),
           lambda d, s: t_reg.shading_loss(d, s, torch.as_tensor(ref), 0.15,
                                           0.0025), diff, spec)
    kg, sg, ng = (rng.rand(1, 8, 9, 4).astype(np.float32) for _ in range(3))
    _check(lambda a, b, c: j_reg.material_smoothness_grad(a, b, c, 0.1, 0.05,
                                                          0.025),
           lambda a, b, c: t_reg.material_smoothness_grad(a, b, c, 0.1, 0.05,
                                                          0.025), kg, sg, ng)
    _check(lambda k: j_reg.chroma_loss(k, jnp.asarray(ref), 0.3),
           lambda k: t_reg.chroma_loss(k, torch.as_tensor(ref), 0.3), diff)


def test_laplace_uniform_matches_jax():
    rng = np.random.RandomState(4)
    v = rng.randn(30, 3).astype(np.float32)
    tri = rng.randint(0, 30, (50, 3)).astype(np.int32)
    _check(lambda x: j_mesh_ops.laplace_uniform(x, jnp.asarray(tri)),
           lambda x: t_mesh_ops.laplace_uniform(x, torch.as_tensor(tri)), v)


@pytest.mark.parametrize('src', [(1, 1), (3, 5)])
def test_scale_img_bilinear_matches_jax(src):
    x = np.random.RandomState(5).rand(1, *src, 3).astype(np.float32)
    want = j_vecmath.scale_img_nhwc(jnp.asarray(x), (16, 12))
    got = t_vecmath.scale_img_nhwc(torch.as_tensor(x), (16, 12))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_trainable_textures_and_light_match_jax():
    for init, res in ((np.array([0, 0, 1], np.float32), (8, 8)),
                      (np.random.RandomState(6).rand(4, 4, 3)
                       .astype(np.float32), (8, 8)),
                      (np.random.RandomState(7).rand(8, 8, 3)
                       .astype(np.float32), (4, 4))):
        bounds = (np.array([0.1, 0.2, 0.3], np.float32),
                  np.array([0.6, 0.7, 0.8], np.float32))
        jt = j_texture.create_trainable(init, res, True, bounds)
        tt = t_texture.create_trainable(init, res, bounds)
        # the projections the trainer applies after each step
        for got, want in ((tt, jt), (tt.clamp(), jt.clamp()),
                          (tt.normalize(), jt.normalize())):
            got, want = got.getMips(), want.getMips()
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        t_light.create_trainable_env_rnd(16, 0.3, 0.2).numpy(),
        np.asarray(j_light.create_trainable_env_rnd(16, 0.3, 0.2)))


def test_initial_guess_material_matches_jax():
    jflags = j_train.parse_flags([])
    jflags.update(texture_res=[16, 16])
    tflags = t_config.make_flags(texture_res=[16, 16])
    jp, js = j_train.initial_guess_material(None, False, jflags)
    tp, ts = t_train.initial_guess_material(None, False, tflags)
    for k in ('kd', 'ks', 'normal'):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        for a, b in zip(ts['min_max'][k], js['min_max'][k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the projections: out-of-range texels and a tilted normal map
    jp = {k: v * 1.7 - 0.4 for k, v in jp.items()}
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    want = j_train.clamp_material(jp, js)
    t_train.clamp_material(tp, ts)
    for k in ('kd', 'ks', 'normal'):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('bg', ['black', 'white', 'reference', 'checker'])
def test_prepare_batch_matches_jax(bg):
    img, _ = _images(7, (1, 16, 16, 4))
    mvp = np.eye(4, dtype=np.float32)[None]
    target = {'img': img, 'mvp': mvp, 'campos': np.zeros((1, 3), np.float32)}
    want = j_train.prepare_batch(target, [16, 16], bg, None, {})
    got = t_train.prepare_batch(dict(target, img=torch.as_tensor(img)),
                                [16, 16], bg, None, {})
    for k in ('img', 'background', 'mvp', 'campos'):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got['resolution'] == want['resolution']


@pytest.mark.parametrize('iters', [300, 5000])
def test_lr_schedule_matches_jax(iters):
    flags = j_train.parse_flags([])
    flags.update(iter=iters)
    apply_schedule_scaling(flags)
    rate = t_config.make_flags(iter=iters)['lr_decay_rate']
    np.testing.assert_allclose(rate, flags['lr_decay_rate'], rtol=1e-12)
    for c in (0, 1, 50, 99, 100, 101, 299, iters - 1):
        want = jnp.power(10.0, -(jnp.maximum(c, 0)) * rate)
        np.testing.assert_allclose(t_train.lr_schedule(c, rate),
                                   float(want), rtol=1e-6)
