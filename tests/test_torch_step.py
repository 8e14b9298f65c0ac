"""Port parity, the whole pass-2 training step on the octasphere of
__graft_entry__._make_scene at 64x64, n_samples 2, with 32x32 kd / ks /
normal textures from initial_guess_material, a 16x16 trainable light
(create_trainable_env_rnd(16, 0.0, 0.5)), denoiser sigma 2.0, logl1 and
the relative Laplacian: DLMesh.tick under jax.grad (the JAX side shades
with env_shade_fused_jnp) against the port's compute_grads, both fed the
same uniforms, jitter offsets, bf16-exact light tables and target.

Tolerances: the losses within 1e-4 relative; the gradients of v_pos, kd,
ks, normal and light with cosine >= 0.999 and >= 99% of their entries
within 1e-3 max|g| (a grazing shadow ray or an antialias choice on values
a few ulps apart may flip between the packages, and the pixel it feeds
then sends a different gradient).  kd starts constant, so |kd_jitter -
kd| of the smoothness term sits on its kink, where the sign of a few-ulp
difference picks the gradient: the test adds seeded noise to kd on both
sides.  The update rule is held to the JAX package's apply_grads (optax
Adam, the light gradient times 64, the projections) on the same
gradients, over two steps, within 1e-5: Adam's first step is
lr * g / (|g| + eps), which turns a sign flip of a near-zero gradient
into 2 lr, so the update is compared on common gradients.  Finally one
port train_step from fresh parameters keeps every parameter finite and
inside its bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import __graft_entry__ as ge
import train as j_train
from nvdiffrecmc_tpu.config import apply_schedule_scaling
from nvdiffrecmc_tpu.geometry.dlmesh import DLMesh as JDLMesh
from nvdiffrecmc_tpu.ops import envshade as j_envshade
from nvdiffrecmc_tpu.ops import pallas_shade as j_ps
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch import convert
from nvdiffrecmc_tpu_torch import train as t_train
from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import make_light
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vecmath
from nvdiffrecmc_tpu_torch.render import light as t_light
from nvdiffrecmc_tpu_torch.render import render as t_render
from nvdiffrecmc_tpu_torch.render import texture as t_texture

RES, N, IT = 64, 2, 3
KD_NOISE = np.random.RandomState(4).uniform(0.0, 0.3, (1, 32, 32, 3)).astype(
    np.float32)
SETTINGS = dict(train_res=[RES, RES], n_samples=N, texture_res=[32, 32],
                iter=100, layers=1, spp=1, batch=1, denoiser='bilateral')


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _target(m, mvp, campos):
    """A ground-truth view of the mesh under another material and light,
    from a camera turned by 0.15 rad (so that no silhouette pixel of the
    target equals the trained render's to a few ulps), over a random
    background."""
    rng = np.random.RandomState(8)
    kd = rng.uniform(0.1, 0.9, (1, 32, 32, 3)).astype(np.float32)
    ks = np.stack([np.zeros((32, 32)), rng.uniform(0.3, 0.7, (32, 32)),
                   rng.uniform(0.0, 1.0, (32, 32))], -1)[None]
    mesh = convert.mesh(m)
    mesh.material = {'bsdf': 'pbr',
                     'kd': t_texture.Texture2D(data=torch.as_tensor(kd)),
                     'ks': t_texture.Texture2D(data=torch.as_tensor(
                         ks.astype(np.float32)))}
    geo = TDLMesh(mesh, {})
    tm, bvh = geo.getMesh(geo.parameters(), mesh.material)
    base = convert.tensor(j_light.create_trainable_env_rnd(16, 0.5, 0.25))
    gen = torch.Generator()
    gen.manual_seed(1)
    turned = np.asarray(mvp) @ t_vecmath.rotate_y(0.15)[None]
    with torch.no_grad():
        img = t_render.render_mesh(
            {'n_samples': N}, tm, convert.tensor(turned),
            convert.tensor(campos),
            make_light(base), (RES, RES), bvh, None, gen, msaa=True,
            denoiser_sigma=2.0, rnd_seed=9)['shaded'].numpy()
    bg = rng.rand(1, RES, RES, 3).astype(np.float32)
    a = img[..., 3:4]
    mixed = np.concatenate([bg * (1 - a) + img[..., 0:3] * a, a], -1)
    return {'img': mixed, 'background': bg, 'mvp': np.asarray(mvp),
            'campos': np.asarray(campos)}


def _jax_step(m, perms, target, tables):
    FLAGS = j_train.parse_flags([])
    FLAGS.update(SETTINGS)
    apply_schedule_scaling(FLAGS)
    geo = JDLMesh(m, FLAGS)
    mat_params, mat_static = j_train.initial_guess_material(geo, False,
                                                            FLAGS)
    mat_params = dict(mat_params, kd=mat_params['kd'] - KD_NOISE)
    params = {'geo': geo.parameters(), 'mat': mat_params,
              'light': j_light.create_trainable_env_rnd(16, 0.0, 0.5)}
    tgt = {k: jnp.asarray(v) for k, v in target.items()}
    tgt.update(resolution=(RES, RES), spp=1)
    loss_obj = j_train.createLoss(FLAGS)

    def loss_fn(p):
        lgt = {'base': p['light'], 'pdf': jnp.asarray(tables[0]),
               'rows': jnp.asarray(tables[1]), 'cols': jnp.asarray(tables[2])}
        material = j_train.make_material(p['mat'], mat_static)
        il, rl = geo.tick(p['geo'], material, lgt, tgt, loss_obj,
                          jnp.float32(IT), FLAGS, jnp.float32(2.0), perms,
                          jax.random.PRNGKey(11), rnd_seed=jnp.int32(IT))
        return il + rl, (il, rl)
    grads, (il, rl) = jax.grad(loss_fn, has_aux=True)(params)
    return FLAGS, params, mat_static, grads, float(il), float(rl)


def _jax_apply(FLAGS, params, mat_static, grads, steps):
    """The JAX package's apply_grads (train.py optimize_mesh), warm-up 0."""
    rate = FLAGS['lr_decay_rate']

    def adam(lr):
        return optax.adam(lambda c: lr * jnp.power(10.0, -c * rate),
                          b1=0.9, b2=0.999, eps=1e-8)
    opts = {'geo': adam(0.01), 'mat': adam(0.01), 'light': adam(0.03)}
    state = {k: opts[k].init(params[k]) for k in opts}
    for _ in range(steps):
        g = dict(grads, light=grads['light'] * 64.0)
        new = {}
        for k in opts:
            upd, state[k] = opts[k].update(g[k], state[k])
            new[k] = optax.apply_updates(params[k], upd)
        new['mat'] = j_train.clamp_material(new['mat'], mat_static)
        new['light'] = jnp.clip(new['light'], min=0.01)
        params = new
    return params


def _port_setup(m, light=None, kd_noise=False):
    FLAGS = t_config.make_flags(**SETTINGS)
    geo = TDLMesh(convert.mesh(m), FLAGS)
    mat_params, mat_static = t_train.initial_guess_material(geo, False,
                                                            FLAGS)
    if kd_noise:
        mat_params['kd'] = mat_params['kd'] - torch.as_tensor(KD_NOISE)
    light = t_light.create_trainable_env_rnd(16, 0.0, 0.5) if light is None \
        else light
    params = t_train.make_params(geo, mat_params, light)
    return FLAGS, geo, params, mat_static


def _flat(p):
    return {'v_pos': p['geo']['v_pos'], 'kd': p['mat']['kd'],
            'ks': p['mat']['ks'], 'normal': p['mat']['normal'],
            'light': p['light']}


def test_train_step_matches_jax(monkeypatch):
    m, _, perms, mvp, campos = ge._make_scene(res=RES, n_samples=N)
    target = _target(m, mvp, campos)
    tb = j_light.update_pdf(j_light.create_trainable_env_rnd(16, 0.0, 0.5))
    tables = (_bf16(tb.pdf), _bf16(tb.rows), _bf16(tb.cols))

    monkeypatch.setattr(j_envshade, 'env_shade', j_ps.env_shade_fused_jnp)
    jflags, jparams, jstatic, jgrads, jil, jrl = _jax_step(m, perms, target,
                                                           tables)

    FLAGS, geo, params, mat_static = _port_setup(m, kd_noise=True)
    P = RES * RES
    u8 = j_ps.make_uniforms(jax.random.PRNGKey(IT), N * N, P, N, perms)
    kj = jax.random.split(jax.random.split(jax.random.PRNGKey(11), 1)[0],
                          3)[0]
    offset = jax.random.normal(kj, (1, RES, RES, 2)) * 0.005
    tgt = {k: torch.as_tensor(np.array(v)) for k, v in target.items()}
    port_tables = t_light.LightTables(*(torch.as_tensor(np.array(x))
                                        for x in tables))
    monkeypatch.setattr(t_train.light_mod, 'update_pdf',
                        lambda base: port_tables)
    il, rl = t_train.compute_grads(
        geo, params, mat_static, tgt, IT, FLAGS, t_train.createLoss(FLAGS),
        convert.tensor(perms), None, uniforms=[convert.tensor(u8)],
        offsets=[convert.tensor(offset)])
    np.testing.assert_allclose(float(il), jil, rtol=1e-4)
    np.testing.assert_allclose(float(rl), jrl, rtol=1e-4)

    want = _flat(jgrads)
    for k, p in _flat(params).items():
        g, w = p.grad.numpy().ravel(), np.asarray(want[k]).ravel()
        assert np.isfinite(g).all() and np.abs(g).max() > 0.0, k
        cos = np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w))
        close = (np.abs(g - w) <= 1e-3 * np.abs(w).max()).mean()
        assert cos >= 0.999 and close >= 0.99, (k, cos, close)

    # the update rule on common gradients: JAX's grads and params, 2 steps
    want = _flat(_jax_apply(jflags, jparams, jstatic, jgrads, 2))
    FLAGS, geo, params, mat_static = _port_setup(m, kd_noise=True)
    opts = t_train.make_optimizers(params, FLAGS)
    jg = convert.params(jgrads)
    for _ in range(2):
        grads = _flat(jg)
        for k, p in _flat(params).items():
            p.grad = grads[k].clone()
        t_train.apply_grads(params, opts, mat_static, FLAGS)
    for k, p in _flat(params).items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_port_train_step_keeps_parameters_in_bounds():
    m, _, perms, mvp, campos = ge._make_scene(res=RES, n_samples=N)
    target = {k: torch.as_tensor(np.array(v))
              for k, v in _target(m, mvp, campos).items()}
    FLAGS, geo, params, mat_static = _port_setup(m)
    opts = t_train.make_optimizers(params, FLAGS)
    before = {k: v.detach().clone() for k, v in _flat(params).items()}
    gen = torch.Generator()
    gen.manual_seed(0)
    il, rl = t_train.train_step(geo, params, opts, mat_static, target, 0,
                                FLAGS, t_train.createLoss(FLAGS),
                                convert.tensor(perms), gen)
    assert np.isfinite(float(il)) and np.isfinite(float(rl))
    after = _flat(params)
    for k, v in after.items():
        assert bool(torch.isfinite(v).all()), k
        assert not torch.equal(v.detach(), before[k]), k
    lo, hi = mat_static['min_max']['ks']
    assert bool(((after['ks'] >= lo) & (after['ks'] <= hi)).all())
    assert bool((after['light'] >= 0.01).all())
    n = torch.linalg.vector_norm(after['normal'], dim=-1)
    assert torch.allclose(n, torch.ones_like(n), atol=1e-5)
