"""Port parity, the whole pass-1 training step: DMTetGeometry at grid 8
(a sphere SDF, seeded noise on it and a seeded deformation) with a small
hash grid (6 levels from 4 to 256 cells, 2^14 rows, a seeded table), a
16x16 trainable light,
32x32, n_samples 2, at batch 1 and 2 (a second view turned by 0.6 rad),
iteration 3 of 100 (the shadow ramp at 3/35, the denoiser sigma at twice
it, the sdf regularizer's weight falling): DMTetGeometry.tick under
jax.grad (the JAX side shades with env_shade_fused_jnp) against the port's
compute_grads, both fed the same uniforms, jitter offsets, position noise
of the neural material, bf16-exact light tables and target.

Tolerances, those of test_train_step_matches_jax: the losses within 1e-4
relative; the gradients of sdf, deform, the table, the MLP's weights and
the light with cosine >= 0.999 and >= 99% of their entries within 1e-3
max|g|.  Then apply_grads on a pass-1 parameter tree against the JAX
package's rule (train.py:499-535): the light gradient times 64, the
table's times 128 / 8, the global-norm clip of geometry and material when
clip_max_norm > 0, Adam, the light's clamp; two steps on seeded
gradients, within 1e-5.  And a step at batch 2 in micro-batches of 1 on
two views of the repo's NeRF scene (taken to 48x48 by the non-integer
area path) against the mean of JAX's per-slice gradients, and against the
port's unsplit step.

Why 256 cells at the finest level: the two packages' G-buffer positions
differ in their last ulps, and the trilinear weights scale a position's
change by the level's cell count.  With a finest level of 4096 cells (the
default's) the step's gradients still agree with cosine >= 0.9995, but up
to 10% of the first MLP layer's entries then differ by more than 1e-3
max|g|; test_torch_hashgrid.py holds the encoding at 4096 cells on
identical points."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
import train as j_train
from nvdiffrecmc_tpu.config import apply_schedule_scaling
from nvdiffrecmc_tpu.geometry import dmtet as j_dmtet
from nvdiffrecmc_tpu.ops import envshade as j_envshade
from nvdiffrecmc_tpu.ops import hashgrid as j_hash
from nvdiffrecmc_tpu.ops import pallas_shade as j_ps
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch import convert
from nvdiffrecmc_tpu_torch import train as t_train
from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import make_light
from nvdiffrecmc_tpu_torch.geometry import dmtet as t_dmtet
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.ops import hashgrid as t_hash
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vecmath
from nvdiffrecmc_tpu_torch.render import light as t_light
from nvdiffrecmc_tpu_torch.render import render as t_render
from nvdiffrecmc_tpu_torch.render import texture as t_texture

RES, N, IT, GRID = 32, 2, 3, 8
CFG = dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=14,
           base_resolution=4, desired_resolution=256)
SETTINGS = dict(train_res=[RES, RES], n_samples=N, iter=100, layers=1,
                spp=1, batch=1, denoiser='bilateral', sdf_init='sphere',
                dmtet_grid=GRID)


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _views(batch):
    """The octasphere scene's camera, then one turned by 0.6 rad about y
    for each further view: (mesh, perms, [B, 4, 4], [B, 3])."""
    m, _, perms, mvp, campos = ge._make_scene(res=RES, n_samples=N)
    mvp, campos = np.asarray(mvp), np.asarray(campos)
    mvps, cams = [mvp[0]], [campos[0]]
    for i in range(1, batch):
        rot = t_vecmath.rotate_y(0.6 * i)
        mvps.append(mvp[0] @ rot)
        cams.append((rot.T @ np.append(campos[0], 1.0))[:3])
    return (m, perms, np.stack(mvps).astype(np.float32),
            np.stack(cams).astype(np.float32))


def _target(m, mvp, campos):
    """A ground-truth view of the octasphere (radius 1, inside the DMTet
    grid's [-1.05, 1.05]^3) under seeded textures and another light, over
    a random background."""
    rng = np.random.RandomState(8)
    kd = rng.uniform(0.1, 0.9, (1, 16, 16, 3)).astype(np.float32)
    ks = np.stack([np.zeros((16, 16)), rng.uniform(0.3, 0.7, (16, 16)),
                   rng.uniform(0.0, 1.0, (16, 16))], -1)[None]
    mesh = convert.mesh(m, device='cpu')
    mesh.material = {'bsdf': 'pbr',
                     'kd': t_texture.Texture2D(data=torch.as_tensor(kd)),
                     'ks': t_texture.Texture2D(data=torch.as_tensor(
                         ks.astype(np.float32)))}
    geo = TDLMesh(mesh, {})
    tm, bvh = geo.getMesh(geo.parameters(), mesh.material)
    base = convert.tensor(j_light.create_trainable_env_rnd(16, 0.5, 0.25),
                          device='cpu')
    gen = torch.Generator()
    gen.manual_seed(1)
    with torch.no_grad():
        img = t_render.render_mesh(
            {'n_samples': N}, tm, torch.as_tensor(mvp),
            torch.as_tensor(campos), make_light(base), (RES, RES), bvh,
            None, gen, msaa=True, denoiser_sigma=2.0,
            rnd_seed=9)['shaded'].numpy()
    bg = rng.rand(img.shape[0], RES, RES, 3).astype(np.float32)
    a = img[..., 3:4]
    mixed = np.concatenate([bg * (1 - a) + img[..., 0:3] * a, a], -1)
    return {'img': mixed, 'background': bg, 'mvp': mvp, 'campos': campos}


def _jax_scene(tmp_path, monkeypatch, batch):
    """JAX's flags, geometry, parameters and static material: the sphere
    SDF with seeded noise, a seeded deformation, init_mlp_texture with a
    seeded table in (-0.1, 0.1)."""
    monkeypatch.chdir(tmp_path)
    FLAGS = j_train.parse_flags([])
    FLAGS.update(SETTINGS, batch=batch)
    apply_schedule_scaling(FLAGS)
    geo = j_dmtet.DMTetGeometry(GRID, 2.1, FLAGS, max_tris=48 * GRID ** 2)
    rng = np.random.RandomState(12)
    sdf = np.asarray(geo.parameters()['sdf']) + rng.uniform(
        -0.05, 0.05, geo.verts.shape[1]).astype(np.float32)
    deform = rng.randn(3, geo.verts.shape[1]).astype(np.float32) * 0.3
    cfg = j_hash.HashEncodingConfig(**CFG)
    mlp = j_hash.init_mlp_texture(jax.random.PRNGKey(5), cfg, channels=6)
    mlp = mlp._replace(table=jnp.asarray(rng.uniform(
        -0.1, 0.1, mlp.table.shape).astype(np.float32)))
    _, static = j_train.initial_guess_material(geo, True, FLAGS)
    static = dict(static, cfg=cfg, no_perturbed_nrm=True)
    params = {'geo': {'sdf': jnp.asarray(sdf), 'deform': jnp.asarray(deform)},
              'mat': {'kd_ks': mlp},
              'light': j_light.create_trainable_env_rnd(16, 0.0, 0.5)}
    return FLAGS, geo, params, static


def _port_scene(FLAGS_j, jparams, batch):
    FLAGS = t_config.make_flags(**dict(SETTINGS, batch=batch))
    assert FLAGS['shadow_ramp_iters'] == FLAGS_j['shadow_ramp_iters']
    geo = t_dmtet.DMTetGeometry(GRID, 2.1, FLAGS, max_tris=48 * GRID ** 2,
                                device='cpu')
    _, static = t_train.initial_guess_material(geo, True, FLAGS,
                                               device='cpu')
    static = dict(static, cfg=t_hash.HashEncodingConfig(**CFG),
                  no_perturbed_nrm=True)
    tp = convert.params(jparams, device='cpu')
    params = {g: ({k: v.requires_grad_() for k, v in tp[g].items()}
                  if g != 'light' else tp[g].requires_grad_())
              for g in tp}
    return FLAGS, geo, params, static


def _flat(p):
    out = dict(p['geo'])
    out.update(p['mat'])
    out['light'] = p['light']
    return out


def _flat_jax(p):
    out = {'sdf': p['geo']['sdf'], 'deform': np.asarray(p['geo']['deform']).T,
           'table': np.asarray(p['mat']['kd_ks'].table).reshape(-1, 2),
           'light': p['light']}
    out.update(('w%d' % i, w) for i, w in
               enumerate(p['mat']['kd_ks'].weights))
    return out


@pytest.mark.parametrize('batch', [1, 2])
def test_pass1_step_matches_jax(tmp_path, monkeypatch, batch):
    m, perms, mvp, campos = _views(batch)
    target = _target(m, mvp, campos)
    tb = j_light.update_pdf(j_light.create_trainable_env_rnd(16, 0.0, 0.5))
    tables = (_bf16(tb.pdf), _bf16(tb.rows), _bf16(tb.cols))
    monkeypatch.setattr(j_envshade, 'env_shade', j_ps.env_shade_fused_jnp)
    jflags, jgeo, jparams, jstatic = _jax_scene(tmp_path, monkeypatch, batch)
    tgt = {k: jnp.asarray(v) for k, v in target.items()}
    tgt.update(resolution=(RES, RES), spp=1)
    loss_obj = j_train.createLoss(jflags)
    ramp = jnp.minimum(jnp.float32(IT) / jflags['shadow_ramp_iters'], 1.0)
    sigma = jnp.maximum(2.0 * ramp, 1e-4)

    def loss_fn(p):
        lgt = {'base': p['light'], 'pdf': jnp.asarray(tables[0]),
               'rows': jnp.asarray(tables[1]), 'cols': jnp.asarray(tables[2])}
        material = j_train.make_material(p['mat'], jstatic)
        il, rl = jgeo.tick(p['geo'], material, lgt, tgt, loss_obj,
                           jnp.float32(IT), jflags, sigma, perms,
                           jax.random.PRNGKey(11), rnd_seed=jnp.int32(IT))
        return il + rl, (il, rl)
    jgrads, (jil, jrl) = jax.grad(loss_fn, has_aux=True)(jparams)

    FLAGS, geo, params, static = _port_scene(jflags, jparams, batch)
    assert t_train.denoiser_sigma(IT, FLAGS) == float(sigma)
    P = batch * RES * RES
    u8 = j_ps.make_uniforms(jax.random.PRNGKey(IT), N * N, P, N, perms)
    kj, km, _ = jax.random.split(
        jax.random.split(jax.random.PRNGKey(11), 1)[0], 3)
    offset = jax.random.normal(kj, (batch, RES, RES, 2)) * 0.005
    noise = jax.random.normal(km, (batch, RES, RES, 3)) * 0.01
    port_tables = t_light.LightTables(*(torch.as_tensor(np.array(x))
                                        for x in tables))
    monkeypatch.setattr(t_train.light_mod, 'update_pdf',
                        lambda base: port_tables)
    il, rl = t_train.compute_grads(
        geo, params, static, {k: torch.as_tensor(np.array(v))
                              for k, v in target.items()},
        IT, FLAGS, t_train.createLoss(FLAGS),
        convert.tensor(perms, device='cpu'), None,
        uniforms=[convert.tensor(u8, device='cpu')],
        offsets=[(convert.tensor(offset, device='cpu'),
                  convert.tensor(noise, device='cpu'))])
    np.testing.assert_allclose(float(il), float(jil), rtol=1e-4)
    np.testing.assert_allclose(float(rl), float(jrl), rtol=1e-4)

    live = int(geo.tri_count(params['geo'])[0])
    assert 0 < live <= geo.max_tris
    want = _flat_jax(jgrads)
    for k, p in _flat(params).items():
        g, w = p.grad.numpy().ravel(), np.asarray(want[k]).ravel()
        assert np.isfinite(g).all() and np.abs(g).max() > 0.0, k
        cos = np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w))
        close = (np.abs(g - w) <= 1e-3 * np.abs(w).max()).mean()
        assert cos >= 0.999 and close >= 0.99, (k, cos, close)


def _jax_apply(FLAGS, params, grads, steps):
    """The JAX package's apply_grads (train.py:499-535) for pass 1 with a
    neural material, warm-up 0: the light gradient times 64, the table's
    times 128 / 8, the global-norm clip of geometry and material, Adam, the
    light's clamp at 0.01."""
    rate = FLAGS['lr_decay_rate']

    def adam(lr):
        return optax.adam(lambda c: lr * jnp.power(10.0, -c * rate),
                          b1=0.9, b2=0.999, eps=1e-8)
    opts = {'geo': adam(0.01), 'mat': adam(0.01), 'light': adam(0.03)}
    state = {k: opts[k].init(params[k]) for k in opts}
    for _ in range(steps):
        g = dict(grads)
        g['light'] = grads['light'] * 64.0
        kd_ks = grads['mat']['kd_ks']
        g['mat'] = {'kd_ks': kd_ks._replace(table=kd_ks.table * (128.0 / 8.0))}
        if FLAGS['clip_max_norm'] > 0.0:
            norm = optax.global_norm({'geo': g['geo'], 'mat': g['mat']})
            scale = jnp.minimum(1.0, FLAGS['clip_max_norm']
                                / jnp.maximum(norm, 1e-12))
            g['geo'] = jax.tree.map(lambda x: x * scale, g['geo'])
            g['mat'] = jax.tree.map(lambda x: x * scale, g['mat'])
        new = dict(params)
        for k in opts:
            upd, state[k] = opts[k].update(g[k], state[k])
            new[k] = optax.apply_updates(params[k], upd)
        new['light'] = jnp.clip(new['light'], min=0.01)
        params = new
    return params


@pytest.mark.parametrize('clip', [0.0, 0.5])
def test_apply_grads_pass1_matches_jax(tmp_path, monkeypatch, clip):
    """Two steps of apply_grads on a pass-1 tree (sdf, deform, table,
    weights, light) with seeded gradients, the table's scale and, at 0.5,
    the clip (the gradients' global norm is ~100, so the clip binds)."""
    jflags, _, jparams, jstatic = _jax_scene(tmp_path, monkeypatch, 1)
    jflags['clip_max_norm'] = clip
    rng = np.random.RandomState(21)
    jgrads = jax.tree.map(lambda x: jnp.asarray(
        0.1 * rng.randn(*x.shape).astype(np.float32)), jparams)
    norm = float(optax.global_norm({'geo': jgrads['geo'],
                                    'mat': jgrads['mat']}))
    assert norm > 10.0 * max(clip, 0.1)
    want = _flat_jax(_jax_apply(jflags, jparams, jgrads, 2))

    FLAGS = t_config.make_flags(**dict(SETTINGS, clip_max_norm=clip))
    _, _, params, static = _port_scene(jflags, jparams, 1)
    opts = t_train.make_optimizers(params, FLAGS)
    tg = _flat(convert.params(jgrads, device='cpu'))
    for _ in range(2):
        for k, p in _flat(params).items():
            p.grad = tg[k].clone()
        t_train.apply_grads(params, opts, static, FLAGS)
    for k, p in _flat(params).items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


NERF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'data', 'nerf_synthetic_spot', 'transforms_train.json')
MICRO_RES, MICRO_FRAMES = 48, (3, 17)


def _nerf_targets(jflags):
    """Two views of the repo's NeRF scene, 800x800 taken to 48x48 by the
    area path at a non-integer ratio, over a white background: the JAX
    package's (its DatasetNERF, collate and prepare_batch) and the port's
    (the same through the port's)."""
    from nvdiffrecmc_tpu.dataset import DatasetNERF as JNERF
    from nvdiffrecmc_tpu_torch.dataset import DatasetNERF as TNERF
    dflags = {'pre_load': False, 'cam_near_far': [0.1, 1000.0],
              'train_res': [800, 800], 'spp': 1}
    res = (MICRO_RES, MICRO_RES)
    jds = JNERF(NERF, dflags)
    jt = j_train.prepare_batch(jds.collate([jds[i] for i in MICRO_FRAMES]),
                               res, 'white', None, jflags)
    tds = TNERF(NERF, dflags, device='cpu')
    tt = t_train.prepare_batch(tds.collate([tds[i] for i in MICRO_FRAMES]),
                               res, 'white', None, None)
    for k in ('img', 'background', 'mvp', 'campos'):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    return jt, tt


def test_pass1_micro_batch_matches_jax(tmp_path, monkeypatch):
    """A pass-1 step at batch 2 split into micro-batches of 1, on two views
    of the NeRF scene at 48x48: the port's micro_grads against the mean of
    JAX's per-slice gradients (DMTetGeometry.tick under jax.grad on each
    slice with its own key; the same uniforms, jitter and position noise
    fed to the port; each slice's uniforms its own, from rnd_seed IT + i),
    within the tolerances of test_pass1_step_matches_jax; then the port's unsplit batch-2 gradient
    from the slices' uniforms and offsets concatenated, against its
    micro-batched one: the losses within 1e-5 relative, each gradient with
    cosine >= 0.99999 and every entry within 5e-3 max|g| (the two differ
    only in the order of float32 sums, over 2,304 pixels a slice against
    4,608 at once, and the MLP's and the light's gradients cancel: up to
    1.9e-3 max|g| was seen)."""
    tb = j_light.update_pdf(j_light.create_trainable_env_rnd(16, 0.0, 0.5))
    tables = (_bf16(tb.pdf), _bf16(tb.rows), _bf16(tb.cols))
    monkeypatch.setattr(j_envshade, 'env_shade', j_ps.env_shade_fused_jnp)
    jflags, jgeo, jparams, jstatic = _jax_scene(tmp_path, monkeypatch, 2)
    jflags.update(train_res=[MICRO_RES, MICRO_RES], micro_batch=1)
    jt, tt = _nerf_targets(jflags)
    perms = ge._make_scene(res=MICRO_RES, n_samples=N)[2]
    loss_obj = j_train.createLoss(jflags)
    ramp = jnp.minimum(jnp.float32(IT) / jflags['shadow_ramp_iters'], 1.0)
    sigma = jnp.maximum(2.0 * ramp, 1e-4)
    P = MICRO_RES * MICRO_RES
    u8 = [j_ps.make_uniforms(jax.random.PRNGKey(IT + i), N * N, P, N, perms)
          for i in range(2)]

    jgrads, jil, jrl, offsets = None, 0.0, 0.0, []
    for i in range(2):
        sl = {k: jnp.asarray(jt[k])[i:i + 1]
              for k in ('img', 'background', 'mvp', 'campos')}
        sl.update(resolution=(MICRO_RES, MICRO_RES), spp=1)
        key = jax.random.PRNGKey(11 + i)

        def loss_fn(p):
            lgt = {'base': p['light'], 'pdf': jnp.asarray(tables[0]),
                   'rows': jnp.asarray(tables[1]),
                   'cols': jnp.asarray(tables[2])}
            material = j_train.make_material(p['mat'], jstatic)
            il, rl = jgeo.tick(p['geo'], material, lgt, sl, loss_obj,
                               jnp.float32(IT), jflags, sigma, perms, key,
                               rnd_seed=jnp.int32(IT + i))
            return il + rl, (il, rl)
        g, (il, rl) = jax.grad(loss_fn, has_aux=True)(jparams)
        jgrads = g if jgrads is None else jax.tree.map(jnp.add, jgrads, g)
        jil, jrl = jil + il, jrl + rl
        kj, km, _ = jax.random.split(jax.random.split(key, 1)[0], 3)
        offsets.append((
            convert.tensor(jax.random.normal(
                kj, (1, MICRO_RES, MICRO_RES, 2)) * 0.005, device='cpu'),
            convert.tensor(jax.random.normal(
                km, (1, MICRO_RES, MICRO_RES, 3)) * 0.01, device='cpu')))
    jgrads = jax.tree.map(lambda x: x / 2.0, jgrads)

    FLAGS, geo, params, static = _port_scene(jflags, jparams, 2)
    FLAGS.update(train_res=[MICRO_RES, MICRO_RES], micro_batch=1)
    assert t_config.micro_slices(FLAGS) == 2
    port_tables = t_light.LightTables(*(torch.as_tensor(np.array(x))
                                        for x in tables))
    monkeypatch.setattr(t_train.light_mod, 'update_pdf',
                        lambda base: port_tables)
    tu = [convert.tensor(u, device='cpu') for u in u8]
    assert not torch.equal(tu[0], tu[1])
    target = {k: tt[k] for k in ('img', 'background', 'mvp', 'campos')}
    tperms = convert.tensor(perms, device='cpu')
    il, rl = t_train.micro_grads(
        geo, params, static, target, IT, FLAGS, t_train.createLoss(FLAGS),
        tperms, None, uniforms=[[u] for u in tu],
        offsets=[[o] for o in offsets])
    np.testing.assert_allclose(float(il), float(jil) / 2, rtol=1e-4)
    np.testing.assert_allclose(float(rl), float(jrl) / 2, rtol=1e-4)
    want = _flat_jax(jgrads)
    micro = {}
    for k, p in _flat(params).items():
        g, w = p.grad.numpy().ravel(), np.asarray(want[k]).ravel()
        assert np.isfinite(g).all() and np.abs(g).max() > 0.0, k
        cos = np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w))
        close = (np.abs(g - w) <= 1e-3 * np.abs(w).max()).mean()
        assert cos >= 0.999 and close >= 0.99, (k, cos, close)
        micro[k] = g

    FLAGS.update(micro_batch=0)
    assert t_config.micro_slices(FLAGS) == 1
    t_train.clear_grads(params)
    il0, rl0 = t_train.compute_grads(
        geo, params, static, target, IT, FLAGS, t_train.createLoss(FLAGS),
        tperms, None, uniforms=[torch.cat(tu, dim=2)],
        offsets=[tuple(torch.cat(x) for x in zip(*offsets))])
    np.testing.assert_allclose(float(il0), float(il), rtol=1e-5)
    np.testing.assert_allclose(float(rl0), float(rl), rtol=1e-5)
    for k, p in _flat(params).items():
        g, w = p.grad.numpy().ravel(), micro[k]
        cos = np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w))
        err = np.abs(g - w).max()
        assert cos >= 0.99999 and err <= 5e-3 * np.abs(w).max(), \
            (k, cos, err)
