"""Port parity, custom mips (the custom_mip flag: every texture an explicit
mip list whose levels train on their own).  Against the JAX package:
texture.create_trainable(auto_mipmaps=False)'s chain (each level within
1e-6: the same halving by scale_img_nhwc's area average; within 4e-6
where the base level is first upscaled, whose bilinear blend the two
packages round apart by up to ~2e-6 on [-1, 1] values), the sampled
values and the gradients of every level of a chain (atol 1e-5, as
texture_sample_multi's parity test), initial_guess_material's lists, and
two steps of apply_grads on them (Adam per level, the projections on
every level; within 1e-5 of the JAX rule on the same gradients, as
tests/test_torch_step.py holds the single-level update).  Then a 32x32
pass-2 step on the CPU sends a finite gradient to every level and keeps
each in its bounds, and the program (tests/test_torch_program.py's
config with -mip) stopped after its checkpoint and resumed equals the
uninterrupted run bit for bit, and exports every level, which load_obj
of both packages reads back as the same chain (within 1 / 255 of the
trained levels after the PNG's rounding; the port's read within 2e-7
relative of JAX's, kd's sRGB-to-linear pow an ulp apart)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import train as j_train
from nvdiffrecmc_tpu.config import apply_schedule_scaling
from nvdiffrecmc_tpu.geometry.dlmesh import DLMesh as JDLMesh
from nvdiffrecmc_tpu.ops import texture as j_tex
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import obj as j_obj
from nvdiffrecmc_tpu.render import texture as j_texture
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch import convert
from nvdiffrecmc_tpu_torch import train as t_train
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.render import light as t_light
from nvdiffrecmc_tpu_torch.render import obj as t_obj
from nvdiffrecmc_tpu_torch.render import texture as t_texture
from test_torch_program import _Stop, program_argv
from test_torch_program import _one_thread  # noqa: F401  (autouse)
from test_torch_step import SETTINGS, _jax_apply

RES = 32


def _init_textures(rng):
    """kd, ks and normal maps of 16x16 as numpy [1, 16, 16, 3]."""
    nrm = rng.randn(1, 16, 16, 3) + np.array([0.0, 0.0, 2.0])
    return dict(kd=rng.uniform(0.1, 0.9, (1, 16, 16, 3)),
                ks=np.concatenate([np.zeros((1, 16, 16, 1)),
                                   rng.uniform(0.2, 0.8, (1, 16, 16, 2))],
                                  -1),
                normal=nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))


@pytest.mark.parametrize('shape, res', [((8, 8), (16, 16)),
                                        ((16, 8), (16, 8))])
def test_explicit_chain_matches_jax(shape, res):
    img = np.random.RandomState(0).rand(*shape, 3).astype(np.float32)
    want = j_texture.create_trainable(img, res, auto_mipmaps=False)
    got = t_texture.create_trainable(img, res, auto_mipmaps=False,
                                     device='cpu')
    assert isinstance(got.data, list) and len(got.data) == len(want.data)
    assert tuple(got.data[-1].shape[1:3]) == (1, 1)
    for g, w in zip(got.data, want.data):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    # every level a tensor of its own
    assert len({m.data_ptr() for m in got.data}) == len(got.data)


def test_chain_sample_and_grads_match_jax():
    rng = np.random.RandomState(1)
    chain = [np.asarray(m) for m in j_texture.create_trainable(
        rng.rand(16, 16, 3).astype(np.float32), None, False).data]
    uv = rng.uniform(-0.3, 1.3, (1, 20, 24, 2)).astype(np.float32)
    # footprints from magnification to far minification (every level)
    da = (rng.randn(1, 20, 24, 4)
          * np.exp(rng.uniform(-8, 1, (1, 20, 24, 1)))).astype(np.float32)
    g = rng.randn(1, 20, 24, 3).astype(np.float32)

    @jax.jit
    def sample_and_vjp(chain, cot):
        out, vjp = jax.vjp(lambda *m: j_tex.texture_sample(
            list(m), jnp.asarray(uv), jnp.asarray(da)), *chain)
        return out, vjp(cot)
    want, want_g = sample_and_vjp(tuple(jnp.asarray(m) for m in chain),
                                  jnp.asarray(g))
    leaves = [torch.as_tensor(m).requires_grad_() for m in chain]
    got = t_texture.Texture2D(data=leaves).sample(torch.as_tensor(uv),
                                                  torch.as_tensor(da))
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    for level, (leaf, w) in enumerate(zip(leaves, want_g)):
        assert np.abs(np.asarray(w)).max() > 0.0, level
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-5, err_msg=str(level))


def _flat(p):
    leaves = {'v_pos': p['geo']['v_pos'], 'light': p['light']}
    for k in ('kd', 'ks', 'normal'):
        leaves.update(('%s_%d' % (k, i), m) for i, m in
                      enumerate(p['mat'][k]))
    return leaves


def test_apply_grads_on_mip_lists_matches_jax():
    """initial_guess_material's lists from a material's textures, then two
    steps of apply_grads on seeded gradients, against JAX."""
    m = ge._make_scene(res=RES, n_samples=2)[0]
    init = _init_textures(np.random.RandomState(2))
    jflags = j_train.parse_flags([])
    jflags.update(SETTINGS, custom_mip=True)
    apply_schedule_scaling(jflags)
    jgeo = JDLMesh(m, jflags)
    jmat, jstatic = j_train.initial_guess_material(
        jgeo, False, jflags, init_mat={k: j_texture.Texture2D(
            data=jnp.asarray(v, jnp.float32)) for k, v in init.items()})
    jparams = {'geo': jgeo.parameters(), 'mat': jmat,
               'light': j_light.create_trainable_env_rnd(16, 0.5, 0.0)}
    rng = np.random.RandomState(3)
    jgrads = jax.tree.map(lambda x: jnp.asarray(
        0.1 * rng.randn(*x.shape).astype(np.float32)), jparams)
    want = _flat(jax.jit(lambda p, g: _jax_apply(jflags, p, jstatic, g, 2))(
        jparams, jgrads))

    FLAGS = t_config.make_flags(**SETTINGS, custom_mip=True)
    geo = TDLMesh(convert.mesh(m, device='cpu'), FLAGS)
    mat_params, mat_static = t_train.initial_guess_material(
        geo, False, FLAGS, init_mat={k: t_texture.Texture2D(
            data=torch.as_tensor(v, dtype=torch.float32))
            for k, v in init.items()}, device='cpu')
    for k in ('kd', 'ks', 'normal'):
        assert isinstance(mat_params[k], list) and len(mat_params[k]) == 6
        for g, w in zip(mat_params[k], jmat[k]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=4e-6, err_msg=k)
    params = t_train.make_params(
        geo, mat_params, t_light.create_trainable_env_rnd(16, 0.5, 0.0,
                                                          device='cpu'))
    opts = t_train.make_optimizers(params, FLAGS)
    grads = _flat(convert.params(jgrads, device='cpu'))
    for _ in range(2):
        for k, p in _flat(params).items():
            p.grad = grads[k].clone()
        t_train.apply_grads(params, opts, mat_static, FLAGS)
    for k, p in _flat(params).items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_step_reaches_every_level():
    """One 32x32 train_step with custom mips from a material's textures:
    every level's gradient finite, the finest nonzero, and after the
    step each level inside its bounds, the normal map's of unit length."""
    m, _, perms, mvp, campos = ge._make_scene(res=RES, n_samples=2)
    FLAGS = t_config.make_flags(**dict(SETTINGS, train_res=[RES, RES]),
                                custom_mip=True)
    geo = TDLMesh(convert.mesh(m, device='cpu'), FLAGS)
    init = _init_textures(np.random.RandomState(4))
    mat_params, mat_static = t_train.initial_guess_material(
        geo, False, FLAGS, init_mat={k: t_texture.Texture2D(
            data=torch.as_tensor(v, dtype=torch.float32))
            for k, v in init.items()}, device='cpu')
    params = t_train.make_params(
        geo, mat_params, t_light.create_trainable_env_rnd(16, 0.0, 0.5,
                                                          device='cpu'))
    opts = t_train.make_optimizers(params, FLAGS)
    rng = np.random.RandomState(5)
    bg = torch.as_tensor(rng.rand(1, RES, RES, 3).astype(np.float32))
    target = {'img': torch.cat([torch.as_tensor(rng.rand(
        1, RES, RES, 3).astype(np.float32)), torch.ones(1, RES, RES, 1)], -1),
        'background': bg, 'mvp': convert.tensor(mvp, device='cpu'),
        'campos': convert.tensor(campos, device='cpu')}
    gen = torch.Generator()
    gen.manual_seed(6)
    t_train.micro_grads(geo, params, mat_static, target, 0, FLAGS,
                        t_train.createLoss(FLAGS),
                        convert.tensor(perms, device='cpu'), gen)
    for k in ('kd', 'ks', 'normal'):
        for i, p in enumerate(params['mat'][k]):
            assert p.grad is not None and bool(torch.isfinite(p.grad).all())
        assert float(params['mat'][k][0].grad.abs().max()) > 0.0, k
    t_train.apply_grads(params, opts, mat_static, FLAGS)
    for k in ('kd', 'ks', 'normal'):
        lo, hi = (b[:3] for b in mat_static['min_max'][k])
        for p in params['mat'][k]:
            assert bool(((p >= lo - 1e-6) & (p <= hi + 1e-6)).all()), k
    for p in params['mat']['normal']:
        torch.testing.assert_close(torch.linalg.vector_norm(p, dim=-1),
                                   torch.ones(p.shape[:-1]), atol=1e-5,
                                   rtol=0)


def test_custom_mip_program_resumes_and_exports(tmp_path, monkeypatch):
    whole = t_train.main(program_argv(str(tmp_path / 'a'), 'run', '-mip',
                                      '--checkpoint-interval', '2'),
                         device='cpu')
    argv = program_argv(str(tmp_path / 'b'), 'run', '-mip',
                        '--checkpoint-interval', '2')
    save = t_train.save_checkpoint

    def save_then_stop(path, it, **state):
        save(path, it, **state)
        raise _Stop(it)
    monkeypatch.setattr(t_train, 'save_checkpoint', save_then_stop)
    with pytest.raises(_Stop):
        t_train.main(argv, device='cpu')
    monkeypatch.setattr(t_train, 'save_checkpoint', save)
    resumed = t_train.main(argv, device='cpu')
    for k in ('kd', 'ks', 'normal'):
        assert isinstance(whole['mat'][k], list)
        assert len(whole['mat'][k]) == 6         # 32x32 down to 1x1
        for a, b in zip(whole['mat'][k], resumed['mat'][k]):
            assert torch.equal(a, b), k
    assert torch.equal(whole['light'], resumed['light'])

    mesh_dir = os.path.join(str(tmp_path / 'b'), 'run', 'mesh')
    mtl = open(os.path.join(mesh_dir, 'mesh.mtl')).read()
    assert 'map_Kd texture_kd.png' in mtl and 'bump texture_n.png' in mtl
    for k, name in (('kd', 'kd'), ('ks', 'ks'), ('normal', 'n')):
        for i in range(6):
            assert os.path.exists(os.path.join(
                mesh_dir, 'texture_%s_%d.png' % (name, i))), (k, i)
    got = t_obj.load_obj(os.path.join(mesh_dir, 'mesh.obj'), device='cpu')
    want = j_obj.load_obj(os.path.join(mesh_dir, 'mesh.obj'))
    for k in ('kd', 'ks', 'normal'):
        assert len(got.material[k].data) == 6
        for g, w in zip(got.material[k].data, want.material[k].data):
            # kd's sRGB-to-linear pow: an ulp apart between the libraries
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7,
                                       atol=0)
    # kd and ks (0.5 / 255 of the PNG's rounding, ks's red cleared on
    # load as clear_ks does; kd through the sRGB round trip within 1 / 255)
    for k in ('kd', 'ks'):
        for g, p in zip(got.material[k].data, resumed['mat'][k]):
            diff = (g - p.detach())[..., 1:] if k == 'ks' else g - p.detach()
            assert float(diff.abs().max()) <= 1.0 / 255.0 + 1e-6, k
