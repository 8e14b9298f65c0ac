"""Port parity, transparency beyond the step (tests/test_torch_transparency.py
holds the render and the step): the validation render at 8 layers, the
bake's alpha, and the two-pass program with transparency on the CPU.

- render_eval at 8 layers (n_samples 17: 289 strata, the stratum loop, no
  denoiser, seed 1000 + i for layer i) against JAX render_mesh on the
  nested open boxes of tests/test_torch_transparency.py at 32x32 under
  test_torch_validate's smooth probe (the port's sampler uses the fused
  pipeline's polynomial atan2 / acos, so a sample may land one texel over),
  fed the JAX loop's draws of each layer (test_torch_validate.
  jax_loop_uniforms); kd, ks and normal within 1e-4 on >= 99.9% of the
  pixels, the Monte-Carlo buffers on >= 99.5%; both packages pick the same
  foreground at every triangle edge of every layer (_fg_flips).
- bake_textures with transparency on the pass-boundary scene of
  tests/test_torch_boundary.py: kd[..., :3], ks and the normal map as that
  file holds them (kd and ks within 1e-5 on >= 99.9% of the texels, the
  normal map equal), with JAX's alpha fed through bake_alpha (asked for
  [1, H, W, 1] on the bake's device) and the whole RGBA kd as JAX's;
  bake_alpha's own draw [1, H, W, 1] float32 in [0, 1), the same on every
  call.
- main on test_torch_datasets.nerf_argv's NeRF folder with transparency,
  3 iterations a pass at batch 1, no denoiser (the plain one is most of a
  CPU step at 8 layers; tests/test_torch_transparency.py's step holds
  it), validation off: pass 1 at 1 layer and
  pass 2 at 8; dmtet_mesh/ and mesh/ each hold an RGBA texture_kd.png,
  mesh/'s within 1/255 of the trained kd (sRGB, alpha linear) read back
  through load_obj; a run stopped right after pass 2's checkpoint at
  iteration 1 and resumed equals the whole run bit for bit, and the
  checkpoint holds the 4-channel kd."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as j_train
from nvdiffrecmc_tpu.geometry.dlmesh import DLMesh as JDLMesh
from nvdiffrecmc_tpu.ops import envshade as j_es
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import render as j_render
from nvdiffrecmc_tpu_torch import convert, train
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vecmath
from nvdiffrecmc_tpu_torch.render import obj as t_obj
from nvdiffrecmc_tpu_torch.render import texture as t_texture
from test_torch_boundary import scene  # noqa: F401  (a fixture)
from test_torch_datasets import nerf_argv
from test_torch_transparency import (LAYERS, MC_BUFFERS, _agree, _fg_flips,
                                     _jit_jax, _nested)
from test_torch_validate import _smooth_probe, jax_loop_uniforms


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_render_eval_8_layers_matches_jax():
    res, n = 32, 17
    m, _, _, mvp, campos = _nested(res)
    base = _smooth_probe()
    tb = j_light.update_pdf(base)
    lgt = {'base': base, 'pdf': tb.pdf, 'rows': tb.rows, 'cols': tb.cols}
    FLAGS = {'n_samples': n, 'layers': LAYERS, 'spp': 1,
             'denoiser_demodulate': True, 'train_res': [res, res]}
    checker = t_vecmath.checkerboard((res, res), 8)[None]
    perms = j_es.make_perms(n, n_tables=4)
    jrasts = []
    with pytest.MonkeyPatch.context() as mp:
        _jit_jax(mp, fused=False)
        gbuffer = j_render.render_gbuffer

        def rasts(*a, **k):
            out = gbuffer(*a, **k)
            jrasts.extend(rast for _, rast in out[1])
            return out
        mp.setattr(j_render, 'render_gbuffer', rasts)
        jgeo = JDLMesh(m, FLAGS)
        jmesh, jbvh = jgeo.getMesh(jgeo.parameters(), m.material)
        want = j_render.render_mesh(
            FLAGS, jmesh, mvp, campos, lgt, (res, res), jbvh, perms,
            jax.random.PRNGKey(0), spp=1, num_layers=LAYERS, msaa=False,
            background=jnp.asarray(checker), denoiser_sigma=None,
            shadow_scale=1.0, rnd_seed=1000)

    tgeo = TDLMesh(convert.mesh(m, device='cpu'), FLAGS)
    mat_params = {k: convert.tensor(m.material[k].data, device='cpu')
                  for k in ('kd', 'ks', 'normal')}
    mat_static = {'kind': 'tex', 'bsdf': 'pbr', 'no_perturbed_nrm': False,
                  'min_max': {'kd': None, 'ks': None, 'normal': None}}
    target = {'mvp': convert.tensor(mvp, device='cpu'),
              'campos': convert.tensor(campos, device='cpu'),
              'background': torch.as_tensor(checker),
              'resolution': (res, res)}
    layers = []
    with pytest.MonkeyPatch.context() as mp:
        finish = train.render_mod.render_finish

        def keep(*a, **k):
            layers.extend(rast for _, rast in a[3])
            return finish(*a, **k)
        mp.setattr(train.render_mod, 'render_finish', keep)
        got = train.render_eval(
            tgeo, tgeo.parameters(), mat_params, mat_static,
            convert.tensor(lgt['base'], device='cpu'), target, FLAGS,
            n_samples=n, uniforms=[jax_loop_uniforms(1000 + i, n, res * res,
                                                     perms)
                                   for i in range(LAYERS)])
    assert set(got) == set(want)
    assert len(layers) == LAYERS
    assert _fg_flips(layers, jrasts) == 0
    _agree(got, want, ('kd', 'ks', 'normal'), 0.999)
    _agree(got, want, MC_BUFFERS, 0.995)
    alpha = got['shaded'][..., 3]
    assert float((alpha > 0).float().mean()) > 0.2
    assert float(alpha.max()) < 1.0


def test_bake_textures_with_transparency_matches_jax(scene, monkeypatch):
    jflags = dict(scene['jflags'], transparency=True)
    tflags = dict(scene['tflags'], transparency=True)
    _, jtex = j_train.bake_textures(scene['jg'], scene['jparams'],
                                    scene['jmat'], scene['jstatic'], jflags)
    jm = j_train.extract_static_mesh(scene['jg'], scene['jparams'], jflags)

    def extract(geometry, params, FLAGS, times):
        times['prune'] = 0.0
        return convert.mesh(jm, device='cpu')
    monkeypatch.setattr(train, 'extract_static_mesh', extract)
    H, W = tflags['texture_res']
    jalpha = np.array(jtex['kd'][..., 3:4])
    asked = []

    def fed(shape, device):
        asked.append((tuple(shape), torch.device(device).type))
        return torch.as_tensor(jalpha)
    monkeypatch.setattr(train, 'bake_alpha', fed)
    ttex = train.bake_textures(scene['tg'], scene['tparams'], scene['tmat'],
                               scene['tstatic'], tflags)[1]
    assert asked == [((1, H, W, 1), 'cpu')]
    assert ttex['kd'].shape == jalpha.shape[:3] + (4,)
    for k in ('kd', 'ks'):
        d = np.abs(ttex[k].numpy() - np.asarray(jtex[k])).max(-1)
        assert (d <= 1e-5).mean() >= 0.999, k
    np.testing.assert_array_equal(ttex['kd'][..., 3:4].numpy(), jalpha)
    np.testing.assert_array_equal(ttex['normal'].numpy(),
                                  np.asarray(jtex['normal']))

    monkeypatch.undo()
    alpha = train.bake_alpha((1, H, W, 1), 'cpu')
    assert alpha.shape == (1, H, W, 1) and alpha.dtype == torch.float32
    assert bool(((alpha >= 0) & (alpha < 1)).all())
    assert 0.4 < float(alpha.mean()) < 0.6
    assert torch.equal(alpha, train.bake_alpha((1, H, W, 1), 'cpu'))


class _Stop(Exception):
    pass


def _transparent_argv(folder):
    argv = nerf_argv(folder, '-i', '3', '-b', '1', '--checkpoint-interval',
                     '1', '--denoiser', 'none')
    with open(argv[1]) as f:
        cfg = json.load(f)
    cfg['transparency'] = True
    with open(argv[1], 'w') as f:
        json.dump(cfg, f)
    return argv


def test_main_with_transparency(tmp_path, monkeypatch, capsys):
    whole = train.main(_transparent_argv(str(tmp_path / 'a')), device='cpu')
    out = capsys.readouterr().out
    assert 'dmtet_pass1: 3 steps from iteration 0' in out
    assert 'of 1 micro-steps at 1 layers;' in out.split('dmtet_pass1: 3')[1]
    assert 'mesh_pass: 3 steps from iteration 0' in out
    assert 'of 1 micro-steps at 8 layers;' in out.split('mesh_pass: 3')[1]
    run = os.path.join(str(tmp_path / 'a'), 'run')
    for d in ('dmtet_mesh', 'mesh'):
        with open(os.path.join(run, d, 'texture_kd.png'), 'rb') as f:
            assert t_texture.decode_png(f.read()).shape[-1] == 4, d
    kd = whole['mat']['kd'].detach()
    assert kd.shape[-1] == 4
    back = t_obj.load_obj(os.path.join(run, 'mesh', 'mesh.obj'),
                          device='cpu').material['kd'].data
    assert back.shape == kd.shape
    png = t_texture.load_image(os.path.join(run, 'mesh', 'texture_kd.png'))
    want = t_vecmath.rgb_to_srgb(kd)[0].numpy()
    assert np.abs(png - want).max() <= 0.5 / 255 + 1e-6
    assert np.abs(back[..., 3].numpy() - kd[..., 3].numpy()).max() \
        <= 0.5 / 255 + 1e-6

    argv = _transparent_argv(str(tmp_path / 'b'))
    save = train.save_checkpoint

    def save_then_stop(path, it, **state):
        save(path, it, **state)
        if 'mesh_pass' in path:
            raise _Stop(it)
    monkeypatch.setattr(train, 'save_checkpoint', save_then_stop)
    with pytest.raises(_Stop):
        train.main(argv, device='cpu')
    monkeypatch.setattr(train, 'save_checkpoint', save)
    ckpt = torch.load(os.path.join(str(tmp_path / 'b'), 'run',
                                   'checkpoint_mesh_pass.pkl'),
                      weights_only=True)
    assert ckpt['iteration'] == 1
    assert ckpt['params']['mat']['kd'].shape[-1] == 4
    resumed = train.main(argv, device='cpu')
    assert 'Resumed' in capsys.readouterr().out
    for group in ('geo', 'mat'):
        for k, v in whole[group].items():
            assert torch.equal(v, resumed[group][k]), (group, k)
    assert torch.equal(whole['light'], resumed['light'])
