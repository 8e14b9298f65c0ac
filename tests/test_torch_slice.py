"""Port parity, the whole slice: DLMesh.getMesh + render_mesh forward of
both packages on one scene carried over by nvdiffrecmc_tpu_torch.convert
(the textured octasphere of __graft_entry__._make_scene, 64x64, n_samples
2, one layer, MSAA, white background, denoiser sigma 2.0).  The JAX side
shades with env_shade_fused_jnp and the port consumes the same
make_uniforms array.  Tolerances: kd, ks, normal atol 1e-4 on >= 99.9% of
pixels (triangle ids); the Monte-Carlo buffers atol 1e-4 on >= 99.5%
(grazing shadow rays may flip).  Also: importing the port never imports
JAX."""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as ge
from nvdiffrecmc_tpu.geometry.dlmesh import DLMesh as JDLMesh
from nvdiffrecmc_tpu.ops import envshade as j_envshade
from nvdiffrecmc_tpu.ops import pallas_shade as j_ps
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import render as j_render
from nvdiffrecmc_tpu.render import texture as j_texture
from nvdiffrecmc_tpu_torch import convert
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.render import render as t_render

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, N_SAMPLES, SEED = 64, 2, 5


def _jax_scene():
    m, base, perms, mvp, campos = ge._make_scene(res=RES, n_samples=N_SAMPLES)
    rng = np.random.RandomState(0)
    kd = rng.uniform(0.1, 0.9, (1, 32, 32, 3)).astype(np.float32)
    ks = np.stack([np.zeros((32, 32)), rng.uniform(0.4, 0.7, (32, 32)),
                   rng.uniform(0.0, 1.0, (32, 32))], -1)[None]
    m.material = {'bsdf': 'pbr',
                  'kd': j_texture.Texture2D(data=jnp.asarray(kd)),
                  'ks': j_texture.Texture2D(
                      data=jnp.asarray(ks.astype(np.float32)))}
    tb = j_light.update_pdf(base)

    def rnd(x):      # bf16-exact tables: the JAX twin's gathers round to bf16
        return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    lgt = {'base': base, 'pdf': rnd(tb.pdf), 'rows': rnd(tb.rows),
           'cols': rnd(tb.cols)}
    return m, lgt, perms, mvp, campos


def test_render_mesh_matches_jax(monkeypatch):
    m, lgt, perms, mvp, campos = _jax_scene()
    FLAGS = {'n_samples': N_SAMPLES, 'layers': 1, 'denoiser_demodulate': True}
    kw = dict(spp=1, num_layers=1, msaa=True, denoiser_sigma=2.0,
              shadow_scale=1.0, rnd_seed=SEED)
    white = np.ones((1, RES, RES, 3), np.float32)

    monkeypatch.setattr(j_envshade, 'env_shade', j_ps.env_shade_fused_jnp)
    jgeo = JDLMesh(m, FLAGS)
    jmesh, jbvh = jgeo.getMesh(jgeo.parameters(), m.material)
    want = j_render.render_mesh(FLAGS, jmesh, mvp, campos, lgt, (RES, RES),
                                jbvh, perms, jax.random.PRNGKey(0),
                                background=jnp.asarray(white), **kw)

    tmesh = convert.mesh(m, device='cpu')
    tgeo = TDLMesh(tmesh, FLAGS)
    tm, tbvh = tgeo.getMesh(tgeo.parameters(), tmesh.material)
    n2, P = N_SAMPLES * N_SAMPLES, RES * RES
    u8 = j_ps.make_uniforms(jax.random.PRNGKey(SEED), n2, P, N_SAMPLES, perms)
    gen = torch.Generator()
    gen.manual_seed(0)
    with torch.no_grad():
        got = t_render.render_mesh(
            FLAGS, tm, convert.tensor(mvp, device='cpu'),
            convert.tensor(campos, device='cpu'),
            convert.light(lgt, device='cpu'), (RES, RES), tbvh,
            convert.tensor(perms, device='cpu'), gen,
            background=torch.as_tensor(white),
            uniforms=[convert.tensor(u8, device='cpu')],
            **kw)

    assert set(got) == set(want)
    cover = float((np.asarray(want['shaded'])[..., 3] > 0).mean())
    assert cover > 0.2
    for k, share in (('kd', 0.999), ('ks', 0.999), ('normal', 0.999),
                     ('shaded', 0.995), ('diffuse_light', 0.995),
                     ('specular_light', 0.995)):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape == (1, RES, RES, 4)
        assert np.isfinite(g).all()
        err = np.abs(g - w).max(-1)
        assert (err <= 1e-4).mean() >= share, (k, (err > 1e-4).mean(),
                                               err.max())


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import nvdiffrecmc_tpu_torch as p\n"
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'nvdiffrecmc_tpu_torch.')]\n"
            "[importlib.import_module(m) for m in mods]\n"
            "assert len(mods) >= 25, mods\n"
            "bad = [m for m in sys.modules if m in ('jax', 'PIL', "
            "'imageio') or m.startswith(('jax.', 'nvdiffrecmc_tpu.', "
            "'PIL.', 'imageio.'))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    # chip_smoke.py imports inside its functions: read every import of it
    with open(os.path.join(REPO, 'chip_smoke.py')) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    bad = [m for m in names if m.split('.')[0] in (
        'jax', 'nvdiffrecmc_tpu', 'PIL', 'imageio')]
    assert not bad, bad


def test_dataset_mesh_renders_ground_truth():
    """DatasetMesh: seeded random cameras and a ground-truth render of the
    reference mesh through the port (plain versions on CPU), lit by the
    procedural probe when the configured one is absent."""
    from nvdiffrecmc_tpu_torch.dataset import DatasetMesh
    m, _, _, _, _ = _jax_scene()
    FLAGS = {'n_samples': 2, 'layers': 1, 'spp': 1, 'train_res': [24, 24],
             'cam_near_far': [0.1, 1000.0], 'iter': 2, 'batch': 1,
             'envlight': None}
    ds = DatasetMesh(convert.mesh(m, device='cpu'), 3.0, FLAGS, seed=4)
    assert tuple(ds.envlight.shape) == (256, 512, 3)
    a, b = ds[0], ds[1]
    assert len(ds) == 2
    assert a['img'].shape == (1, 24, 24, 4)
    assert bool(torch.isfinite(a['img']).all())
    assert float((a['img'][..., 3] > 0).float().mean()) > 0.2
    assert not np.allclose(a['mvp'], b['mvp'])
    # the same seed gives the same cameras
    again = DatasetMesh(convert.mesh(m, device='cpu'), 3.0, FLAGS, seed=4)
    np.testing.assert_array_equal(again._random_scene()[1], a['mvp'])
