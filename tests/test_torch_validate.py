"""Port parity, the validation render at the reference protocol and the
validation entry points (nvdiffrecmc_tpu_torch.train.render_eval, validate_itr,
validate; DatasetMesh's orbit; save_image; mse_to_psnr).

- render_eval (n_samples 32, 1,024 strata in one call, no denoiser)
  against JAX render_mesh with FLAGS['n_samples'] 32 and
  denoiser_sigma=None, whose env_shade takes the stratum loop on the CPU,
  on the textured octasphere of __graft_entry__._make_scene at 16x16, fed
  JAX's own draws.  Shares of pixels within 1e-4 as
  tests/test_torch_slice.py: kd, ks, normal >= 99.9% (triangle ids), the
  Monte-Carlo buffers >= 99.5% (a grazing shadow ray may flip, and the
  port samples with the polynomial atan2/acos of the fused pipeline where
  the JAX loop calls exact ones, so a sample may land one texel over).
  The probe varies slowly between texels, so such a sample moves little.
- DatasetMesh._rotate_scene equal to JAX's within 1e-6.
- mse_to_psnr and the metrics.txt lines in JAX's formats.
- save_image round-trips through the port's PNG decoder byte for byte.
(validate itself: tests/test_torch_validate_run.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from nvdiffrecmc_tpu.dataset.dataset_mesh import DatasetMesh as JDatasetMesh
from nvdiffrecmc_tpu.geometry.dlmesh import DLMesh as JDLMesh
from nvdiffrecmc_tpu.ops import envshade as j_es
from nvdiffrecmc_tpu.ops import vecmath as j_vecmath
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import render as j_render
from nvdiffrecmc_tpu.render import texture as j_texture
from nvdiffrecmc_tpu_torch import convert, train
from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import DatasetMesh
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.ops import pallas_shade as t_ps
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vecmath
from nvdiffrecmc_tpu_torch.render import texture as t_texture

RES, N_SAMPLES = 16, 32


@pytest.fixture(autouse=True)
def _one_thread():
    """The stratum loop runs a few hundred small PyTorch ops per stratum;
    with one intra-op thread they do not oversubscribe the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smooth_probe(H=32, W=64):
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    lobe = np.exp(-((y - 0.3 * H) ** 2 + (x - 0.6 * W) ** 2) / (0.05 * H * W))
    base = (0.6 + 0.3 * np.sin(2 * np.pi * x / W)[..., None]
            * np.array([1.0, 0.8, 0.6]) + 3.0 * lobe[..., None])
    return jnp.asarray(base.astype(np.float32))


def _scene(sub=3):
    m, _, _, mvp, campos = ge._make_scene(res=RES, n_samples=2, sub=sub)
    rng = np.random.RandomState(0)
    kd = rng.uniform(0.1, 0.9, (1, 32, 32, 3)).astype(np.float32)
    ks = np.stack([np.zeros((32, 32)), rng.uniform(0.4, 0.7, (32, 32)),
                   rng.uniform(0.0, 1.0, (32, 32))], -1)[None]
    m.material = {'bsdf': 'pbr',
                  'kd': j_texture.Texture2D(data=jnp.asarray(kd)),
                  'ks': j_texture.Texture2D(
                      data=jnp.asarray(ks.astype(np.float32)))}
    base = _smooth_probe()
    tb = j_light.update_pdf(base)
    lgt = {'base': base, 'pdf': tb.pdf, 'rows': tb.rows, 'cols': tb.cols}
    return m, lgt, mvp, campos


def jax_loop_uniforms(rnd_seed, n_samples_x, P, perms):
    """The JAX loop's random draws (envshade.py:459-490: per-pixel light and
    BSDF permutation seeds, 5 uniforms per pixel per stratum) in the port's
    [n2, 8, P] layout."""
    n2 = n_samples_x * n_samples_x
    key = jax.random.PRNGKey(rnd_seed)
    kperm, kloop = jax.random.split(key)
    hi = 2 ** 31 - 1 if n2 & (n2 - 1) == 0 else perms.shape[0]
    lp = jax.random.randint(jax.random.fold_in(kperm, 0), (P,), 0, hi)
    bp = jax.random.randint(jax.random.fold_in(kperm, 1), (P,), 0, hi)
    u = jax.vmap(lambda i: jax.random.uniform(
        jax.random.fold_in(kloop, i), (P, 5)))(jnp.arange(n2))
    cells = t_ps.stratum_cells(torch.arange(n2)[:, None], n_samples_x,
                               torch.as_tensor(np.array(lp)).long(),
                               torch.as_tensor(np.array(bp)).long(),
                               torch.as_tensor(np.asarray(perms)).long())
    return torch.cat([torch.as_tensor(np.asarray(u)).transpose(1, 2),
                      cells.transpose(0, 1), torch.zeros((n2, 1, P))], 1)


def test_render_eval_matches_jax_render_mesh():
    m, lgt, mvp, campos = _scene()
    FLAGS = {'n_samples': N_SAMPLES, 'layers': 1, 'spp': 1,
             'denoiser_demodulate': True, 'train_res': [RES, RES]}
    checker = t_vecmath.checkerboard((RES, RES), 8)[None]
    perms = j_es.make_perms(N_SAMPLES, n_tables=4)
    jgeo = JDLMesh(m, FLAGS)
    jmesh, jbvh = jgeo.getMesh(jgeo.parameters(), m.material)
    want = j_render.render_mesh(
        FLAGS, jmesh, mvp, campos, lgt, (RES, RES), jbvh, perms,
        jax.random.PRNGKey(0), spp=1, num_layers=1, msaa=False,
        background=jnp.asarray(checker), denoiser_sigma=None,
        shadow_scale=1.0, rnd_seed=1000)

    tmesh = convert.mesh(m, device='cpu')
    tgeo = TDLMesh(tmesh, FLAGS)
    mat = tmesh.material
    mat_params = {'kd': mat['kd'].data, 'ks': mat['ks'].data}
    mat_static = {'kind': 'tex', 'bsdf': 'pbr', 'no_perturbed_nrm': False,
                  'min_max': {'kd': None, 'ks': None}}
    target = {'mvp': convert.tensor(mvp, device='cpu'),
              'campos': convert.tensor(campos, device='cpu'),
              'background': torch.as_tensor(checker),
              'resolution': (RES, RES)}
    u8 = jax_loop_uniforms(1000, N_SAMPLES, RES * RES, perms)
    got = train.render_eval(tgeo, tgeo.parameters(), mat_params, mat_static,
                            convert.tensor(lgt['base'], device='cpu'),
                            target, FLAGS,
                            uniforms=[u8])
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


def _orbit_flags():
    return {'n_samples': 2, 'layers': 1, 'spp': 1, 'train_res': [24, 24],
            'display_res': [20, 28], 'cam_near_far': [0.1, 1000.0],
            'iter': 2, 'batch': 1, 'envlight': None}


def test_rotate_scene_matches_jax():
    m, _, _, _ = _scene()
    FLAGS = _orbit_flags()
    jds = JDatasetMesh(m, 3.0, FLAGS, validate=True, num_validation_frames=9)
    tds = DatasetMesh(convert.mesh(m, device='cpu'), 3.0, FLAGS, validate=True,
                      num_validation_frames=9)
    assert len(tds) == len(jds) == 9
    for itr in (0, 4, 8):
        for g, w in zip(tds._rotate_scene(itr), jds._rotate_scene(itr)):
            if isinstance(w, tuple):
                assert g == w == (20, 28)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_mse_to_psnr_matches_jax():
    mse = np.array([1e-6, 3.7e-3, 0.25, 1.0])
    np.testing.assert_allclose(t_vecmath.mse_to_psnr(mse),
                               j_vecmath.mse_to_psnr(mse), rtol=1e-12)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_save_image_round_trips(tmp_path, channels):
    rng = np.random.RandomState(channels)
    x = rng.uniform(-0.2, 1.2, (7, 13, channels)).astype(np.float32)
    fn = str(tmp_path / 'x.png')
    t_texture.save_image(fn, torch.as_tensor(x))
    with open(fn, 'rb') as f:
        got = t_texture.decode_png(f.read())
    want = np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(OSError):
        t_texture.save_image(str(tmp_path / 'missing' / 'x.png'), x)
