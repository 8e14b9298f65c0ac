"""Port parity, meshes whose faces use several materials: load_obj's
uber-material merge (material.merge_materials) against the JAX package's
load_obj, on OBJs written to a temporary folder: the octasphere of
__graft_entry__._make_scene cut into face groups, a first group before
any usemtl (material 0's), then two or three materials named in usemtl
lines (one named twice, so their order is that of first use), kd maps of
different resolutions, ks as a map or a constant, and normal maps on all
of them or on none.  The merged kd, ks and normal atlases within 4e-6
(every entry lies in [-1, 1]; the two packages' bilinear upscale,
scale_img_nhwc, blends in another order at positions an ulp apart, which
moves an upscaled texel by up to 2.2e-6), the texcoords and t_tex_idx
equal; then a 32x32 render of the merged
mesh (n_samples 2, one layer, white background, denoiser sigma 2.0)
against JAX's, fed the same uniforms, with the tolerances of
tests/test_torch_slice.py (kd, ks atol 1e-4 on >= 99.9% of pixels; the
Monte-Carlo buffers on >= 99.5%)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from nvdiffrecmc_tpu.geometry.dlmesh import DLMesh as JDLMesh
from nvdiffrecmc_tpu.ops import pallas_shade as j_ps
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import obj as j_obj
from nvdiffrecmc_tpu.render import render as j_render
from nvdiffrecmc_tpu_torch import convert
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.render import obj as t_obj
from nvdiffrecmc_tpu_torch.render import render as t_render
from nvdiffrecmc_tpu_torch.render import texture as t_texture
from test_torch_transparency import _jit_jax
from test_torch_transparency import _one_thread  # noqa: F401  (autouse)

RES, N_SAMPLES, SEED = 32, 2, 5


def _png(path, rng, res, channels):
    img = rng.randint(0, 256, (res, res, channels)).astype(np.uint8)
    with open(path, 'wb') as f:
        f.write(t_texture.encode_png(img))


def write_scene(folder, n_mat, normal_maps, seed=0):
    """mesh.obj and mesh.mtl in folder: n_mat materials m0, m1, ... with
    kd maps of 16, 8 and 32 texels a side; ks a map for m0 and a constant
    for the others; bump maps with normal_maps.  Faces: a group with no
    usemtl, then m1, m0, m2 (n_mat 3), m1 again."""
    rng = np.random.RandomState(seed)
    m = ge._make_scene(res=RES, n_samples=N_SAMPLES)[0]
    v, f = np.asarray(m.v_pos), np.asarray(m.t_pos_idx)
    uv = np.asarray(m.v_tex)
    with open(os.path.join(folder, 'mesh.mtl'), 'w') as out:
        for i in range(n_mat):
            out.write('newmtl m%d\nbsdf pbr\nmap_Kd kd%d.png\n' % (i, i))
            _png(os.path.join(folder, 'kd%d.png' % i), rng, (16, 8, 32)[i],
                 3)
            if i == 0:
                out.write('map_Ks ks0.png\n')
                _png(os.path.join(folder, 'ks0.png'), rng, 16, 3)
            else:
                out.write('Ks 0 %.2f %.2f\n' % (0.3 + 0.2 * i, 0.1 * i))
            if normal_maps:
                out.write('bump n%d.png\n' % i)
                _png(os.path.join(folder, 'n%d.png' % i), rng, 16, 3)
    order = [None, 'm1', 'm0'] + (['m2'] if n_mat == 3 else []) + ['m1']
    groups = np.array_split(np.arange(len(f)), len(order))
    with open(os.path.join(folder, 'mesh.obj'), 'w') as out:
        out.write('mtllib mesh.mtl\n')
        for p in v:
            out.write('v %.7f %.7f %.7f\n' % tuple(p))
        for t in uv:
            out.write('vt %.7f %.7f\n' % (t[0], 1.0 - t[1]))
        for name, faces in zip(order, groups):
            if name is not None:
                out.write('usemtl %s\n' % name)
            for tri in f[faces] + 1:
                out.write('f %d/%d %d/%d %d/%d\n'
                          % (tri[0], tri[0], tri[1], tri[1], tri[2], tri[2]))
    return os.path.join(folder, 'mesh.obj')


@pytest.mark.parametrize('n_mat, normal_maps', [(2, False), (3, True)])
def test_merge_matches_jax(tmp_path, n_mat, normal_maps):
    fn = write_scene(str(tmp_path), n_mat, normal_maps)
    want = j_obj.load_obj(fn)
    got = t_obj.load_obj(fn, device='cpu')
    assert got.material['name'] == 'uber_material'
    keys = ('kd', 'ks', 'normal') if normal_maps else ('kd', 'ks')
    assert ('normal' in got.material) == normal_maps
    side = max((16, 8, 32)[:n_mat])
    for k in keys:
        w = np.asarray(want.material[k].data)
        g = got.material[k].data.numpy()
        assert g.shape == w.shape == (1, side * n_mat, side, 3), k
        np.testing.assert_allclose(g, w, rtol=0, atol=4e-6, err_msg=k)
    for k in ('v_tex', 't_tex_idx', 'v_pos', 't_pos_idx'):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    # every face of a group reads its material's band of the atlas
    v = got.v_tex[got.t_tex_idx.long()][..., 1]
    assert float(v.min()) >= 0.0 and float(v.max()) <= 1.0


def test_merged_render_matches_jax(tmp_path, monkeypatch):
    fn = write_scene(str(tmp_path), 3, True)
    m = j_obj.load_obj(fn)
    base = j_light.create_trainable_env_rnd(16, 0.0, 0.5)
    tb = j_light.update_pdf(base)

    def rnd(x):      # bf16-exact tables: the JAX twin's gathers round to bf16
        return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    lgt = {'base': base, 'pdf': rnd(tb.pdf), 'rows': rnd(tb.rows),
           'cols': rnd(tb.cols)}
    _, _, perms, mvp, campos = ge._make_scene(res=RES, n_samples=N_SAMPLES)
    FLAGS = {'n_samples': N_SAMPLES, 'layers': 1, 'denoiser_demodulate': True}
    kw = dict(spp=1, num_layers=1, msaa=False, denoiser_sigma=2.0,
              shadow_scale=1.0, rnd_seed=SEED)
    white = np.ones((1, RES, RES, 3), np.float32)

    _jit_jax(monkeypatch)
    jgeo = JDLMesh(m, FLAGS)
    jmesh, jbvh = jgeo.getMesh(jgeo.parameters(), m.material)
    want = j_render.render_mesh(FLAGS, jmesh, mvp, campos, lgt, (RES, RES),
                                jbvh, perms, jax.random.PRNGKey(0),
                                background=jnp.asarray(white), **kw)

    tmesh = t_obj.load_obj(fn, device='cpu')
    tgeo = TDLMesh(tmesh, FLAGS)
    tm, tbvh = tgeo.getMesh(tgeo.parameters(), tmesh.material)
    u8 = j_ps.make_uniforms(jax.random.PRNGKey(SEED), N_SAMPLES ** 2,
                            RES * RES, N_SAMPLES, perms)
    gen = torch.Generator()
    gen.manual_seed(0)
    with torch.no_grad():
        got = t_render.render_mesh(
            FLAGS, tm, convert.tensor(mvp, device='cpu'),
            convert.tensor(campos, device='cpu'),
            convert.light(lgt, device='cpu'), (RES, RES), tbvh,
            convert.tensor(perms, device='cpu'), gen,
            background=torch.as_tensor(white),
            uniforms=[convert.tensor(u8, device='cpu')], **kw)
    cover = float((np.asarray(want['shaded'])[..., 3] > 0).mean())
    assert cover > 0.2
    for k, share in (('kd', 0.999), ('ks', 0.999), ('shaded', 0.995),
                     ('diffuse_light', 0.995), ('specular_light', 0.995)):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert np.isfinite(g).all()
        err = np.abs(g - w).max(-1)
        assert (err <= 1e-4).mean() >= share, (k, (err > 1e-4).mean(),
                                               err.max())
