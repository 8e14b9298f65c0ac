"""Port parity, transparency: the render and the pass-2 step through 8
depth-peeled layers with a 4-channel kd (alpha in kd[..., 3]).
Validation, the bake's alpha and the program with transparency:
tests/test_torch_transparency_run.py.

The scene is three nested open boxes, so a ray through the centre crosses
six surfaces and the last two of the 8 layers are empty; its kd texture is
RGBA with alpha in [0.3, 0.9].  Both packages get the same numpy inputs;
per-layer uniforms (layer i: make_uniforms of PRNGKey(rnd_seed + i)) and
per-layer jitter offsets (layer i: the first of three keys split from
split(key, 8)[i]) are JAX's own, fed to the port.  The JAX side shades
with env_shade_fused_jnp and runs its costliest functions under jax.jit
(_jit_jax).

Where two triangles meet at neighbouring pixels at nearly equal depths,
the antialias blends toward the nearer, and the two packages' rast
depths, which agree to a few ulps, could order them the other way; the
scene keeps every such pair apart in depth, and the tests check that the
packages order them alike (_fg_flips).

Tolerances, as the one-layer tests state them: render buffers within 1e-4
on >= 99.9% of pixels for the G-buffer ones (kd, ks, normals and their
smoothness terms, z) and >= 99.5% for the Monte-Carlo ones
(tests/test_torch_slice.py; a grazing shadow ray may flip, and a pixel
blends eight layers); the step's losses within 1e-4 relative and every
gradient with cosine >= 0.999 and >= 99% of its entries within 1e-3 max|g|
(tests/test_torch_step.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import train as j_train
from nvdiffrecmc_tpu.config import apply_schedule_scaling
from nvdiffrecmc_tpu.geometry.dlmesh import DLMesh as JDLMesh
from nvdiffrecmc_tpu.ops import envshade as j_envshade
from nvdiffrecmc_tpu.ops import pallas_denoise as j_pd
from nvdiffrecmc_tpu.ops import pallas_shade as j_ps
from nvdiffrecmc_tpu.ops import rasterizer as j_ras
from nvdiffrecmc_tpu.ops import texture as j_tex_ops
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import mesh as j_mesh
from nvdiffrecmc_tpu.render import render as j_render
from nvdiffrecmc_tpu.render import texture as j_texture
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch import convert, train
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.render import light as t_light
from nvdiffrecmc_tpu_torch.render import render as t_render

LAYERS, N, SEED = 8, 2, 5
G_BUFFERS = ('kd', 'ks', 'normal', 'geometric_normal', 'z_grad', 'kd_grad',
             'ks_grad', 'normal_grad', 'perturbed_nrm', 'perturbed_nrm_grad')
MC_BUFFERS = ('shaded', 'diffuse_light', 'specular_light')


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _box():
    """A unit box (corners at +-1) open at +y, as 5 faces of 4 vertices
    each (each face's own UV square) and 10 triangles."""
    v, uv, f = [], [], []
    for axis in range(3):
        for side in (-1.0, 1.0) if axis != 1 else (-1.0,):
            u, w = [i for i in range(3) if i != axis]
            n = len(v)
            for a, b in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = [0.0, 0.0, 0.0]
                p[axis], p[u], p[w] = side, a, b
                v.append(p)
                uv.append(((a + 1) / 2, (b + 1) / 2))
            f += [[n, n + 1, n + 2], [n, n + 2, n + 3]]
    return np.array(v), np.array(uv), np.array(f)


def _nested(res, tex=16):
    """The JAX scene: three nested boxes (half sides 0.6, 0.36 and 0.18),
    each open on one side so that the light reaches the inner ones,
    turned by 0.9 rad about y, 0.6 about x and 0.3 about z, so that every
    face's depth changes along both screen axes (at 32x32 no two
    neighbouring pixels of two triangles lie within 1e-5 in depth: where
    they do, the antialias's choice of the nearer follows the packages'
    last ulps, see _fg_flips); an RGBA kd, ks and a normal map;
    ge._make_scene's light with bf16-exact tables (the JAX twin's gathers
    round them to bf16) and camera."""
    _, base, perms, mvp, campos = ge._make_scene(res=res, n_samples=N, sub=1)
    v, uv, f = _box()
    cx, sx, cy, sy, cz, sz = (f(a) for a in (0.6, 0.9, 0.3)
                              for f in (np.cos, np.sin))
    rot = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
           @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
           @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]))
    nv = v.shape[0]
    vv = np.concatenate([v @ rot.T * s for s in (0.6, 0.36, 0.18)])
    ff = np.concatenate([f + i * nv for i in range(3)]).astype(np.int32)
    uu = np.concatenate([uv] * 3).astype(np.float32)
    mesh = j_mesh.Mesh(v_pos=jnp.asarray(vv.astype(np.float32)),
                       t_pos_idx=jnp.asarray(ff), v_tex=jnp.asarray(uu),
                       t_tex_idx=jnp.asarray(ff))
    mesh = j_mesh.compute_tangents(j_mesh.auto_normals(mesh))
    rng = np.random.RandomState(0)
    kd = np.concatenate([rng.uniform(0.1, 0.9, (1, tex, tex, 3)),
                         rng.uniform(0.3, 0.9, (1, tex, tex, 1))], -1)
    ks = np.stack([np.zeros((tex, tex)), rng.uniform(0.4, 0.7, (tex, tex)),
                   rng.uniform(0.0, 1.0, (tex, tex))], -1)[None]
    nrm = np.concatenate([rng.uniform(-0.2, 0.2, (1, tex, tex, 2)),
                          np.ones((1, tex, tex, 1))], -1)
    mesh.material = {'bsdf': 'pbr'}
    for k, x in (('kd', kd), ('ks', ks), ('normal', nrm)):
        mesh.material[k] = j_texture.Texture2D(
            data=jnp.asarray(x.astype(np.float32)))
    tb = j_light.update_pdf(base)

    def rnd(x):
        return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    lgt = {'base': base, 'pdf': rnd(tb.pdf), 'rows': rnd(tb.rows),
           'cols': rnd(tb.cols)}
    return mesh, lgt, perms, mvp, campos


def _layer_offsets(key, shape, layers=LAYERS):
    """JAX render_gbuffer's jitter offsets of each layer, as tensors."""
    return [convert.tensor(jax.random.normal(
        jax.random.split(k, 3)[0], shape) * 0.005, device='cpu')
        for k in jax.random.split(key, layers)]


def _layer_uniforms(rnd_seed, P, perms, layers=LAYERS):
    """make_uniforms(PRNGKey(rnd_seed + i)) of each layer, as tensors."""
    return [convert.tensor(j_ps.make_uniforms(
        jax.random.PRNGKey(rnd_seed + i), N * N, P, N, perms), device='cpu')
        for i in range(layers)]


def _agree(got, want, keys, share, atol=1e-4):
    for k in keys:
        g, w = got[k].detach().numpy(), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert np.isfinite(g).all(), k
        err = np.abs(g - w).max(-1)
        assert (err <= atol).mean() >= share, (k, (err > atol).mean(),
                                               err.max())


def _port_mesh(m):
    tmesh = convert.mesh(m, device='cpu')
    geo = TDLMesh(tmesh, {})
    tm, bvh = geo.getMesh(geo.parameters(), tmesh.material)
    return tm, bvh


def _jit_jax(mp, fused=True):
    """The JAX reference's costliest functions under jax.jit: the same
    arithmetic, compiled once for the 8 layers' equal shapes instead of
    dispatched op by op (which takes minutes at 8 layers).  fused: shade
    with env_shade_fused_jnp (training; else JAX's env_shade, whose
    stratum loop validation takes)."""
    if fused:
        mp.setattr(j_envshade, 'env_shade', jax.jit(
            j_ps.env_shade_fused_jnp,
            static_argnames=('BSDF', 'n_samples_x', 'tmin', 'ray_chunk',
                             'k_pairs')))
    mp.setattr(j_render, 'antialias', jax.jit(j_render.antialias))
    mp.setattr(j_render, 'bilinear_sample', jax.jit(
        j_render.bilinear_sample, static_argnames=('boundary_mode',)))
    mp.setattr(j_pd, 'bilateral_denoiser_pair',
               jax.jit(j_pd.bilateral_denoiser_pair))
    mp.setattr(j_tex_ops, 'texture_sample_multi', jax.jit(
        j_tex_ops.texture_sample_multi,
        static_argnames=('filter_mode', 'boundary_mode')))
    mp.setattr(j_tex_ops, 'build_mip_chain',
               jax.jit(j_tex_ops.build_mip_chain))
    mp.setattr(j_ras, 'interpolate', jax.jit(j_ras.interpolate))
    gbuffer_layer = jax.jit(j_render.gbuffer_layer,
                            static_argnames=('resolution', 'spp', 'msaa'))
    mp.setattr(j_render, 'gbuffer_layer',    # it reads no material
               lambda v, r, rd, mesh, res, spp, msaa: gbuffer_layer(
                   v, r, rd, dataclasses.replace(mesh, material=None),
                   tuple(res), spp, msaa))
    mp.setattr(j_render, 'prepare_shading_normal', jax.jit(
        j_render.prepare_shading_normal,
        static_argnames=('two_sided_shading', 'opengl')))


def _fg_flips(port_rasts, jax_rasts):
    """The 4-neighbour pixel pairs of two triangles, over all layers, whose
    foreground (the nearer by rast z, which the antialias blends toward)
    the two packages choose differently.  The scene keeps such pairs apart
    in depth (_nested), so the count is 0; where two triangles met at
    depths within the packages' last ulps, the antialias would blend the
    pair opposite ways."""
    n = 0
    for tr, jr in zip(port_rasts, jax_rasts):
        jr = torch.as_tensor(np.array(jr))
        tid, tz, jz = tr[..., 3], tr[..., 2], jr[..., 2]
        for sa, sb in ((np.s_[:, :, :-1], np.s_[:, :, 1:]),
                       (np.s_[:, :-1], np.s_[:, 1:])):
            n += int(((tid[sa] != tid[sb]) & (tid[sa] > 0) & (tid[sb] > 0)
                      & ((tz[sa] < tz[sb]) != (jz[sa] < jz[sb]))).sum())
    return n


RES, IT, KEY = 32, 3, 11


@pytest.fixture(scope='module')
def step():
    """One pass-2 step at 8 layers in both packages on _nested(RES) over a
    seeded target: JAX's losses, gradients and the render buffers of its
    tick (jax.value_and_grad, the buffers as aux), and the port's
    (compute_grads, the buffers from the same render_mesh call), both fed
    JAX's per-layer uniforms and jitter offsets and the bf16-exact light
    tables."""
    m, lgt, perms, mvp, campos = _nested(RES)
    settings = dict(train_res=[RES, RES], n_samples=N, texture_res=[16, 16],
                    iter=100, layers=LAYERS, spp=1, batch=1,
                    denoiser='bilateral')
    rng = np.random.RandomState(8)
    target = {'img': np.concatenate(
        [rng.uniform(0.0, 1.0, (1, RES, RES, 3)),
         (rng.rand(1, RES, RES, 1) < 0.6)], -1).astype(np.float32),
        'background': rng.rand(1, RES, RES, 3).astype(np.float32),
        'mvp': np.asarray(mvp), 'campos': np.asarray(campos)}
    mat = {k: np.array(m.material[k].data) for k in ('kd', 'ks', 'normal')}

    jflags = j_train.parse_flags([])
    jflags.update(settings)
    apply_schedule_scaling(jflags)
    jgeo = JDLMesh(m, jflags)
    _, jstatic = j_train.initial_guess_material(jgeo, False, jflags)
    jparams = {'geo': jgeo.parameters(),
               'mat': {k: jnp.asarray(v) for k, v in mat.items()},
               'light': lgt['base']}
    tgt = {k: jnp.asarray(v) for k, v in target.items()}
    tgt.update(resolution=(RES, RES), spp=1)
    captured = []
    with pytest.MonkeyPatch.context() as mp:
        _jit_jax(mp)
        render_mesh = j_render.render_mesh

        def capture(*a, **k):
            captured.append(render_mesh(*a, **k))
            return captured[-1]
        mp.setattr(j_render, 'render_mesh', capture)
        gbuffer = j_render.render_gbuffer

        def rasts(*a, **k):
            out = gbuffer(*a, **k)
            captured.append([rast for _, rast in out[1]])
            return out
        mp.setattr(j_render, 'render_gbuffer', rasts)

        def loss(p):
            captured.clear()
            il, rl = jgeo.tick(
                p['geo'], j_train.make_material(p['mat'], jstatic),
                dict(lgt, base=p['light']), tgt, j_train.createLoss(jflags),
                jnp.float32(IT), jflags, jnp.float32(2.0), perms,
                jax.random.PRNGKey(KEY), rnd_seed=jnp.int32(IT))
            return il + rl, (il, rl, captured[1], captured[0])
        (_, (jil, jrl, jbuf, jrasts)), jgrads = jax.value_and_grad(
            loss, has_aux=True)(jparams)

    FLAGS = t_config.make_flags(**settings)
    geo = TDLMesh(convert.mesh(m, device='cpu'), FLAGS)
    _, static = train.initial_guess_material(geo, False, FLAGS, device='cpu')
    params = train.make_params(
        geo, {k: torch.as_tensor(v) for k, v in mat.items()},
        convert.tensor(lgt['base'], device='cpu'))
    tables = t_light.LightTables(*(convert.tensor(lgt[k], device='cpu')
                                   for k in ('pdf', 'rows', 'cols')))
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train.light_mod, 'update_pdf', lambda base: tables)
        finish = t_render.render_finish

        def keep(*a, **k):
            got.update(layers=a[3], buffers=finish(*a, **k))
            return got['buffers']
        mp.setattr(t_render, 'render_finish', keep)
        il, rl = train.compute_grads(
            geo, params, static, {k: torch.as_tensor(v)
                                  for k, v in target.items()},
            IT, FLAGS, train.createLoss(FLAGS),
            convert.tensor(perms, device='cpu'), None,
            uniforms=_layer_uniforms(IT, RES * RES, perms),
            offsets=_layer_offsets(jax.random.PRNGKey(KEY),
                                   (1, RES, RES, 2)))
    return dict(jax=(float(jil), float(jrl), jgrads, jbuf),
                port=(float(il), float(rl), params, got['buffers']),
                layers=got['layers'], jax_rasts=jrasts)


def test_render_mesh_8_layers_matches_jax(step):
    """render_mesh at 8 layers, 32x32, MSAA, denoiser sigma 2.0, over the
    target's background, as the step renders it: every buffer as JAX's;
    both packages pick the same foreground at every triangle edge of every
    layer (_fg_flips); the peel covers six layers at the centre and none
    past them; a pixel's alpha stays below 1."""
    want, got = step['jax'][3], step['port'][3]
    assert set(got) == set(want) >= set(G_BUFFERS + MC_BUFFERS)
    assert _fg_flips([r for _, r in step['layers']], step['jax_rasts']) == 0
    _agree(got, want, G_BUFFERS, 0.999)
    _agree(got, want, MC_BUFFERS, 0.995)
    alpha = got['shaded'][..., 3]
    assert 0.2 < float((alpha > 0).float().mean())
    assert float(alpha.max()) < 1.0
    covered = [int((rast[..., 3] > 0).sum()) for _, rast in step['layers']]
    assert covered[5] > 0 and covered[6] == covered[7] == 0, covered
    assert all(covered[i] >= covered[i + 1] for i in range(5)), covered


def test_empty_peel_layers_add_nothing():
    """The same render at 8 layers and at the six the mesh covers, from the
    same per-layer uniforms and offsets, equal bit for bit: an empty layer
    adds exactly nothing to any buffer."""
    res = 16
    m, lgt, perms, mvp, campos = _nested(res)
    tm, bvh = _port_mesh(m)
    args = (convert.tensor(mvp, device='cpu'),
            convert.tensor(campos, device='cpu'),
            convert.light(lgt, device='cpu'), (res, res), bvh,
            convert.tensor(perms, device='cpu'), None)
    offsets = _layer_offsets(jax.random.PRNGKey(3), (1, res, res, 2))
    uniforms = _layer_uniforms(SEED, res * res, perms)
    bg = torch.as_tensor(np.random.RandomState(2).rand(1, res, res, 3)
                         .astype(np.float32))
    out = []
    for n in (LAYERS, 6):
        with torch.no_grad():
            out.append(t_render.render_mesh(
                {'n_samples': N, 'layers': n}, tm, *args, spp=1,
                num_layers=n, msaa=True, background=bg, denoiser_sigma=2.0,
                rnd_seed=SEED, uniforms=uniforms[:n], offsets=offsets[:n]))
    assert float((out[0]['shaded'][..., 3] > 0).float().mean()) > 0.2
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_step_8_layers_matches_jax(step):
    """The pass-2 step at 8 layers: losses within 1e-4 relative; the
    gradients of v_pos, kd (all four channels), ks, normal and the light
    with cosine >= 0.999 and >= 99% of their entries within 1e-3 max|g|;
    kd's alpha channel alone with cosine >= 0.999."""
    jil, jrl, jgrads, _ = step['jax']
    il, rl, params, _ = step['port']
    np.testing.assert_allclose(il, jil, rtol=1e-4)
    np.testing.assert_allclose(rl, jrl, rtol=1e-4)
    pairs = {'v_pos': (params['geo']['v_pos'].grad, jgrads['geo']['v_pos']),
             'light': (params['light'].grad, jgrads['light'])}
    for k in ('kd', 'ks', 'normal'):
        pairs[k] = (params['mat'][k].grad, jgrads['mat'][k])
    pairs['kd alpha'] = (pairs['kd'][0][..., 3], pairs['kd'][1][..., 3])
    for k, (g, w) in pairs.items():
        g, w = g.numpy().ravel(), np.asarray(w).ravel()
        assert np.isfinite(g).all() and np.abs(g).max() > 0.0, k
        cos = np.dot(g, w) / (np.linalg.norm(g) * np.linalg.norm(w))
        close = (np.abs(g - w) <= 1e-3 * np.abs(w).max()).mean()
        assert cos >= 0.999 and (close >= 0.99 or k == 'kd alpha'), \
            (k, cos, close)
