"""Port parity, the pass boundary (train.py:287-407 and the helpers it
calls): connected components and their pruning, extract_static_mesh,
the port's build of the chart-grown unwrapper against the JAX package's
native one, render_uv, vecmath.dilate and the whole bake_textures, on a
DMTet mesh of a random SDF at grid 10 and a small hash grid (6 levels,
2^14 rows).  JAX's DMTetGeometry is built in a temporary directory (it
writes data/tets/ there).

Tolerances: faces, texture indices and UV charts equal (the same integer
work; the unwrapper is the same C++ source built by the same compiler);
vertices within 1e-6; dilate within 1e-6 (a 7x7 sum in another order);
render_uv and the baked textures: coverage equal on >= 99.9% of texels
and kd, ks within 1e-5 on texels covered in both (the two packages'
rasterizers may split a texel centre on a shared UV edge differently).

Two departures, decided in the port: where every component is smaller
than min_frac of the faces, the JAX package drops them all (an empty
mesh, on which the bake fails), the port keeps the largest; and where
training's fixed triangle slots truncate the surface, the JAX package
bakes the truncated buffers (mostly zero-area faces on a few vertices),
the port extracts the whole surface, as JAX does from slots that hold
it (held here against JAX's extract from such slots, and through main()
on an overflowed two-pass run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as j_train
from nvdiffrecmc_tpu.geometry import dmtet as j_dmtet
from nvdiffrecmc_tpu.ops import hashgrid as j_hash
from nvdiffrecmc_tpu.ops import vecmath as j_vecmath
from nvdiffrecmc_tpu.render import render as j_render
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch import convert, train
from nvdiffrecmc_tpu_torch import uv_unwrap as t_unwrap
from nvdiffrecmc_tpu_torch.geometry import dmtet as t_dmtet
from nvdiffrecmc_tpu_torch.ops import hashgrid as t_hash
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vecmath
from nvdiffrecmc_tpu_torch.render import render as t_render

CFG = dict(n_levels=6, n_features_per_level=2, log2_hashmap_size=14,
           base_resolution=4, desired_resolution=4096)
TEX = [64, 64]


def _components(sizes, seed):
    """Faces of disjoint triangle fans of the given face counts, their
    vertex ids and face order shuffled; ft = f + 1000."""
    rng = np.random.RandomState(seed)
    faces, base = [], 0
    for n in sizes:
        faces += [[base, base + i + 1, base + i + 2] for i in range(n)]
        base += n + 2
    f = np.asarray(faces, np.int64)
    perm = rng.permutation(base)
    f = perm[f][rng.permutation(len(f))]
    return f, f + 1000


@pytest.mark.parametrize('sizes,min_frac', [
    ([120, 40, 9, 3, 1], 0.05), ([50, 50, 2], 0.01), ([7], 0.5),
    ([30, 2, 2], 0.0)])
def test_prune_small_components_matches_jax(sizes, min_frac):
    f, ft = _components(sizes, len(sizes))
    want = j_train.prune_small_components(f, ft, min_frac)
    got = train.prune_small_components(f, ft, min_frac)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    # the same partition of the faces as JAX's union-find
    lj = j_train._component_labels(f, int(f.max()) + 1)
    lt = train._component_labels(f, int(f.max()) + 1)
    pairs = set(zip(lj.tolist(), lt.tolist()))
    assert len(pairs) == len(set(lj.tolist())) == len(set(lt.tolist()))


def test_prune_keeps_the_largest_when_all_are_small():
    """Every component below min_frac: JAX's prune leaves no face; the
    port keeps the largest component (the first of equal ones)."""
    f, ft = _components([5, 8, 3, 8, 1], 7)
    want_f, _, n = j_train.prune_small_components(f, ft, 0.5)
    assert len(want_f) == 0 and n == len(f)
    got_f, got_ft, dropped = train.prune_small_components(f, ft, 0.5)
    assert len(got_f) == 8 and dropped == len(f) - 8
    labels = train._component_labels(f, int(f.max()) + 1)
    kept = labels[np.isin(f[:, 0], got_f[:, 0])]
    assert len(set(kept.tolist())) == 1
    np.testing.assert_array_equal(got_ft, got_f + 1000)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    """Both packages' DMTet geometry at grid 10 (random SDF, a seeded
    deformation) and one neural material (JAX's init with a seeded table),
    with their flags."""
    import os
    cwd = os.getcwd()
    os.chdir(str(tmp_path_factory.mktemp('tets')))
    try:
        from nvdiffrecmc_tpu.config import DEFAULTS
        jflags = dict(DEFAULTS, data_root='.', texture_res=TEX,
                      prune_components=0.01)
        jg = j_dmtet.DMTetGeometry(10, 2.1, jflags, max_tris=4800)
    finally:
        os.chdir(cwd)
    tflags = t_config.make_flags(texture_res=TEX)
    tg = t_dmtet.DMTetGeometry(10, 2.1, tflags, max_tris=4800, device='cpu')
    deform = np.random.RandomState(6).randn(*tg.verts.shape).astype(
        np.float32) * 0.5
    jparams = {'sdf': jg.parameters()['sdf'], 'deform': jnp.asarray(deform.T)}
    tparams = {'sdf': tg.parameters()['sdf'],
               'deform': torch.as_tensor(deform)}
    jcfg = j_hash.HashEncodingConfig(**CFG)
    jmlp = j_hash.init_mlp_texture(jax.random.PRNGKey(2), jcfg, channels=6)
    jmlp = jmlp._replace(table=jnp.asarray(np.random.RandomState(8).uniform(
        -1, 1, jmlp.table.shape).astype(np.float32)))
    lo, hi = (np.array([0.0, 0.08, 0.0, 0.0, 0.1, 0.0], np.float32),
              np.array([1.0, 1.0, 1.0, 0.0, 1.0, 1.0], np.float32))
    jstatic = {'kind': 'mlp', 'cfg': jcfg, 'aabb': jg.getAABB(),
               'min_max': (jnp.asarray(lo), jnp.asarray(hi)), 'bsdf': 'pbr',
               'no_perturbed_nrm': True}
    tstatic = {'kind': 'mlp', 'cfg': t_hash.HashEncodingConfig(**CFG),
               'aabb': tg.getAABB(),
               'min_max': (torch.as_tensor(lo), torch.as_tensor(hi)),
               'bsdf': 'pbr', 'no_perturbed_nrm': True}
    return dict(jg=jg, tg=tg, jparams=jparams, tparams=tparams,
                jflags=jflags, tflags=tflags,
                jmat={'kd_ks': jmlp}, tmat=convert.mlp_texture(jmlp, 'cpu'),
                jstatic=jstatic, tstatic=tstatic)


def test_extract_static_mesh_matches_jax(scene):
    jm = j_train.extract_static_mesh(scene['jg'], scene['jparams'],
                                     scene['jflags'])
    tm = train.extract_static_mesh(scene['tg'], scene['tparams'],
                                   scene['tflags'])
    for k in ('t_pos_idx', 'v_tex', 't_tex_idx'):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    np.testing.assert_allclose(tm.v_pos.numpy(), np.asarray(jm.v_pos),
                               rtol=0, atol=1e-6)
    assert tm.t_pos_idx.shape[0] > 100


def test_extract_static_mesh_of_an_overflowed_buffer_matches_jax(scene):
    """Training's buffers at 1,000 slots truncate the grid-10 surface
    (2,422 triangles); the boundary extracts it whole, in buffers sized to
    the count: faces and texture indices equal to JAX's extract from 4,800
    slots, which hold the surface, vertices within 1e-6."""
    tg = t_dmtet.DMTetGeometry(10, 2.1, scene['tflags'], max_tris=1000,
                               device='cpu')
    n_tris, cap = tg.tri_count(scene['tparams'])
    occ = scene['tparams']['sdf'] > 0
    n_edges = int((occ[tg.edge_uniq[:, 0]] != occ[tg.edge_uniq[:, 1]]).sum())
    assert cap == 1000 and 1000 < n_tris <= 4800 and n_edges <= 4800
    assert scene['jg'].tri_count(scene['jparams']) == (n_tris, 4800)
    m, _ = tg.getMesh(scene['tparams'], None, build_bvh=False)
    assert int(m.tri_mask.sum()) == 1000
    whole, _ = tg.getMesh(scene['tparams'], None, build_bvh=False,
                          whole=True)
    assert int(whole.tri_mask.sum()) == whole.t_pos_idx.shape[0] == n_tris
    assert whole.v_pos.shape[0] == n_edges
    jm = j_train.extract_static_mesh(scene['jg'], scene['jparams'],
                                     scene['jflags'])
    tm = train.extract_static_mesh(tg, scene['tparams'], scene['tflags'])
    for k in ('t_pos_idx', 'v_tex', 't_tex_idx'):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    np.testing.assert_allclose(tm.v_pos.numpy(), np.asarray(jm.v_pos),
                               rtol=0, atol=1e-6)
    assert tm.t_pos_idx.shape[0] > 1000


def _face_areas(v, f):
    v = np.asarray(v, np.float64)
    f = np.asarray(f, np.int64)
    return np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]],
                                   v[f[:, 2]] - v[f[:, 0]]), axis=1)


def test_main_bakes_the_whole_surface_of_an_overflowed_pass1(
        tmp_path, monkeypatch, capsys):
    """Both passes of the synthetic NeRF folder (grid 8, a sphere init of
    1,344 triangles) with 400 triangle slots, so pass 1 trains and ends
    truncated: the boundary bakes every surface triangle pass 1 ends with
    (less the prune's drops), no face of zero area, covered kd and ks
    texels, and pass 2's losses are finite."""
    import json
    import re
    from test_torch_datasets import nerf_argv
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.render import mesh as t_mesh
    argv = nerf_argv(str(tmp_path))
    with open(argv[1]) as f:
        cfg = json.load(f)
    cfg['max_tris'] = 400
    with open(argv[1], 'w') as f:
        json.dump(cfg, f)
    losses = []
    step = train.train_step

    def record(geometry, *args, **kw):
        il, rl = step(geometry, *args, **kw)
        if isinstance(geometry, DLMesh):
            losses.append((float(il), float(rl)))
        return il, rl
    monkeypatch.setattr(train, 'train_step', record)
    train.main(argv, device='cpu')
    out = capsys.readouterr().out
    n1 = int(re.search(r'dmtet_pass1: (\d+) surface triangles of 400 slots, '
                       r'OVERFLOW', out).group(1))
    assert n1 > 400
    m = re.search(r'dropped (\d+) floater', out)
    dropped = int(m.group(1)) if m else 0
    b = re.search(r'pass boundary: (\d+) triangles, (\d+) vertices;.* '
                  r'(\d+) of (\d+) texels covered; pass 2 BVH leaf size '
                  r'(\d+)', out)
    assert b is not None, out
    T, covered, texels = int(b.group(1)), int(b.group(3)), int(b.group(4))
    assert T == n1 - dropped
    assert 0 < covered <= texels == 32 * 32
    assert int(b.group(5)) == 128
    base = t_mesh.load_mesh(str(tmp_path / 'run' / 'dmtet_mesh' /
                                'mesh.obj'), device='cpu')
    assert base.t_pos_idx.shape[0] == T
    assert _face_areas(base.v_pos.numpy(), base.t_pos_idx.numpy()).min() > 0
    assert len(losses) == cfg['iter']
    assert np.isfinite(losses).all()


def test_uv_unwrap_build_matches_jax_native(scene):
    """The port's g++ build of its copy of uv_unwrap.cpp against the JAX
    package's native build, on the extracted mesh."""
    from nvdiffrecmc_tpu import native
    tm = train.extract_static_mesh(scene['tg'], scene['tparams'],
                                   scene['tflags'])
    v, f = tm.v_pos.numpy(), tm.t_pos_idx.numpy()
    want = native.uv_unwrap(v, f)
    assert want is not None
    got = t_unwrap.uv_unwrap(v, f)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    uv, idx = train.uv_unwrap(tm.v_pos, tm.t_pos_idx)
    np.testing.assert_array_equal(uv.numpy(), want[0])
    assert uv.min() >= 0.0 and uv.max() <= 1.0


def _close_on_common(tm, ts, jm, js):
    """Coverage equal on >= 99.9% of texels; values within 1e-5 on texels
    covered in both."""
    tmask, jmask = tm.numpy()[..., 0] > 0, np.asarray(jm)[..., 0] > 0
    assert (tmask == jmask).mean() >= 0.999
    both = tmask & jmask
    assert both.mean() > 0.1
    for t, j in zip(ts, js):
        np.testing.assert_allclose(t.detach().numpy()[both],
                                   np.asarray(j)[both], rtol=0, atol=1e-5)


def test_render_uv_matches_jax(scene):
    jm = j_train.extract_static_mesh(scene['jg'], scene['jparams'],
                                     scene['jflags'])
    from nvdiffrecmc_tpu import native
    uvs, tidx = native.uv_unwrap(np.asarray(jm.v_pos),
                                 np.asarray(jm.t_pos_idx))
    import dataclasses
    jm = dataclasses.replace(jm, v_tex=jnp.asarray(uvs),
                             t_tex_idx=jnp.asarray(tidx))
    tm = convert.mesh(jm, device='cpu')
    jmat = j_train.make_material(scene['jmat'], scene['jstatic'])
    tmat = train.make_material(scene['tmat'], scene['tstatic'])
    jmask, jkd, jks = j_render.render_uv(jm, TEX, jmat['kd_ks'])
    with torch.no_grad():
        tmask, tkd, tks = t_render.render_uv(tm, TEX, tmat['kd_ks'])
    _close_on_common(tmask, (tkd, tks), jmask, (jkd, jks))


def test_dilate_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.rand(1, 40, 48, 3).astype(np.float32)
    mask = (rng.rand(1, 40, 48, 1) < 0.3).astype(np.float32)
    mask[:, 10:25, 10:30] = 0.0                     # a hole past the window
    avg = np.array([0.2, 0.5, 0.7], np.float32)[None, None, None]
    want = j_vecmath.dilate(jnp.asarray(x), jnp.asarray(avg),
                            jnp.asarray(mask), 7)
    got = t_vecmath.dilate(torch.as_tensor(x), torch.as_tensor(avg),
                           torch.as_tensor(mask), 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_bake_textures_matches_jax(scene, monkeypatch):
    """The whole boundary on JAX's extracted mesh (the port's extract is
    held above; its vertices differ from JAX's in the last ulps of tanh,
    which the lively test table's finest level, at 4096 cells, turns into
    1e-3 in kd): the unwrapped charts equal, kd and ks within 1e-5 on >=
    99.9% of the texels (seams dilated), the normal map flat."""
    jbase, jtex = j_train.bake_textures(scene['jg'], scene['jparams'],
                                        scene['jmat'], scene['jstatic'],
                                        scene['jflags'])
    jm = j_train.extract_static_mesh(scene['jg'], scene['jparams'],
                                     scene['jflags'])
    def extract(geometry, params, FLAGS, times):
        times['prune'] = 0.0
        return convert.mesh(jm, device='cpu')
    monkeypatch.setattr(train, 'extract_static_mesh', extract)
    times = {}
    tbase, ttex = train.bake_textures(scene['tg'], scene['tparams'],
                                      scene['tmat'], scene['tstatic'],
                                      scene['tflags'], times)
    assert set(times) == {'extract', 'prune', 'unwrap', 'bake', 'covered'}
    assert 0 < times['covered'] <= TEX[0] * TEX[1]
    for k in ('t_pos_idx', 'v_tex', 't_tex_idx'):
        np.testing.assert_array_equal(getattr(tbase, k).numpy(),
                                      np.asarray(getattr(jbase, k)),
                                      err_msg=k)
    for k in ('kd', 'ks'):
        d = np.abs(ttex[k].numpy() - np.asarray(jtex[k])).max(-1)
        assert (d <= 1e-5).mean() >= 0.999, k
    np.testing.assert_array_equal(ttex['normal'].numpy(),
                                  np.asarray(jtex['normal']))
