"""Port parity, DMTet (nvdiffrecmc_tpu/geometry/dmtet.py): the Kuhn tet
grid and the unique-edge table, marching tets on a sphere SDF and on
random SDFs at grids 8-12 (one with buffers too small, so both packages
truncate), sdf_reg_loss, face_uvs, and DMTetGeometry's init and getMesh.
Every JAX DMTetGeometry is built in a temporary directory: it writes its
tet grid and edge table under data/tets/ there.

Tolerances: integer outputs (grids, edge tables, faces, face_gidx,
tri_mask, the overflow flag) equal; vertices within 1e-6 (the same
interpolation, whose one division rounds alike); the gradients of the
vertices with respect to sdf and deform (jax.vjp against backward) within
1e-5 of their largest entry; sdf_reg_loss within 1e-6 relative and its
gradient within 1e-6 of its largest entry; normals and tangents of
getMesh within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.geometry import dmtet as J
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch.geometry import dmtet as T


def _grid(r, scale=2.1):
    verts, idx = J.kuhn_tet_grid(r)
    return verts * np.float32(scale), idx


def _sdfs(verts, kind, seed=0):
    if kind == 'sphere':
        return (0.45 * 2.1 - np.linalg.norm(verts, axis=1)).astype(np.float32)
    return (np.random.RandomState(seed).rand(verts.shape[0]).astype(
        np.float32) - 0.1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize('r', [8, 12])
def test_kuhn_grid_and_edge_tables_match_jax(r):
    verts, idx = J.kuhn_tet_grid(r)
    tv, ti = T.kuhn_tet_grid(r)
    np.testing.assert_array_equal(tv, verts)
    np.testing.assert_array_equal(ti, idx)
    uniq, emap = J._precompute_edge_tables(idx)
    tu, tm = T.edge_tables(torch.as_tensor(ti), verts.shape[0])
    np.testing.assert_array_equal(tu.numpy(), uniq)
    np.testing.assert_array_equal(tm.numpy(), emap)
    uvs, N = J.map_uv_tables(idx.shape[0])
    tuvs, tN = T.map_uv_tables(idx.shape[0])
    assert tN == N
    np.testing.assert_array_equal(tuvs, uvs)


# the reference's random init crosses the surface in ~27 r^2 triangles at
# these grids, past the 24 r^2 slots of DMTetGeometry: 48 r^2 holds them
CASES = [(8, 'sphere', None), (10, 'random', 4800), (12, 'random', 6912),
         (12, 'random', 300)]


@pytest.mark.parametrize('r,kind,max_tris', CASES,
                         ids=['sphere8', 'random10', 'random12',
                              'overflow12'])
def test_marching_tets_matches_jax(r, kind, max_tris):
    """Faces, face_gidx, tri_mask and the overflow flag equal; vertices
    within 1e-6; the gradients of a seeded cotangent on the vertices with
    respect to sdf and the deformed grid within 1e-5."""
    verts, idx = _grid(r)
    rng = np.random.RandomState(r)
    verts = verts + rng.uniform(-0.01, 0.01, verts.shape).astype(np.float32)
    sdf = _sdfs(verts, kind, seed=r)
    uniq, emap = J._precompute_edge_tables(idx)
    max_tris = max_tris or 24 * r * r

    def jfn(v, s):
        return J.marching_tets(v.T, s, jnp.asarray(idx.T),
                               jnp.asarray(uniq.T), jnp.asarray(emap.T),
                               max_tris)
    jv, jf, jg, jm, jo = jfn(jnp.asarray(verts), jnp.asarray(sdf))
    g = rng.randn(max_tris, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda v, s: jfn(v, s)[0], jnp.asarray(verts),
                     jnp.asarray(sdf))
    dv, ds = vjp(jnp.asarray(g))

    vt = torch.tensor(verts, requires_grad=True)
    st = torch.tensor(sdf, requires_grad=True)
    tu, tm = T.edge_tables(torch.as_tensor(idx), verts.shape[0])
    v, f, fg, m, o = T.marching_tets(vt, st, torch.as_tensor(idx), tu, tm,
                                     max_tris)
    (v * torch.as_tensor(g)).sum().backward()
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert bool(o) == bool(jo) == (max_tris == 300)
    assert 0 < int(m.sum()) <= max_tris
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=0,
                               atol=1e-6)
    assert _rel(vt.grad.numpy(), dv) <= 1e-5
    assert _rel(st.grad.numpy(), ds) <= 1e-5


def test_sdf_reg_loss_and_face_uvs_match_jax():
    verts, idx = _grid(10)
    sdf = _sdfs(verts, 'random', seed=3)
    sdf[:50] = 0.0                          # sign 0 on some vertices
    uniq, _ = J._precompute_edge_tables(idx)
    want, d_want = jax.value_and_grad(
        lambda s: J.sdf_reg_loss(s, jnp.asarray(uniq.T)))(jnp.asarray(sdf))
    st = torch.tensor(sdf, requires_grad=True)
    got = T.sdf_reg_loss(st, torch.as_tensor(uniq).long())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert _rel(st.grad.numpy(), d_want) <= 1e-6

    gidx = np.random.RandomState(4).randint(0, 2 * idx.shape[0], 500)
    gidx[:3] = 0
    N = int(np.ceil(np.sqrt((idx.shape[0] * 2 + 1) // 2)))
    jv, jt = J.face_uvs(jnp.asarray(gidx, jnp.int32), idx.shape[0], N)
    tv, tt = T.face_uvs(torch.as_tensor(gidx, dtype=torch.int32),
                        idx.shape[0], N)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _flags(**kw):
    from nvdiffrecmc_tpu.config import DEFAULTS
    F = dict(DEFAULTS, data_root='.', iter=100, shadow_ramp_iters=35.0)
    F.update(kw)
    return F


@pytest.mark.parametrize('sdf_init', ['random', 'sphere'])
def test_dmtet_geometry_init_matches_jax(tmp_path, monkeypatch, sdf_init):
    """The Kuhn grid scaled by mesh_scale, its edge tables, the chart grid,
    the slot count and the initial SDF (numpy's RandomState(0) - 0.1, or
    the sphere of radius 0.45 scale) and deformation; then both read the
    tet grid JAX wrote to data/tets/ (tets_path)."""
    monkeypatch.chdir(tmp_path)
    FLAGS = _flags(sdf_init=sdf_init)
    jg = J.DMTetGeometry(8, 2.1, FLAGS)
    tg = T.DMTetGeometry(8, 2.1, t_config.make_flags(sdf_init=sdf_init),
                         device='cpu')
    np.testing.assert_array_equal(tg.verts.numpy(), np.asarray(jg.verts).T)
    np.testing.assert_array_equal(tg.indices.numpy(),
                                  np.asarray(jg.indices).T)
    np.testing.assert_array_equal(tg.edge_uniq.numpy(),
                                  np.asarray(jg.edge_uniq).T)
    np.testing.assert_array_equal(tg.edge_map.numpy(),
                                  np.asarray(jg.edge_map).T)
    assert (tg.uv_N, tg.max_tris, tg.num_tets) == (jg.uv_N, jg.max_tris,
                                                    jg.num_tets)
    jp, tp = jg.parameters(), tg.parameters()
    np.testing.assert_array_equal(tp['sdf'].numpy(), np.asarray(jp['sdf']))
    np.testing.assert_array_equal(tp['deform'].numpy(),
                                  np.asarray(jp['deform']).T)
    for a, b in zip(tg.getAABB(), jg.getAABB()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tg.tri_count(tp) == jg.tri_count(jp)
    # a grid from disk: the file JAX cached
    path = str(tmp_path / 'data' / 'tets' / '8_tets.npz')
    tg2 = T.DMTetGeometry(8, 2.1, t_config.make_flags(), tets_path=path,
                          max_tris=77, device='cpu')
    np.testing.assert_array_equal(tg2.indices.numpy(),
                                  np.asarray(jg.indices).T)
    assert tg2.max_tris == 77


def test_dmtet_get_mesh_matches_jax(tmp_path, monkeypatch):
    """getMesh on a random SDF and a seeded deformation at grid 10: every
    Mesh field with its padding slots (vertices, faces, texture
    coordinates, tri_mask, normals, tangents) against the JAX package's,
    and the BVH over the live triangles only."""
    monkeypatch.chdir(tmp_path)
    jg = J.DMTetGeometry(10, 2.1, _flags(), max_tris=4800)
    tg = T.DMTetGeometry(10, 2.1, t_config.make_flags(), max_tris=4800,
                         device='cpu')
    deform = np.random.RandomState(6).randn(*tg.verts.shape).astype(
        np.float32) * 0.5
    jm, _ = jg.getMesh({'sdf': jg.parameters()['sdf'],
                        'deform': jnp.asarray(deform.T)}, None,
                       build_bvh=False)
    tm, bvh = tg.getMesh({'sdf': tg.parameters()['sdf'],
                          'deform': torch.as_tensor(deform)}, None)
    for k in ('t_pos_idx', 't_tex_idx', 'tri_mask'):
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    for k, tol in (('v_pos', 1e-6), ('v_tex', 0.0), ('v_nrm', 1e-5),
                   ('v_tng', 1e-5)):
        np.testing.assert_allclose(getattr(tm, k).numpy(),
                                   np.asarray(getattr(jm, k)), rtol=0,
                                   atol=tol, err_msg=k)
    live = int(tm.tri_mask.sum())
    assert 0 < live < tm.tri_mask.shape[0]
    assert int((bvh.tri.abs().sum(1) > 0).sum()) == live
