"""Port parity, leaf math: vecmath, xfm, mesh_ops, normal and the envshade
helpers (Kensler permutation, permutation tables, lobe weights) of
nvdiffrecmc_tpu_torch against nvdiffrecmc_tpu on the same seeded numpy
inputs (CPU).  Tolerance atol 1e-5 (float32 rounding of
different but equivalent expression trees)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import envshade as j_envshade
from nvdiffrecmc_tpu.ops import mesh_ops as j_mesh_ops
from nvdiffrecmc_tpu.ops import normal as j_normal
from nvdiffrecmc_tpu.ops import vecmath as j_vecmath
from nvdiffrecmc_tpu.ops import xfm as j_xfm
from nvdiffrecmc_tpu_torch.ops import envshade as t_envshade
from nvdiffrecmc_tpu_torch.ops import mesh_ops as t_mesh_ops
from nvdiffrecmc_tpu_torch.ops import normal as t_normal
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vecmath
from nvdiffrecmc_tpu_torch.ops import xfm as t_xfm

ATOL = 1e-5


def _mesh(seed=0):
    """A small closed mesh (subdivided octahedron) with jittered vertices
    and planar UVs."""
    import __graft_entry__ as ge
    m, _, _, _, _ = ge._make_scene(res=16, n_samples=1, sub=2, light_res=8)
    rng = np.random.RandomState(seed)
    v = np.asarray(m.v_pos) * (1 + 0.1 * rng.rand(*m.v_pos.shape))
    return (v.astype(np.float32), np.array(m.t_pos_idx),
            np.array(m.v_tex))


def _case(name):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    if name == 'safe_normalize':
        return (j_vecmath.safe_normalize(jnp.asarray(x)),
                t_vecmath.safe_normalize(torch.as_tensor(x)))
    if name == 'pixel_grid':
        return (j_vecmath.pixel_grid(7, 5),
                t_vecmath.pixel_grid(7, 5, device='cpu'))
    if name == 'camera':
        rs = [np.random.RandomState(3), np.random.RandomState(3)]
        j = (j_vecmath.perspective(0.8, 1.3, 0.1, 100.0)
             @ j_vecmath.translate(0.1, -0.2, -3.0)
             @ j_vecmath.rotate_x(0.3) @ j_vecmath.rotate_y(-1.1)
             @ j_vecmath.random_rotation_translation(0.25, rs[0]))
        t = (t_vecmath.perspective(0.8, 1.3, 0.1, 100.0)
             @ t_vecmath.translate(0.1, -0.2, -3.0)
             @ t_vecmath.rotate_x(0.3) @ t_vecmath.rotate_y(-1.1)
             @ t_vecmath.random_rotation_translation(0.25, rs[1]))
        return j, t
    if name == 'srgb':
        y = np.abs(x[..., :3]) * 0.7
        y4 = np.concatenate([y, x[..., :1]], -1)
        return ([j_vecmath.srgb_to_rgb(jnp.asarray(y)),
                 j_vecmath.rgb_to_srgb(jnp.asarray(y4))],
                [t_vecmath.srgb_to_rgb(torch.as_tensor(y)),
                 t_vecmath.rgb_to_srgb(torch.as_tensor(y4))])
    if name == 'scale_img_nearest':
        img = rng.rand(1, 8, 6, 4).astype(np.float32)
        return ([j_vecmath.scale_img_nhwc(jnp.asarray(img), (16, 12), 'nearest',
                                          'nearest'),
                 j_vecmath.scale_img_nhwc(jnp.asarray(img), (4, 3), 'nearest',
                                          'nearest')],
                [t_vecmath.scale_img_nhwc(torch.as_tensor(img), (16, 12),
                                          'nearest', 'nearest'),
                 t_vecmath.scale_img_nhwc(torch.as_tensor(img), (4, 3),
                                          'nearest', 'nearest')])
    if name == 'avg_pool':
        img = rng.rand(2, 8, 6, 3).astype(np.float32)
        return (j_vecmath.avg_pool_nhwc(jnp.asarray(img), 2),
                t_vecmath.avg_pool_nhwc(torch.as_tensor(img), 2))
    if name == 'xfm':
        p = rng.randn(2, 9, 3).astype(np.float32)
        mtx = rng.randn(2, 4, 4).astype(np.float32)
        return ([j_xfm.xfm_points(jnp.asarray(p), jnp.asarray(mtx)),
                 j_xfm.xfm_vectors(jnp.asarray(p), jnp.asarray(mtx))],
                [t_xfm.xfm_points(torch.as_tensor(p), torch.as_tensor(mtx)),
                 t_xfm.xfm_vectors(torch.as_tensor(p), torch.as_tensor(mtx))])
    v, t, uv = _mesh()
    if name == 'face_normals':
        return (j_mesh_ops.face_normals(jnp.asarray(v), jnp.asarray(t)),
                t_mesh_ops.face_normals(torch.as_tensor(v), torch.as_tensor(t)))
    if name == 'auto_normals':
        mask = (np.arange(t.shape[0]) % 5 != 0).astype(np.float32)
        return ([j_mesh_ops.auto_normals(jnp.asarray(v), jnp.asarray(t)),
                 j_mesh_ops.auto_normals(jnp.asarray(v), jnp.asarray(t),
                                         jnp.asarray(mask))],
                [t_mesh_ops.auto_normals(torch.as_tensor(v),
                                         torch.as_tensor(t)),
                 t_mesh_ops.auto_normals(torch.as_tensor(v),
                                         torch.as_tensor(t),
                                         torch.as_tensor(mask))])
    if name == 'compute_tangents':
        jn = j_mesh_ops.auto_normals(jnp.asarray(v), jnp.asarray(t))
        tn = t_mesh_ops.auto_normals(torch.as_tensor(v), torch.as_tensor(t))
        return (j_mesh_ops.compute_tangents(
                    jnp.asarray(v), jn, jnp.asarray(uv), jnp.asarray(t),
                    jnp.asarray(t), jnp.asarray(t)),
                t_mesh_ops.compute_tangents(
                    torch.as_tensor(v), tn, torch.as_tensor(uv),
                    torch.as_tensor(t), torch.as_tensor(t),
                    torch.as_tensor(t)))
    if name == 'prepare_shading_normal':
        pos, view, pert, nrm, tng, geo = (rng.randn(1, 6, 6, 3).astype(
            np.float32) for _ in range(6))
        outs = []
        for mod, conv in ((j_normal, jnp.asarray), (t_normal, torch.as_tensor)):
            a = [conv(z) for z in (pos, view, pert, nrm, tng, geo)]
            outs.append([mod.prepare_shading_normal(a[0], a[1], None, a[3],
                                                    a[4], a[5]),
                         mod.prepare_shading_normal(*a, opengl=False)])
        return outs
    if name == 'kensler':
        i = np.arange(16, dtype=np.uint32)[:, None]
        p = rng.randint(0, 2 ** 31 - 1, (1, 64))
        return (j_envshade._kensler_permute_pow2(
                    jnp.asarray(i), 16, jnp.asarray(p)),
                t_envshade._kensler_permute_pow2(
                    torch.as_tensor(i.astype(np.int64)), 16,
                    torch.as_tensor(p)))
    if name == 'make_perms':
        return ([j_envshade.make_perms(3, n_tables=64)],
                [t_envshade.make_perms(3, n_tables=64, device='cpu')])
    if name == 'lobe_weights':
        col = np.abs(x[0]) * 0.5
        wo, nrm = x[1] + 0.1, x[0][::-1].copy()
        return ([j_envshade._luminance(jnp.asarray(col)),
                 j_envshade._spec_albedo(jnp.asarray(col), jnp.asarray(wo),
                                         jnp.asarray(nrm))],
                [t_envshade._luminance(torch.as_tensor(col)),
                 t_envshade._spec_albedo(torch.as_tensor(col),
                                         torch.as_tensor(wo),
                                         torch.as_tensor(nrm))])
    raise KeyError(name)


CASES = ['safe_normalize', 'pixel_grid', 'camera', 'srgb',
         'scale_img_nearest', 'avg_pool', 'xfm', 'face_normals',
         'auto_normals', 'compute_tangents', 'prepare_shading_normal',
         'kensler', 'make_perms', 'lobe_weights']


@pytest.mark.parametrize('name', CASES)
def test_leaf_math_matches_jax(name):
    want, got = _case(name)
    if not isinstance(want, list):
        want, got = [want], [got]
    for w, g in zip(want, got):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
