"""Port parity, rasterizer and antialias gradients on the
__graft_entry__._make_scene octasphere at 64x64, with the JAX package's
triangle ids fed to both sides so that only the differentiable part is
compared: the barycentric recompute (d v_clip), interpolate with
derivatives (d attr, d rast), interpolate_face and antialias (d color,
d v_clip).  Tolerance rtol 1e-4 plus atol 1e-5 max|g| (per-vertex sums
over hundreds of pixels, added in another order).  Also: the G-buffer's
depth planes carry no gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as ge
from nvdiffrecmc_tpu.ops import antialias as j_aa
from nvdiffrecmc_tpu.ops import rasterizer as j_ras
from nvdiffrecmc_tpu.ops import xfm as j_xfm
from nvdiffrecmc_tpu_torch import convert
from nvdiffrecmc_tpu_torch.ops import antialias as t_aa
from nvdiffrecmc_tpu_torch.ops import rasterizer as t_ras
from nvdiffrecmc_tpu_torch.ops import xfm as t_xfm
from nvdiffrecmc_tpu_torch.render import render as t_render

RES = 64


def _scene():
    m, _, _, mvp, _ = ge._make_scene(res=RES, n_samples=1, sub=3)
    rot = np.asarray(mvp) @ np.array(
        [[1, 0, 0, 0], [0, 0.8, -0.6, 0], [0, 0.6, 0.8, 0], [0, 0, 0, 1]],
        np.float32)
    v_clip = np.array(j_xfm.xfm_points(m.v_pos, jnp.asarray(rot)))
    tri = np.array(m.t_pos_idx)
    rast, _ = j_ras.rasterize(jnp.asarray(v_clip), jnp.asarray(tri),
                              (RES, RES))
    tid = np.array(rast[..., 3]).astype(np.int32)
    return m, rot, v_clip, tri, tid


def _close(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


def test_recompute_bary_grad_matches_jax():
    _, _, v_clip, tri, tid = _scene()
    rng = np.random.RandomState(0)
    g1 = rng.randn(1, RES, RES, 4).astype(np.float32)
    g2 = rng.randn(1, RES, RES, 4).astype(np.float32)

    def jfn(v):
        r, db = j_ras._recompute_bary(v, jnp.asarray(tri), jnp.asarray(tid),
                                      RES, RES)
        return jnp.sum(r[..., 0:3] * g1[..., 0:3]) + jnp.sum(db * g2)
    want = jax.grad(jfn)(jnp.asarray(v_clip))
    v = torch.as_tensor(v_clip).requires_grad_()
    r, db = t_ras._recompute_bary(v, torch.as_tensor(tri),
                                  torch.as_tensor(tid), RES, RES)
    ((r[..., 0:3] * torch.as_tensor(g1[..., 0:3])).sum()
     + (db * torch.as_tensor(g2)).sum()).backward()
    _close(v.grad.numpy(), want)


def test_interpolate_grads_match_jax():
    m, _, v_clip, tri, tid = _scene()
    rast, db = j_ras._recompute_bary(jnp.asarray(v_clip), jnp.asarray(tri),
                                     jnp.asarray(tid), RES, RES)
    rast, db = np.array(rast), np.array(db)
    attr = np.concatenate([np.array(m.v_pos), np.array(m.v_tex)], -1)
    fattr = np.random.RandomState(1).randn(tri.shape[0], 3).astype(
        np.float32)
    rng = np.random.RandomState(2)
    g_out = rng.randn(1, RES, RES, 5).astype(np.float32)
    g_da = rng.randn(1, RES, RES, 10).astype(np.float32)
    g_f = rng.randn(1, RES, RES, 3).astype(np.float32)

    def jfn(a, fa, r, d):
        out, da = j_ras.interpolate(a, r, jnp.asarray(tri), rast_db=d)
        fo = j_ras.interpolate_face(fa, r)
        return jnp.sum(out * g_out) + jnp.sum(da * g_da) + jnp.sum(fo * g_f)
    want = jax.grad(jfn, argnums=(0, 1, 2, 3))(
        jnp.asarray(attr), jnp.asarray(fattr), jnp.asarray(rast),
        jnp.asarray(db))
    leaves = [torch.as_tensor(x).requires_grad_()
              for x in (attr, fattr, rast, db)]
    a, fa, r, d = leaves
    out, da = t_ras.interpolate(a, r, torch.as_tensor(tri), rast_db=d)
    fo = t_ras.interpolate_face(fa, r)
    ((out * torch.as_tensor(g_out)).sum() + (da * torch.as_tensor(g_da)).sum()
     + (fo * torch.as_tensor(g_f)).sum()).backward()
    for t, w in zip(leaves, want):
        _close(t.grad.numpy(), w)


def test_antialias_grads_match_jax():
    _, _, v_clip, tri, tid = _scene()
    rast, _ = j_ras._recompute_bary(jnp.asarray(v_clip), jnp.asarray(tri),
                                    jnp.asarray(tid), RES, RES)
    rast = np.array(rast)
    rng = np.random.RandomState(3)
    color = rng.rand(1, RES, RES, 4).astype(np.float32)
    g = rng.randn(1, RES, RES, 4).astype(np.float32)

    def jfn(c, v):
        return jnp.sum(j_aa.antialias(c, jnp.asarray(rast), v,
                                      jnp.asarray(tri)) * g)
    want = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(color),
                                         jnp.asarray(v_clip))
    c, v = (torch.as_tensor(x).requires_grad_() for x in (color, v_clip))
    (t_aa.antialias(c, torch.as_tensor(rast), v, torch.as_tensor(tri))
     * torch.as_tensor(g)).sum().backward()
    _close(c.grad.numpy(), want[0])
    _close(v.grad.numpy(), want[1])


def test_gbuffer_depth_has_no_gradient():
    m, rot, _, _, _ = _scene()
    mesh = convert.mesh(m, device='cpu')
    mesh.v_pos = mesh.v_pos.clone().requires_grad_()
    v_clip = t_xfm.xfm_points(mesh.v_pos, torch.as_tensor(rot))
    rast, db = t_ras.rasterize(v_clip, mesh.t_pos_idx, (RES, RES))
    out = t_render.gbuffer_layer(v_clip, rast, db, mesh, (RES, RES), 1,
                                 False)
    gb_depth, gb_pos = out[1], out[2]
    assert bool((gb_depth[..., 0] > 0).any())
    assert not gb_depth.requires_grad
    assert gb_pos.requires_grad
