"""Port parity, the standalone tracer and the visit mask
(nvdiffrecmc_tpu_torch.ops.pallas_tracer, the counterparts of Pallas
kernels _trace_kernel and _mask_kernel).

- any_hit_pallas (plain version on the CPU) against JAX any_hit_pallas in
  interpret mode and against the brute-force Möller-Trumbore twin, on
  random triangle soups as tests/test_tracer.py builds them: >= 99.9% of
  the results equal (a grazing ray may flip between the JAX matmul test,
  the port's elementwise Plücker sums and Möller-Trumbore).
- visit_masks (plain) against JAX visit_masks in interpret mode and
  against visit_masks_od: equal on every entry, on boxes that include an
  empty leaf (an inverted box) and rays with zero direction components or
  an origin at BIG; both follow the JAX arithmetic (1/d where |d| > 1e-12,
  else 2e12, and tmax).
- ray_features equal to JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import bvh as j_bvh
from nvdiffrecmc_tpu.ops import pallas_tracer as j_pt
from nvdiffrecmc_tpu.ops import tracer as j_tracer
from nvdiffrecmc_tpu_torch.ops import bvh as t_bvh
from nvdiffrecmc_tpu_torch.ops import pallas_tracer as t_pt
from nvdiffrecmc_tpu_torch.ops import tracer as t_tracer

BIG = 3e37


def t(x):
    return torch.as_tensor(np.array(x))


def icosphere_like(n_tri=400, seed=0):
    """Random triangle soup on a unit sphere surface (small tangent tris),
    as tests/test_tracer.py."""
    rng = np.random.RandomState(seed)
    c = rng.randn(n_tri, 3)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    a = np.cross(c, [0, 0, 1.0])
    a /= np.linalg.norm(a, axis=-1, keepdims=True) + 1e-9
    b = np.cross(c, a)
    s = 0.15
    vs = [c + s * (rng.randn(n_tri, 1) * a + rng.randn(n_tri, 1) * b)
          for _ in range(3)]
    verts = np.concatenate(vs, 0).astype(np.float32)
    tris = np.arange(3 * n_tri, dtype=np.int32).reshape(3, n_tri).T
    return verts, np.ascontiguousarray(tris)


def _rays(R, seed):
    rng = np.random.RandomState(seed)
    ro = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd[:8, 1:] = 0.0                       # axis-aligned rays
    rd[:8, 0] = 1.0
    rd[8:12] = 0.0                         # disabled rays
    ro[8:12] = BIG
    return ro, rd


@pytest.mark.parametrize('n_tri,seed', [(96, 7), (400, 0)])
def test_any_hit_pallas_matches_jax(n_tri, seed):
    v, tri = icosphere_like(n_tri, seed)
    ro, rd = _rays(512, seed + 1)
    jb = j_bvh.build(jnp.asarray(v), jnp.asarray(tri), leaf_size=16)
    want = np.asarray(j_pt.any_hit_pallas(jnp.asarray(ro), jnp.asarray(rd),
                                          jb, ray_block=128, interpret=True))
    brute = np.asarray(j_tracer.any_hit_bruteforce(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(v[tri[:, 0]]),
        jnp.asarray(v[tri[:, 1]]), jnp.asarray(v[tri[:, 2]]), tmin=0.0))
    tb = t_bvh.build(t(v), t(tri), leaf_size=16)
    got = t_pt.any_hit_pallas(t(ro), t(rd), tb).numpy()
    assert got.dtype == np.bool_ and got.shape == (512,)
    assert (got == want).mean() >= 0.999, (got != want).sum()
    assert (got == brute).mean() >= 0.999, (got != brute).sum()
    assert not got[8:12].any()
    assert 0.04 < brute.mean() < 0.96
    # the same kernel on ray features
    rayf = t_bvh.ray_features(t(ro), t(rd))
    assert torch.equal(t_pt.trace_rayf(rayf, tb), torch.as_tensor(got))


def test_ray_features_match_jax():
    ro, rd = _rays(300, 3)
    want = np.asarray(j_bvh.ray_features(jnp.asarray(ro), jnp.asarray(rd)))
    got = t_bvh.ray_features(t(ro), t(rd)).numpy()
    assert got.shape == want.shape == (300, 16)
    np.testing.assert_array_equal(got, want)


def _mask_inputs(seed):
    """JAX LeafBVH boxes of a soup whose triangle count leaves the last
    leaf partly padded, with one leaf masked out (its box is inverted),
    and 64 blocks of 16 rays: random rays, zero direction components, and
    8 blocks of disabled rays at BIG."""
    v, tri = icosphere_like(150, seed)
    mask = np.ones(150, bool)
    mask[:16] = False
    jb = j_bvh.build(jnp.asarray(v), jnp.asarray(tri),
                     tri_mask=jnp.asarray(mask), leaf_size=16)
    lo, hi = np.asarray(jb.aabb_lo), np.asarray(jb.aabb_hi)
    assert (lo[:, 0] > hi[:, 0]).any()                 # an empty leaf
    ro, rd = _rays(1024, seed + 5)
    ro = ro * 0.6
    rd[100:200, 2] = 0.0                                # zero components
    rd[300:340, 0:2] = 1e-13
    ro[896:] = BIG
    rd[896:] = 0.0
    return ro, rd, lo, hi


@pytest.mark.parametrize('seed,tmax', [(0, 1e16), (1, 1.5)])
def test_visit_masks_match_jax(seed, tmax):
    ro, rd, lo, hi = _mask_inputs(seed)
    j = jnp.asarray
    rayf = j_bvh.ray_features(j(ro), j(rd))
    want = np.asarray(j_pt.visit_masks(rayf, j(lo), j(hi), 16, 0.0, tmax,
                                       interpret=True))
    want_od = np.asarray(j_pt.visit_masks_od(j(ro), j(rd), j(lo), j(hi), 16,
                                             0.0, tmax))
    got = t_pt.visit_masks(t(rayf), t(lo), t(hi), 16, 0.0, tmax).numpy()
    assert got.dtype == np.int32 and got.shape == (64, lo.shape[0])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_od)
    # the blocks of disabled rays enter no real box; in both packages they
    # do 'enter' the empty leaf's inverted box, (BIG - BIG) * 2e12 = 0 on
    # every axis (harmless: an empty leaf has no triangles)
    real = lo[:, 0] <= hi[:, 0]
    assert not got[56:][:, real].any() and got[56:][:, ~real].all()
    assert 0.1 < got[:56, real].mean() < 0.99


def test_occlusion_fn_detaches_and_rejects_finite_tmax():
    v, tri = icosphere_like(96, 7)
    ro, rd = _rays(256, 2)
    tb = t_bvh.build(t(v), t(tri), leaf_size=16)
    o = t(ro).requires_grad_()
    occ = t_tracer.make_occlusion_fn()(o, t(rd), tb)
    assert occ.dtype == torch.bool and not occ.requires_grad
    assert torch.equal(occ, t_tracer.any_hit(t(ro), t(rd), tb))
    with pytest.raises(ValueError):
        t_pt.any_hit_pallas(t(ro), t(rd), tb, tmax=10.0)
    with pytest.raises(ValueError):
        t_pt.visit_masks(t_bvh.ray_features(t(ro), t(rd))[:200], tb.aabb_lo,
                         tb.aabb_hi, 128, 0.0, 1e16)
