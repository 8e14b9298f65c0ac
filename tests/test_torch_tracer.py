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
  Also on coherent rays (each block a narrow cone from one point, so most
  leaves stay unset for the whole block) at ray_block 16, 1,000 and 4,096
  (the CUDA kernel stages 512 rays a tile; 1,000 is no multiple of it).
- any_hit (plain) against JAX any_hit_pallas in interpret mode on rays
  aimed at points of a closed icosphere: inside its triangles (every ray
  hits, in both, and every result is equal), on its edges and at its
  vertices, where the ray's edge terms are ~0 and rounding decides it: the
  two packages sum those terms in different orders, so there they agree
  on >= 94% of the rays (measured: 95.7% at the vertices, 97.0% on the
  edges).
- visit_first_hits against the per-ray slab hits, and the mask's bound
  reading every ray of a block that leaves a leaf unentered, else its
  rays up to the last of its leaves' first entering rays.
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


def _coherent_rays(n_blocks, ray_block, seed):
    """Per block, rays from one point on the soup's sphere in a narrow
    cone pointing out of it: a block enters the few leaves around its
    point only."""
    rng = np.random.RandomState(seed)
    c = rng.randn(n_blocks, 3)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    ro = np.repeat(c, ray_block, 0) + rng.randn(
        n_blocks * ray_block, 3) * 0.01
    rd = np.repeat(c, ray_block, 0) + rng.randn(n_blocks * ray_block,
                                                3) * 0.08
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.mark.parametrize('ray_block', [16, 1000, 4096])
def test_visit_masks_coherent_rays_match_jax(ray_block):
    v, tri = icosphere_like(400, 3)
    jb = j_bvh.build(jnp.asarray(v), jnp.asarray(tri), leaf_size=16)
    lo, hi = np.asarray(jb.aabb_lo), np.asarray(jb.aabb_hi)
    n_blocks = max(2, 4096 // ray_block)
    ro, rd = _coherent_rays(n_blocks, ray_block, ray_block)
    rayf = j_bvh.ray_features(jnp.asarray(ro), jnp.asarray(rd))
    want = np.asarray(j_pt.visit_masks(rayf, jnp.asarray(lo),
                                       jnp.asarray(hi), ray_block, 0.0,
                                       1e16, interpret=True))
    got = t_pt.visit_masks(t(rayf), t(lo), t(hi), ray_block, 0.0,
                           1e16).numpy()
    assert got.shape == (n_blocks, lo.shape[0])
    np.testing.assert_array_equal(got, want)
    # every block leaves most leaves unset and enters at least one
    assert (got.mean(1) < 0.5).all() and (got.sum(1) > 0).all()


def icosphere(n_sub):
    """A closed unit icosphere: the icosahedron with each triangle split
    in four n_sub times."""
    g = (1 + 5 ** 0.5) / 2
    v = [(-1, g, 0), (1, g, 0), (-1, -g, 0), (1, -g, 0), (0, -1, g),
         (0, 1, g), (0, -1, -g), (0, 1, -g), (g, 0, -1), (g, 0, 1),
         (-g, 0, -1), (-g, 0, 1)]
    v = [np.array(x, float) / np.linalg.norm(x) for x in v]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5),
         (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(n_sub):
        mid = {}

        def m(a, b):
            k = (min(a, b), max(a, b))
            if k not in mid:
                x = v[a] + v[b]
                v.append(x / np.linalg.norm(x))
                mid[k] = len(v) - 1
            return mid[k]
        f = [t for a, b, c in f for t in (
            (a, m(a, b), m(c, a)), (b, m(b, c), m(a, b)),
            (c, m(c, a), m(b, c)), (m(a, b), m(b, c), m(c, a)))]
    return np.array(v, np.float32), np.array(f, np.int32)


@pytest.mark.parametrize('aim', ['interior', 'edges', 'vertices'])
def test_any_hit_aimed_rays_match_jax(aim):
    v, f = icosphere(2)
    tv = v[f]
    if aim == 'interior':
        p = np.concatenate([np.einsum('tvc,v->tc', tv, np.float32(w))
                            for w in ((0.2, 0.3, 0.5), (0.6, 0.3, 0.1))])
    elif aim == 'edges':
        p = np.concatenate([tv[:, i] + np.float32(s) * (tv[:, j] - tv[:, i])
                            for i, j in ((0, 1), (1, 2), (2, 0))
                            for s in (0.5, 0.25)])
    else:
        p = np.concatenate([tv[:, 0], tv[:, 1], tv[:, 2]])
    p = p.astype(np.float32)
    rng = np.random.RandomState(0)
    ro = (p + rng.randn(*p.shape) * 0.5).astype(np.float32)
    rd = (p - ro).astype(np.float32)
    jb = j_bvh.build(jnp.asarray(v), jnp.asarray(f), leaf_size=16)
    want = np.asarray(j_pt.any_hit_pallas(jnp.asarray(ro), jnp.asarray(rd),
                                          jb, ray_block=128, interpret=True))
    tb = t_bvh.build(t(v), t(f), leaf_size=16)
    got = t_tracer.any_hit(t(ro), t(rd), tb, tmin=0.0).numpy()
    if aim == 'interior':
        assert got.all() and want.all()
    else:
        assert (got == want).mean() >= 0.94, (got != want).sum()
        assert got.mean() > 0.9 and want.mean() > 0.9


@pytest.mark.parametrize('ray_block', [16, 100])
def test_visit_first_hits_and_mask_bound(ray_block):
    from nvdiffrecmc_tpu_torch import checks
    """Four blocks of random rays, then four of disabled ones (origin at
    BIG, zero direction), which leave the real leaves unentered."""
    ro, rd, lo, hi = _mask_inputs(2)
    n = ray_block * 4
    ro[n:2 * n], rd[n:2 * n] = BIG, 0.0
    rayf = t_bvh.ray_features(t(ro[:2 * n]), t(rd[:2 * n]))
    args = (rayf, t(lo), t(hi), ray_block, 0.0, 1e16)
    first = t_pt.visit_first_hits(*args)
    hits = torch.cat(list(t_pt._visit_hits(*args)))
    assert first.shape == hits[:, 0].shape == (8, lo.shape[0])
    for b in range(8):
        for c in range(lo.shape[0]):
            idx = torch.nonzero(hits[b, :, c])
            assert int(first[b, c]) == (int(idx[0]) if len(idx)
                                        else ray_block)
    mask = t_pt.visit_masks_plain(*args)
    assert torch.equal(mask, (first < ray_block).to(torch.int32))
    unset = mask == 0
    assert unset.any() and (~unset).any()
    if ray_block == 100:                 # blocks that enter every leaf
        assert (~unset).all(1).any()
    rays = sum(ray_block if unset[b].any() else int(first[b].max()) + 1
               for b in range(8))
    b = checks.bound('mask', args)
    assert b['rays_needed'] == rays
    assert b['bound_bytes'] == rays * 64 + 2 * lo.size * 4 + mask.numel() * 4
    assert b['bound_ops'] == checks.SLAB_OPS * (
        int(unset.sum()) * ray_block + int((~unset).sum()))


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
