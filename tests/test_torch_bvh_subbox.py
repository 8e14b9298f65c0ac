"""The port's own third level of the BVH (nvdiffrecmc_tpu_torch.ops.bvh:
sub-boxes over G consecutive triangles of each leaf), the plain tracer that
walks it, the walk's shared-memory bound, and the device default of the
port's entry points (nvdiffrecmc_tpu_torch.device).

- Structure, on random soups at leaf_size 16 (one with masked triangles
  and a padded last leaf): every valid triangle's vertices lie inside its
  sub-box, every sub-box inside its leaf's box, groups without a valid
  triangle get an inverted box, G divides L.
- The three-level plain tracer equals brute force (tracer.tri_hits over
  every row) and the two-level walk (every triangle of every leaf entered)
  on every ray, on those soups and on 2,048 rays of the spot mesh made as
  bench.py makes them.
- checks.trace_work counts fewer triangle tests with sub-boxes than with
  whole leaves, both in the walk's order and as the least any walk needs;
  the walk's count equals a ray-by-ray count of the walk.
- The walk's shared memory is refused past the card's 227 KB; build's
  default leaf size (bvh.leaf_size_for) is the smallest power of two >=
  128 whose boxes fit it, and the any-hit answer does not depend on the
  leaf size; device=None means the card."""

import os

import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu_torch import checks
from nvdiffrecmc_tpu_torch import device as t_device
from nvdiffrecmc_tpu_torch.ops import bvh as t_bvh
from nvdiffrecmc_tpu_torch.ops import envshade as t_es
from nvdiffrecmc_tpu_torch.ops import pallas_tracer as t_pt
from nvdiffrecmc_tpu_torch.ops import tracer as t_tracer
from test_torch_tracer import _rays, icosphere_like

SOUPS = {'96': (96, 7, None), '400': (400, 0, None), 'masked': (150, 3, 16)}


def _soup(name):
    """(v [3T, 3], tri [T, 3], tri_mask or None) of a named soup; 'masked'
    drops its first 16 triangles, so the last leaf is empty and the one
    before it partly so."""
    n_tri, seed, n_masked = SOUPS[name]
    v, tri = icosphere_like(n_tri, seed)
    mask = None
    if n_masked:
        mask = np.ones(n_tri, bool)
        mask[:n_masked] = False
    return torch.as_tensor(v), torch.as_tensor(tri), (
        None if mask is None else torch.as_tensor(mask))


def _build(name, leaf_size=16):
    v, tri, mask = _soup(name)
    return v, tri, mask, t_bvh.build(v, tri, tri_mask=mask,
                                     leaf_size=leaf_size)


def _row_vertices(v, tri, mask, bvh):
    """[C*L, 3, 3] vertices of the triangle in each row of bvh.tri (found
    by its exact Plücker row) and [C*L] bool, False for zero rows."""
    t = tri.long()
    v0, v1, v2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    valid = torch.ones(t.shape[0], dtype=torch.bool) if mask is None else mask
    rows = t_bvh.tri_rows(v0, v1, v2, valid.float())
    index = {rows[i].numpy().tobytes(): i for i in range(t.shape[0])
             if valid[i]}
    verts = torch.zeros((bvh.tri.shape[0], 3, 3))
    real = torch.zeros(bvh.tri.shape[0], dtype=torch.bool)
    for k in range(bvh.tri.shape[0]):
        i = index.get(bvh.tri[k].numpy().tobytes())
        if i is not None:
            verts[k] = torch.stack([v0[i], v1[i], v2[i]])
            real[k] = True
        else:
            assert not bvh.tri[k].any()
    assert int(real.sum()) == int(valid.sum())
    return verts, real


@pytest.mark.parametrize('name', sorted(SOUPS))
def test_subboxes_hold_their_triangles(name):
    v, tri, mask, bvh = _build(name)
    L, G = bvh.leaf_size, bvh.sub_size
    assert G == min(t_bvh.SUB, L) and L % G == 0
    NS = bvh.n_leaves * L // G
    assert bvh.sub_lo.shape == bvh.sub_hi.shape == (NS, 3)
    verts, real = _row_vertices(v, tri, mask, bvh)
    group = torch.arange(bvh.tri.shape[0]) // G
    lo, hi = bvh.sub_lo[group][:, None], bvh.sub_hi[group][:, None]
    inside = ((verts >= lo) & (verts <= hi)).all(-1).all(-1)
    assert bool(inside[real].all())
    occupied = real.reshape(NS, G).any(1)
    assert bool((bvh.sub_lo[~occupied] > bvh.sub_hi[~occupied]).all())
    assert bool((bvh.sub_lo[occupied] <= bvh.sub_hi[occupied]).all())
    leaf = torch.arange(NS)[occupied] // (L // G)
    assert bool((bvh.sub_lo[occupied] >= bvh.aabb_lo[leaf]).all())
    assert bool((bvh.sub_hi[occupied] <= bvh.aabb_hi[leaf]).all())
    if name == 'masked':
        assert not bool(occupied.all())
        assert bool((bvh.aabb_lo[-1] > bvh.aabb_hi[-1]).all())


def test_sub_size_follows_leaf_size():
    v, tri, mask = _soup('96')
    for L, G in ((4, 4), (16, 8), (128, 8), (12, 4)):
        bvh = t_bvh.build(v, tri, leaf_size=L)
        assert bvh.sub_size == G and bvh.sub_lo.shape[0] * G == \
            bvh.n_leaves * L


def two_level_any_hit(ro, rd, bvh, tmin=0.0):
    """The walk before the sub-box level: every (ray, leaf) pair that
    enters the leaf's box tests all L triangles of the leaf."""
    rows = bvh.tri.reshape(bvh.n_leaves, bvh.leaf_size, -1)
    box = t_tracer.slab_hits(ro, 1.0 / rd, bvh.aabb_lo, bvh.aabb_hi, tmin)
    pr, pc = torch.nonzero(box, as_tuple=True)
    hit = torch.zeros(ro.shape[0], dtype=torch.bool)
    hit[pr[t_tracer.tri_hits(ro[pr], rd[pr], rows[pc], tmin).any(-1)]] = True
    return hit


def _check_walks(ro, rd, bvh):
    got = t_tracer.any_hit(ro, rd, bvh)
    brute = t_tracer.tri_hits(ro, rd, bvh.tri, 0.0).any(-1)
    assert torch.equal(got, brute), int((got != brute).sum())
    assert torch.equal(got, two_level_any_hit(ro, rd, bvh))
    assert torch.equal(t_pt.any_hit_pallas(ro, rd, bvh), got)
    return got


@pytest.mark.parametrize('name', sorted(SOUPS))
def test_three_level_tracer_equals_brute_force(name):
    _, _, _, bvh = _build(name)
    ro, rd = _rays(512, SOUPS[name][1] + 1)
    got = _check_walks(torch.as_tensor(ro), torch.as_tensor(rd), bvh)
    assert not bool(got[8:12].any())          # disabled rays
    assert 0.02 < float(got.float().mean()) < 0.96


@pytest.fixture(scope='module')
def spot():
    """The spot mesh's BVH at the main path's leaf size and 2,048 rays
    made as bench.py's bench_tracer makes them."""
    import chip_smoke
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import spot256_scene
    mesh = spot256_scene('cpu')
    bvh = t_bvh.build(mesh.v_pos, mesh.t_pos_idx, leaf_size=128)
    ro, rd, _ = chip_smoke.tracer_rays(mesh, 2048, 'cpu')
    return ro, rd, bvh


def test_three_level_tracer_on_spot(spot):
    ro, rd, bvh = spot
    got = _check_walks(ro, rd, bvh)
    assert 0.2 < float(got.float().mean()) < 0.8


def test_trace_work_counts_fewer_triangles(spot):
    ro, rd, bvh = spot
    work = checks.trace_work(ro, rd, bvh)
    n_hit = int(t_tracer.any_hit(ro, rd, bvh).sum())
    assert n_hit < work['tris'] < work['tris_two_level']
    assert work['tris'] < work['walk_tris'] < work['walk_tris_two_level']
    # a miss tests whole sub-boxes (G rows), or whole leaves before
    assert (work['tris'] - n_hit) % bvh.sub_size == 0
    assert (work['tris_two_level'] - n_hit) % bvh.leaf_size == 0
    assert work['slabs'] > ro.shape[0]
    b = checks.bound('trace', (ro, rd, bvh, 0.0))
    assert b['bound_ops'] == (checks.SLAB_OPS * work['slabs']
                              + checks.TRI_OPS * work['tris'])


def test_walk_count_follows_the_walk(spot):
    """On 64 spot rays, the walk's triangle tests equal a ray-by-ray walk:
    entered sub-boxes in index order, G rows each, up to the first hit."""
    ro, rd, bvh = spot
    ro, rd = ro[:64], rd[:64]
    G = bvh.sub_size
    rows = bvh.tri.reshape(-1, G, 24)
    want = 0
    for i in range(64):
        subs = torch.nonzero(t_tracer.entered(ro[i:i + 1], rd[i:i + 1], bvh,
                                              0.0)[0])[:, 0]
        for b in subs.tolist():
            h = t_tracer.tri_hits(ro[i:i + 1], rd[i:i + 1], rows[b], 0.0)[0]
            if bool(h.any()):
                want += int(torch.nonzero(h)[0, 0]) + 1
                break
            want += G
    assert checks.trace_work(ro, rd, bvh)['walk_tris'] == want


def test_walk_shared_memory_bound():
    """The walk holds the supernode and leaf boxes in shared memory, 32
    bytes each; a structure past the card's 227 KB is refused (here 8,000
    one-triangle leaves and their 1,000 supernodes, 288,000 bytes)."""
    _, _, _, bvh = _build('400')
    S = bvh.super_lo.shape[0]
    assert t_pt.walk_smem_bytes(bvh) == 32 * (S + bvh.n_leaves)
    v, tri = icosphere_like(8000, 5)
    big = t_bvh.build(torch.as_tensor(v), torch.as_tensor(tri), leaf_size=1)
    assert big.sub_size == 1
    with pytest.raises(ValueError, match='shared memory'):
        t_pt.walk_smem_bytes(big)


@pytest.mark.parametrize('n_tris,leaf', [
    (1, 128), (826368, 128), (826369, 256), (1652736, 256), (1652737, 512)])
def test_leaf_size_for_fits_the_walk(n_tris, leaf):
    """build's default leaf size: the smallest power of two >= 128 whose
    C + ceil(C / 8) boxes fit the walk's shared memory (7,264 boxes);
    arithmetic only, no mesh built."""
    assert t_bvh.leaf_size_for(n_tris) == leaf
    assert 32 * t_bvh.walk_boxes(n_tris, leaf) <= t_bvh.SMEM_MAX
    if leaf > 128:
        assert 32 * t_bvh.walk_boxes(n_tris, leaf // 2) > t_bvh.SMEM_MAX


def test_any_hit_does_not_depend_on_the_leaf_size():
    """The plain tracer on 4,096 rays against a 3,000-triangle soup (24
    leaves of 128, 12 of 256): the same any-hit booleans at both leaf
    sizes, equal to brute force; build's default takes 128 there."""
    v, tri = (torch.as_tensor(x) for x in icosphere_like(3000, 11))
    ro, rd = (torch.as_tensor(x) for x in _rays(4096, 12))
    hits = {}
    for L in (128, 256):
        bvh = t_bvh.build(v, tri, leaf_size=L)
        assert bvh.leaf_size == L and bvh.n_leaves == -(-3000 // L)
        hits[L] = t_tracer.any_hit(ro, rd, bvh)
    assert torch.equal(hits[128], hits[256])
    assert 0 < int(hits[128].sum()) < 4096
    rows = t_bvh.build(v, tri, leaf_size=128).tri
    brute = t_tracer.tri_hits(ro, rd, rows, 0.0).any(1)
    assert torch.equal(hits[128], brute)
    assert t_bvh.build(v, tri).leaf_size == 128


def test_device_default_is_the_card(monkeypatch):
    """device=None means the CUDA card, and raises without one; an explicit
    device is taken as given."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_device.resolve(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_es.make_perms(2)
    assert t_device.resolve('cpu') == torch.device('cpu')
    assert t_es.make_perms(2, n_tables=4, device='cpu').device.type == 'cpu'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert t_device.resolve(None) == torch.device('cuda')


def test_no_cpu_default_left():
    """Every `device=None` default of the port's entry points goes through
    device.resolve (kernels.require's device is a check, not a default)."""
    root = os.path.dirname(t_device.__file__)
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith('.py') or fn in ('device.py', 'kernels.py'):
                continue
            src = open(os.path.join(dirpath, fn)).read()
            for chunk in src.split('\ndef ')[1:]:
                head = chunk.split('):', 1)[0]
                if 'device=None' in head:
                    assert 'resolve(device)' in chunk.split('\ndef ')[0], (
                        fn, head.split('(')[0])
