"""The CUDA resolve's design, held on the CPU through its plain twin.

csrc/resolve.cu computes each triangle's fields and pixel rectangle once,
then takes a 64-bit atomicMin of the key (ordered_bits(z) << 32) | tri_id
over the rectangle's pixels that pass the inside test and the peel rule.
`_key_resolve` is that scheme in plain PyTorch: the setup's rectangle
(pallas_raster._tri_rects), the pairs of pallas_raster.covered_pairs, the
ordered-bits key (shifted into int64's signed order) and
scatter_reduce(..., 'amin').  It must equal resolve_batch_plain bit for bit
on every pixel: the spot mesh at 64x64 under two cameras and its second
peel layer, two triangles at exactly equal depth, a -0.0 / +0.0 tie, a
triangle crossing w = 0 and degenerate triangles.  On those cases every
pair that the fields cover, over all pixels and triangles, lies in its
triangle's rectangle (the rectangle takes nothing from an ordinary
triangle).  A sliver of the spot mesh, whose fields are rounding noise,
passes the inside test only outside its rectangle, and both resolves
leave it those pixels."""

import os

import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu_torch.ops import pallas_raster, vecmath, xfm
from nvdiffrecmc_tpu_torch.render import obj as obj_mod

RES = 64
EMPTY = 2 ** 63 - 1          # the all-ones uint64 key in int64's order
SPOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'docs', 'quality_r5', 'spot256', 'mesh.obj')


def _ordered(z):
    """int64 in [0, 2^32) that sorts like the float32 z, -0.0 as +0.0."""
    z = torch.where(z == 0, torch.zeros_like(z), z)
    u = z.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, 0xFFFFFFFF - u, u | 2 ** 31)


def _key_resolve(v_clip, tri, H, W, prev_z, prev_id):
    """The CUDA route's key scheme in plain PyTorch: (z, tid) [N, H, W]."""
    zs, tids = [], []
    for b in range(v_clip.shape[0]):
        rect = pallas_raster._tri_rects(v_clip[b], tri, H, W)
        t, pix, z = pallas_raster.covered_pairs(
            pallas_raster._tri_coefs(v_clip[b], tri), rect, H, W, prev_z[b],
            prev_id[b])
        key = torch.full((H * W,), EMPTY, dtype=torch.int64)
        key.scatter_reduce_(0, pix, (_ordered(z) - 2 ** 31) * 2 ** 32 + t,
                            'amin')
        hit = key != EMPTY
        o = (key >> 32) + 2 ** 31
        bits = torch.where(o >= 2 ** 31, o - 2 ** 31, 0xFFFFFFFF - o)
        bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
        z_out = bits.to(torch.int32).view(torch.float32)
        zs.append(torch.where(hit, z_out, 0.0).reshape(H, W))
        tids.append(torch.where(hit, (key & 0xFFFFFFFF) + 1, 0)
                    .to(torch.int32).reshape(H, W))
    return torch.stack(zs), torch.stack(tids)


def _first_layer(N, H, W):
    return (torch.full((N, H, W), -1e30),
            torch.zeros((N, H, W), dtype=torch.int32))


def _spot(n_cams=2, seed=3):
    vertices, _, _, faces = obj_mod.read_obj(SPOT)[:4]
    v = np.array(vertices, np.float32)
    rng = np.random.RandomState(seed)
    proj = vecmath.perspective(np.deg2rad(45), 1.0, 0.1, 1000.0)
    hom = np.concatenate([v, np.ones_like(v[:, :1])], -1)
    v_clip = [hom @ (proj @ vecmath.translate(0, 0, -3.0)
                     @ vecmath.random_rotation_translation(0.25, rng)).T
              for _ in range(n_cams)]
    return (torch.as_tensor(np.stack(v_clip).astype(np.float32)),
            torch.as_tensor(np.array(faces, np.int32)))


def _crossing_w0():
    """A ground plane from far in front of the eye to behind it, as
    tests/test_rasterizer.py's clipless test makes it."""
    proj = np.asarray(vecmath.perspective(0.9, 1.0, 0.1, 100.0))
    pts = np.array([[-5.0, -0.5, -8.0], [5.0, -0.5, -8.0],
                    [-5.0, -0.5, 5.0], [5.0, -0.5, 5.0]], np.float32)
    v4 = np.concatenate([pts, np.ones((4, 1), np.float32)], -1)
    return (torch.as_tensor((v4 @ proj.T).astype(np.float32))[None],
            torch.tensor([[0, 1, 2], [2, 1, 3]], dtype=torch.int32))


def _flat(xy, z, w=1.0):
    v = np.zeros((len(xy), 4), np.float32)
    v[:, 0:2] = xy
    v[:, 2] = z
    v[:, 3] = w
    return v


def _equal_z():
    """Triangles 1 and 3 are one triangle twice (equal depth on every
    pixel), behind triangle 0 in part, in front of triangle 2."""
    big = [[-0.9, -0.8], [0.8, -0.9], [0.0, 0.9]]
    small = [[-0.95, -0.2], [-0.1, -0.3], [-0.5, 0.5]]
    v = np.concatenate([_flat(small, 0.1), _flat(big, 0.3),
                        _flat(big, 0.6)])
    tri = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [3, 4, 5]]
    return (torch.as_tensor(v)[None], torch.tensor(tri, dtype=torch.int32))


def _signed_zero():
    """One triangle twice, with vertex depths +0.0 (id 0) and -0.0 (id 1):
    on a quarter of its pixels the depth of id 1 is -0.0 and of id 0 +0.0
    (the plain version holds them equal and keeps id 0)."""
    xy = [[-0.8, -0.7], [0.9, -0.6], [0.1, 0.85]]
    v = np.concatenate([_flat(xy, 0.0), _flat(xy, -0.0)])
    return (torch.as_tensor(v)[None],
            torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32))


def _degenerate():
    """A collinear triangle (det 0), one with a repeated vertex, and a
    sliver next to an ordinary triangle."""
    v = np.concatenate([
        _flat([[-0.9, -0.9], [0.0, 0.0], [0.9, 0.9]], 0.2),
        _flat([[-0.5, 0.5], [-0.5, 0.5], [0.5, -0.5]], 0.2),
        _flat([[-0.9, 0.1], [0.9, 0.1003], [0.0, 0.1001]], 0.3),
        _flat([[-0.6, -0.6], [0.6, -0.5], [0.0, 0.7]], 0.5)])
    tri = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    return torch.as_tensor(v)[None], tri


def _case(name):
    """(v_clip, tri, H, W, prev_z, prev_id) of each case."""
    if name in ('spot', 'spot_layer2'):
        v_clip, tri = _spot()
    else:
        v_clip, tri = {'equal_z': _equal_z, 'signed_zero': _signed_zero,
                       'crossing_w0': _crossing_w0,
                       'degenerate': _degenerate}[name]()
    pz, pid = _first_layer(v_clip.shape[0], RES, RES)
    if name == 'spot_layer2':
        z1, tid1 = pallas_raster.resolve_plain(v_clip, tri, RES, RES, pz,
                                               pid)
        pz = torch.where(tid1 > 0, z1, torch.full_like(z1, 1e30))
        pid = tid1
    return v_clip, tri, RES, RES, pz, pid


def _ids(start, n):
    """tri_id + 1 of triangles start .. start + n, as prev_id holds them."""
    return torch.arange(start + 1, start + n + 1, dtype=torch.int32)


CASES = ['spot', 'spot_layer2', 'equal_z', 'signed_zero', 'crossing_w0',
         'degenerate']


@pytest.mark.parametrize('name', CASES)
def test_key_scheme_equals_plain(name):
    args = _case(name)
    zk, tidk = _key_resolve(*args)
    zp, tidp = pallas_raster.resolve_plain(*args)
    assert torch.equal(tidk, tidp)
    assert torch.equal(zk, zp)
    covered = float((tidp > 0).double().mean())
    assert covered > 0.02, covered
    if name == 'spot_layer2':
        hit = tidp > 0                             # a layer behind the first
        assert bool((tidp[hit] != args[5][hit]).all())
    if name == 'equal_z':
        assert bool((tidp == 4).sum() == 0) and bool((tidp == 2).any())
    if name == 'signed_zero':
        v_clip, tri, H, W, pz, pid = args
        t, pix, z = pallas_raster.covered_pairs(
            pallas_raster._tri_coefs(v_clip[0], tri),
            pallas_raster._tri_rects(v_clip[0], tri, H, W), H, W, pz[0],
            pid[0])
        neg1 = set(pix[(t == 1) & torch.signbit(z)].tolist())
        pos0 = set(pix[(t == 0) & ~torch.signbit(z)].tolist())
        assert neg1 & pos0
        assert bool((tidp[tidp > 0] == 1).all())
    if name == 'crossing_w0':
        rect = pallas_raster._tri_rects(args[0][0], args[1], RES, RES)
        assert rect.tolist() == [[0, 0, RES - 1, RES - 1]] * 2
    if name == 'degenerate':
        rect = pallas_raster._tri_rects(args[0][0], args[1], RES, RES)
        assert rect[0].tolist() == [0, 0, -1, -1]        # det 0: empty
        assert rect[1].tolist() == [0, 0, -1, -1]


@pytest.mark.parametrize('name', CASES)
def test_rectangles_hold_every_covered_pair(name):
    """Every (pixel, triangle) pair that passes the plain version's inside
    test, over all pixels and triangles, lies in the triangle's rectangle,
    so covered_pairs finds them all."""
    v_clip, tri, H, W, pz, pid = _case(name)
    sx, sy = pallas_raster._pixel_ndc_xy(H, W, 'cpu')
    sx, sy = sx[None, :, None], sy[:, None, None]
    for b in range(v_clip.shape[0]):
        coef15 = pallas_raster._tri_coefs(v_clip[b], tri)
        rect = pallas_raster._tri_rects(v_clip[b], tri, H, W)
        n = 0
        for s in range(0, tri.shape[0], 2048):
            cf = coef15[s:s + 2048]

            def field(f):
                return cf[:, 3 * f] * sx + cf[:, 3 * f + 1] * sy \
                    + cf[:, 3 * f + 2]
            e0, e1, e2, z, sm = (field(f) for f in range(5))
            y, x, t = torch.nonzero(
                (e0 > 0) & (e1 > 0) & (e2 > 0) & (sm > 0) & (z >= -1)
                & (z <= 1) & (z > pz[b][..., None] + pallas_raster.Z_EPS)
                & (_ids(s, cf.shape[0]) != pid[b][..., None]),
                as_tuple=True)
            r = rect[s + t].long()
            assert bool(((x >= r[:, 0]) & (y >= r[:, 1]) & (x <= r[:, 2])
                         & (y <= r[:, 3])).all())
            n += t.numel()
        got = pallas_raster.covered_pairs(coef15, rect, H, W, pz[b],
                                          pid[b])[0].numel()
        assert got == n and n > 0


def test_sliver_noise_outside_its_rectangle():
    """Triangle 15946 of the spot mesh (its three vertices within 3e-6 of
    each other in w) under DatasetMesh(seed=5)'s second training camera at
    512x512: its fields pass the inside test on 6 pixels, all outside its
    rectangle, nearer than the triangles that do cover them.  The plain
    resolve, over it and those two triangles, gives each pixel the nearer
    real triangle, as the key scheme does."""
    v, f = obj_mod.read_obj(SPOT)[0:4:3]
    tri = torch.tensor(np.array(f, np.int32))[[14577, 14585, 15946]]
    rng = np.random.RandomState(5)
    for _ in range(2):
        mv = vecmath.translate(0, 0, -3.0) @ \
            vecmath.random_rotation_translation(0.25, rng)
    mvp = vecmath.perspective(np.deg2rad(45), 1.0, 0.1, 1000.0) @ mv
    v_clip = xfm.xfm_points(torch.tensor(np.array(v, np.float32)),
                            torch.tensor(mvp.astype(np.float32)))[0]
    H = W = 512
    coef15 = pallas_raster._tri_coefs(v_clip, tri)
    rect = pallas_raster._tri_rects(v_clip, tri, H, W)
    sx, sy = pallas_raster._pixel_ndc_xy(H, W, 'cpu')
    c = coef15[2]
    e0, e1, e2, z, sm = (c[3 * k] * sx[None, :] + c[3 * k + 1] * sy[:, None]
                         + c[3 * k + 2] for k in range(5))
    y, x = torch.nonzero((e0 > 0) & (e1 > 0) & (e2 > 0) & (sm > 0)
                         & (z >= -1) & (z <= 1), as_tuple=True)
    x0, y0, x1, y1 = rect[2].tolist()
    assert x.numel() == 6
    assert not bool(((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)).any())
    args = (v_clip[None], tri, H, W) + _first_layer(1, H, W)
    zp, tidp = pallas_raster.resolve_plain(*args)
    zk, tidk = _key_resolve(*args)
    assert torch.equal(tidp, tidk) and torch.equal(zp, zk)
    got = tidp[0, y, x]
    assert bool((got > 0).all()) and bool((got != 3).all())
    assert bool((z[y, x] < zp[0, y, x]).all())    # the noise is nearer
