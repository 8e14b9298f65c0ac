"""The port's CUDA kernels against their plain PyTorch versions on the card
(the checks of chip_smoke.py phases 3 and 6, on smaller frames of the same
scene: the slice's settings at 256x256, and a ragged two-camera frame;
the backward kernels on the inputs of one training step at each, and the
light scatter with every ray on one texel; the standalone tracer and the
visit mask on 2^18 rays made as bench.py makes them, the mask also at ray
blocks of 1,000 and 4,096, on synthetic box sets of 5, 300 and 13,000
leaves, on coherent rays and on runs of equal rays; the row scatter's
instances (3, 4, 6, 9, 13 channels and the generic one) on repeated,
alternating and out-of-range ids, zero rows, a ragged row count and
unaligned values; the sample kernel on one stratum, as the stratum loop
launches it; the launches of a validation render past 256 strata; the BVH
walk of trace and trace + shade at the main path's full size, on rays
that graze sub-box and leaf faces and on rays aimed at the mesh's edges
and vertices, and its refusal of a structure whose boxes do not fit in
shared memory; the resolve at 500x333 on every pixel, on a full-screen
triangle, exact and signed-zero depth ties, the spot mesh and its second peel layer, and its setup kernel's
fields bit for bit; the denoiser in both modes at 500x333 and sigma 2 and
0.6, a refused launch, and 20 launches equal to the first at 1x1, 33x9
and 511x257; the guide and sample kernels at odd light sizes, 37x75 and
1024x2048, the sampler at 1 and 16 strata; shade_bwd at 1, 16 and 256
strata on a pixel count that is not a multiple of 32).
Marked `gpu`; skipped where torch.cuda.is_available() is false.  On a machine with a GPU and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

# (height, width, batch, n_samples, bsdf): the slice's settings at 256^2,
# and a ragged frame (sizes not multiples of the 32-pixel tiles or the
# 32x8 denoiser tiles, two cameras, 9 strata, Lambert only)
CONFIGS = {'slice': (256, 256, 1, 4, 'pbr'),
           'ragged': (72, 100, 2, 3, 'diffuse')}


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def recorded(request):
    """Kernel inputs recorded while one frame renders."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import checks, kernels
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.render import render as render_mod
    H, W, B, n, bsdf = CONFIGS[request.param]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    kernels.build()
    mesh = spot256_scene(dev)
    FLAGS = dict(n_samples=n, train_res=[H, W], cam_near_far=[0.1, 1000.0],
                 spp=1, layers=1, iter=1, batch=B, envlight=SPOT256_PROBE)
    ds = DatasetMesh(mesh, 3.0, FLAGS, seed=1)
    geometry = DLMesh(ds.ref_mesh, FLAGS)
    cams = [ds._random_scene() for _ in range(B)]
    mvp = torch.as_tensor(np.concatenate([c[1] for c in cams]), device=dev)
    campos = torch.as_tensor(np.concatenate([c[2] for c in cams]), device=dev)
    m, bvh = geometry.getMesh(geometry.parameters(), mesh.material)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels.reset_launches()
    with torch.no_grad(), checks.Recorder() as rec:
        buf = render_mod.render_mesh(
            FLAGS, m, mvp, campos, ds.lgt, (H, W), bvh, ds.perms, gen,
            msaa=True, background=torch.ones((B, H, W, 3), device=dev),
            bsdf=bsdf, denoiser_sigma=2.0, rnd_seed=1)
        torch.cuda.synchronize()
    assert buf['shaded'].shape == (B, H, W, 4)
    assert all(torch.isfinite(v).all() for v in buf.values())
    assert dict(kernels.LAUNCHES) == {k: int(k in checks.FORWARD)
                                      for k in kernels.LAUNCHES}
    return rec.args


@pytest.mark.parametrize('name', ['resolve', 'sample_guide', 'sample',
                                  'trace_shade', 'denoise'])
def test_kernel_matches_plain(recorded, name):
    from nvdiffrecmc_tpu_torch import checks
    with torch.no_grad():
        r = checks.run(name, recorded, reps=1)
    assert r['ok'], r


def test_resolve_peel_layer_matches_plain(recorded):
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import pallas_raster
    v_clip, tri, H, W, pz, pid = recorded['resolve']
    z1, tid1 = pallas_raster._resolve_cuda(v_clip, tri, H, W, pz, pid)
    pz2 = torch.where(tid1 > 0, z1, torch.full_like(z1, 1e30)).contiguous()
    r = checks.check_resolve(v_clip, tri, H, W, pz2, tid1, reps=1)
    assert r['ok'], r
    assert float((tid1 > 0).float().mean()) > 0.05


def _flat(xy, z, w=1.0):
    v = np.zeros((len(xy), 4), np.float32)
    v[:, 0:2] = xy
    v[:, 2] = z
    v[:, 3] = w
    return v


def _resolve_scene(name, dev):
    """(v_clip [N, V, 4], tri [T, 3] int32) of a resolve test scene."""
    from nvdiffrecmc_tpu_torch.ops import vecmath, xfm
    if name == 'full_screen':
        # one triangle over the whole screen; a plane that crosses w = 0
        # (its triangles get full-screen rectangles); a small one in front
        v = np.concatenate([
            _flat([[-3.0, -3.0], [3.0, -3.0], [0.0, 4.0]], 0.7),
            _flat([[-0.2, -0.2], [0.3, -0.1], [0.0, 0.3]], 0.1)])
        proj = vecmath.perspective(0.9, 1.0, 0.1, 100.0)
        pts = np.array([[-5.0, -0.5, -8.0], [5.0, -0.5, -8.0],
                        [-5.0, -0.5, 5.0], [5.0, -0.5, 5.0]], np.float32)
        v4 = np.concatenate([pts, np.ones((4, 1), np.float32)], -1)
        v = np.concatenate([v, (v4 @ proj.T).astype(np.float32)])
        tri = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [8, 7, 9]]
    elif name == 'ties':
        # triangles 1 and 3 are one triangle twice (equal depth); 4 and 5
        # one triangle with vertex depths +0.0 and -0.0
        big = [[-0.9, -0.8], [0.8, -0.9], [0.0, 0.9]]
        small = [[-0.95, -0.2], [-0.1, -0.3], [-0.5, 0.5]]
        xy = [[-0.8, -0.7], [0.9, -0.6], [0.1, 0.85]]
        v = np.concatenate([_flat(small, 0.1), _flat(big, 0.3),
                            _flat(big, 0.6), _flat(xy, 0.0),
                            _flat(xy, -0.0)])
        tri = [[0, 1, 2], [3, 4, 5], [6, 7, 8], [3, 4, 5], [9, 10, 11],
               [12, 13, 14]]
    else:                                       # the spot mesh, two cameras
        from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import spot256_scene
        mesh = spot256_scene(dev)
        rng = np.random.RandomState(3)
        mvp = np.stack([vecmath.perspective(np.deg2rad(45), 500 / 333, 0.1,
                                            1000.0)
                        @ vecmath.translate(0, 0, -3.0)
                        @ vecmath.random_rotation_translation(0.25, rng)
                        for _ in range(2)])
        return (xfm.xfm_points(mesh.v_pos, torch.as_tensor(mvp, device=dev))
                .contiguous(), mesh.t_pos_idx.contiguous())
    return (torch.as_tensor(v, device=dev)[None].contiguous(),
            torch.tensor(tri, dtype=torch.int32, device=dev))


@pytest.mark.parametrize('name,layer', [('full_screen', 1), ('ties', 1),
                                        ('spot', 1), ('spot', 2)])
def test_resolve_matches_plain_on_every_pixel(name, layer):
    """The resolve at 500x333 (W x H): z and tid equal to the plain
    version's on every pixel, for a full-screen triangle and triangles
    crossing w = 0, for exact depth ties and a -0.0 / +0.0 tie (the lower
    id wins), and for the spot mesh under two cameras and its second peel
    layer."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import checks, kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_raster
    kernels.build()
    dev = torch.device('cuda', 0)
    H, W = 333, 500
    v_clip, tri = _resolve_scene(name, dev)
    N = v_clip.shape[0]
    pz = torch.full((N, H, W), -1e30, device=dev)
    pid = torch.zeros((N, H, W), dtype=torch.int32, device=dev)
    if layer == 2:
        z1, tid1 = pallas_raster._resolve_cuda(v_clip, tri, H, W, pz, pid)
        pz = torch.where(tid1 > 0, z1, torch.full_like(z1, 1e30))
        pid = tid1
    r = checks.check_resolve(v_clip, tri, H, W, pz, pid, reps=1)
    assert r['ok'] and r['ids_differ'] == 0 and r['z_differ'] == 0, r
    _, tid = pallas_raster._resolve_cuda(v_clip, tri, H, W, pz, pid)
    assert float((tid > 0).float().mean()) > 0.05
    if name == 'full_screen':
        assert bool((tid > 0).all())
    if name == 'ties':
        assert not bool((tid == 4).any()) and bool((tid == 2).any())
        assert not bool((tid == 6).any()) and bool((tid == 5).any())


@pytest.mark.parametrize('name', ['full_screen', 'spot'])
def test_resolve_setup_matches_chunk_coefs(name):
    """The setup kernel's 15 fields equal _chunk_coefs' bit for bit, and
    its rectangles _tri_rects'."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_raster
    kernels.build()
    dev = torch.device('cuda', 0)
    H, W = 333, 500
    v_clip, tri = _resolve_scene(name, dev)
    N, T = v_clip.shape[0], tri.shape[0]
    pz = torch.full((N, H, W), -1e30, device=dev)
    pid = torch.zeros((N, H, W), dtype=torch.int32, device=dev)
    px, py = pallas_raster._pixel_ndc_xy(H, W, dev)
    coef = torch.empty((N, T, 15), dtype=torch.float32, device=dev)
    rect = torch.empty((N, T, 4), dtype=torch.int32, device=dev)
    out = [torch.empty((N, H, W), dtype=d, device=dev)
           for d in (torch.int64, torch.float32, torch.int32)]
    # the C entry itself, so that the setup's scratch buffers are ours
    rc = kernels.lib().nvk_resolve(
        *(t.data_ptr() for t in (v_clip, tri, px, py, pz, pid, coef, rect,
                                 *out)),
        N, v_clip.shape[1], T, H, W, kernels.stream_ptr(v_clip))
    kernels.check(rc, 'nvk_resolve')
    for b in range(N):
        want = pallas_raster._tri_coefs(v_clip[b], tri)
        same = (coef[b].view(torch.int32) == want.view(torch.int32))
        assert bool(same.all()), int((~same).sum())
        assert torch.equal(rect[b],
                           pallas_raster._tri_rects(v_clip[b], tri, H, W))


def _denoise_inputs(H, W, N=1, seed=0):
    """Smooth normals and depth with noise, depth gradients, random
    colours: weights of every size, as a rendered frame gives them."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 3, H), np.linspace(0, 4, W),
                         indexing='ij')
    n = np.stack([np.sin(xx), np.cos(yy), np.ones_like(xx)], -1)[None]
    n = n + 0.05 * rng.randn(N, H, W, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = (0.5 + 0.1 * np.sin(xx + yy))[None] + 0.002 * rng.randn(N, H, W)
    dz = 0.01 + 0.01 * rng.rand(N, H, W)
    col6 = rng.rand(N, H, W, 6)
    g6 = rng.randn(N, H, W, 6)
    dev = torch.device('cuda', 0)
    return [torch.as_tensor(a.astype(np.float32), device=dev).contiguous()
            for a in (col6, n, np.stack([z, dz], -1), g6)]


@pytest.mark.parametrize('sigma', [2.0, 0.6])
def test_denoise_both_modes_ragged(sigma):
    """The denoiser at 500x333 (tiles and borders ragged in both axes), at
    sigma 2 (every tap of the 23x23 window) and 0.6 (the dynamic radius,
    5, cuts it to 11x11): both modes within the checks' tolerances, and
    two launches equal on every entry."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import checks, kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_denoise
    kernels.build()
    col6, nrm, zdz, g6 = _denoise_inputs(333, 500, N=2)
    r = checks.check_denoise(col6, nrm, zdz, sigma, reps=1)
    assert r['ok'], r
    r = checks.check_denoise_grad(g6, nrm, zdz, sigma, reps=1)
    assert r['ok'], r
    for grad_mode, c in ((False, col6), (True, g6)):
        one = pallas_denoise._launch(c, nrm, zdz, sigma, grad_mode)
        assert torch.equal(
            pallas_denoise._launch(c, nrm, zdz, sigma, grad_mode), one)


def test_denoise_refused_launch_raises():
    """A launch the card refuses (65,536 images, past the 65,535 blocks of
    a grid's z dimension) raises and counts no launch."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_denoise
    kernels.build()
    dev = torch.device('cuda', 0)
    col6, nrm, zdz = (torch.zeros((65536, 1, 1, c), device=dev)
                      for c in (6, 3, 2))
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match='nvk_denoise'):
        pallas_denoise._launch(col6, nrm, zdz, 2.0, False)
    assert kernels.LAUNCHES['denoise'] == 0


def test_wrapper_rejects_bad_input(recorded):
    from nvdiffrecmc_tpu_torch.ops import pallas_denoise
    col6, nrm, zdz, sigma = recorded['denoise']
    with pytest.raises(ValueError):
        pallas_denoise._denoise_cuda(col6.double(), nrm, zdz, sigma)
    with pytest.raises(ValueError):
        pallas_denoise._denoise_cuda(col6, nrm[..., :2].contiguous(), zdz,
                                     sigma)
    with pytest.raises(ValueError):
        pallas_denoise._denoise_cuda(col6, nrm.cpu(), zdz, sigma)
    np.testing.assert_array_equal(
        pallas_denoise._denoise_cuda(col6, nrm, zdz, sigma).shape,
        tuple(col6.shape[:3]) + (7,))


@pytest.fixture(scope='module', params=sorted(CONFIGS))
def recorded_step(request):
    """Kernel inputs recorded while one training step runs (textures
    256x256, light 64x64)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import checks, config, kernels, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    H, W, B, n, bsdf = CONFIGS[request.param]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    kernels.build()
    FLAGS = config.make_flags(train_res=[H, W], n_samples=n, batch=B,
                              texture_res=[256, 256], bsdf=bsdf,
                              envlight=SPOT256_PROBE)
    ds = DatasetMesh(spot256_scene(dev), 3.0, dict(FLAGS, batch=1), seed=2)
    geometry = DLMesh(ds.ref_mesh, FLAGS)
    mat, static = train.initial_guess_material(geometry, False, FLAGS,
                                               device=dev)
    light = light_mod.create_trainable_env_rnd(64, 0.0, 0.5, device=dev)
    params = train.make_params(geometry, mat, light)
    items = [ds[i] for i in range(B)]
    target = {'img': torch.cat([it['img'] for it in items]),
              'mvp': np.concatenate([it['mvp'] for it in items]),
              'campos': np.concatenate([it['campos'] for it in items])}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    target = train.prepare_batch(target, [H, W], 'random', gen, FLAGS)
    kernels.reset_launches()
    with checks.Recorder() as rec:
        train.train_step(geometry, params,
                         train.make_optimizers(params, FLAGS), static, target,
                         0, FLAGS, train.createLoss(FLAGS), ds.perms, None)
        torch.cuda.synchronize()
    for name in checks.BACKWARD:
        assert kernels.LAUNCHES[name] >= 1, name
    return rec.args


@pytest.mark.parametrize('name', ['denoise_grad', 'shade_bwd',
                                  'light_scatter', 'scatter'])
def test_backward_kernel_matches_plain(recorded_step, name):
    from nvdiffrecmc_tpu_torch import checks
    r = checks.run(name, recorded_step, reps=1)
    assert r['ok'], r


def test_light_scatter_hot_texel():
    """Every ray of every stratum on one texel: the atomics serialise on
    three addresses and must still add every cotangent.  The cotangents
    are small integers, so every partial sum is exact in float32 and the
    total must be too."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import checks, kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    kernels.build()
    n2, P = 16, 65536
    drad = torch.zeros(n2, 8, P)
    drad[:, 0:6] = torch.tensor([1.0, 2.0, 3.0, 1.0, 2.0, 3.0])[:, None]
    drad[:, 6:8] = 1234.0
    r = checks.check_light_scatter(drad.cuda(), 256, 256, reps=1)
    assert r['ok'], r
    rows = pallas_shade._light_scatter_cuda(drad.cuda(), 256, 256).cpu()
    rows = rows.reshape(-1, 3)
    assert rows[1234].tolist() == [2.0 * n2 * P * c for c in (1, 2, 3)]
    rows[1234] = 0.0
    assert float(rows.abs().max()) == 0.0


def test_light_scatter_hot_texel_random():
    """Every ray on one texel, with seeded random positive cotangents: the
    hot texel's 2 * 16 * 65536 terms, added by atomics in the order they
    land, agree with their float64 sum within 1e-4 relative, and the
    kernel check's sqrt(n) bound holds."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import checks, kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    kernels.build()
    n2, P = 16, 65536
    rng = np.random.RandomState(12)
    drad = torch.zeros(n2, 8, P)
    drad[:, 0:6] = torch.as_tensor(rng.uniform(0.0, 1.0, (n2, 6, P))
                                   .astype(np.float32))
    drad[:, 6:8] = 1234.0
    r = checks.check_light_scatter(drad.cuda(), 256, 256, reps=1)
    assert r['ok'], r
    got = pallas_shade._light_scatter_cuda(drad.cuda(), 256, 256).cpu()
    got = got.reshape(-1, 3).double()
    d = drad.double()
    want = d[:, 0:3].sum((0, 2)) + d[:, 3:6].sum((0, 2))
    assert torch.allclose(got[1234], want, rtol=1e-4, atol=0.0), (
        got[1234], want)
    got[1234] = 0.0
    assert float(got.abs().max()) == 0.0


def test_sample_one_stratum_matches_plain(recorded):
    """The stratum loop launches the sample kernel on one stratum's uniforms
    at a time: on u8[i:i+1] it agrees with its plain version, and with
    stratum i of the launch over all strata bit for bit."""
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    u8, *rest = recorded['sample']
    mask = recorded['trace_shade'][1][pallas_shade.GB_MASK] > 0
    i = u8.shape[0] // 2
    one = u8[i:i + 1].contiguous()
    with torch.no_grad():
        r = checks.check_sample(one, *rest, mask=mask, reps=1)
        assert r['ok'], r
        whole = pallas_shade._sample_cuda(u8, *rest)
        assert torch.equal(pallas_shade._sample_cuda(one, *rest)[0],
                           whole[i])


def test_trace_shade_bit_exact(recorded):
    """After the BVH walk moved into csrc/trace.cuh, trace + shade's
    visibility still equals the plain tracer's on every compared ray."""
    from nvdiffrecmc_tpu_torch import checks
    with torch.no_grad():
        r = checks.run('trace_shade', recorded, reps=1)
    assert r['agree'] == 1.0, r


@pytest.fixture(scope='module')
def spot_rays():
    """The spot mesh's BVH and 2^18 rays made as bench.py's bench_tracer
    makes them (chip_smoke.tracer_rays)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    import chip_smoke
    from nvdiffrecmc_tpu_torch import kernels
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import spot256_scene
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    kernels.build()
    dev = torch.device('cuda', 0)
    mesh = spot256_scene(dev)
    bvh = bvh_mod.build(mesh.v_pos, mesh.t_pos_idx, leaf_size=128)
    ro, rd, _ = chip_smoke.tracer_rays(mesh, 1 << 18, dev)
    return ro, rd, bvh


def test_trace_matches_plain(spot_rays):
    from nvdiffrecmc_tpu_torch import checks
    ro, rd, bvh = spot_rays
    r = checks.check_trace(ro, rd, bvh, reps=1)
    assert r['ok'] and r['agree'] == 1.0, r
    # disabled rays (origin at BIG, zero direction) never hit
    from nvdiffrecmc_tpu_torch.ops import pallas_tracer
    occ = pallas_tracer.any_hit_pallas(torch.full_like(ro[:300], 3e37),
                                       torch.zeros_like(rd[:300]), bvh)
    assert not bool(occ.any())


@pytest.mark.parametrize('ray_block,n_leaves', [(1024, None), (256, 5),
                                                (64, 300), (1000, None),
                                                (4096, None), (256, 13000)])
def test_mask_matches_plain(spot_rays, ray_block, n_leaves):
    """The spot BVH's 207 leaves (not a multiple of 32), and synthetic box
    sets of 5, 300 and 13,000 leaves (past the 12,288 of the shared flag
    array the kernel had before); ray blocks of 1,000 and 4,096 rays (the
    kernel stages 512 a tile: 1,000 is no multiple of it)."""
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    ro, rd, bvh = spot_rays
    n = ro.shape[0] // ray_block * ray_block
    if n_leaves is not None and n_leaves > 1000:
        n = 1 << 14
    rayf = bvh_mod.ray_features(ro[:n], rd[:n])
    lo, hi = bvh.aabb_lo, bvh.aabb_hi
    if n_leaves is not None:
        g = torch.Generator(device=ro.device)
        g.manual_seed(n_leaves)
        c = torch.rand((n_leaves, 3), generator=g, device=ro.device) * 2 - 1
        e = torch.rand((n_leaves, 3), generator=g, device=ro.device) * 0.05
        lo, hi = (c - e).contiguous(), (c + e).contiguous()
        lo[0], hi[0] = 3e37, -3e37                    # an empty leaf
    r = checks.check_mask(rayf, lo, hi, ray_block, 0.0, 1e16, reps=1)
    assert r['ok'], r


def test_mask_coherent_rays_matches_plain(spot_rays):
    """Blocks of 1,024 rays from one point each in a narrow cone: most
    leaves stay unset for a whole block, so the kernel walks every ray for
    them."""
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    from nvdiffrecmc_tpu_torch.ops import pallas_tracer
    _, _, bvh = spot_rays
    dev = bvh.aabb_lo.device
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    nb, rb = 256, 1024
    lo, hi = bvh.aabb_lo.amin(0), bvh.aabb_hi.amax(0)
    p = lo + (hi - lo) * torch.rand((nb, 1, 3), generator=g, device=dev)
    d = torch.randn((nb, 1, 3), generator=g, device=dev)
    ro = (p + 0.01 * torch.randn((nb, rb, 3), generator=g, device=dev))
    rd = d + 0.05 * torch.randn((nb, rb, 3), generator=g, device=dev)
    rd = rd / rd.norm(dim=-1, keepdim=True)
    rayf = bvh_mod.ray_features(ro.reshape(-1, 3).contiguous(),
                                rd.reshape(-1, 3).contiguous())
    r = checks.check_mask(rayf, bvh.aabb_lo, bvh.aabb_hi, rb, 0.0, 1e16,
                          reps=1)
    assert r['ok'], r
    want = pallas_tracer.visit_masks_plain(rayf, bvh.aabb_lo, bvh.aabb_hi,
                                           rb, 0.0, 1e16)
    assert float(want.double().mean()) < 0.5, float(want.double().mean())


def test_mask_duplicate_rays_matches_plain(spot_rays):
    """Runs of equal rays (the kernel stages one ray of a run) of 1 to 300
    rays, across tiles and blocks of 1,000, a third of them disabled rays
    at BIG with a zero direction, against the spot BVH's leaves and an
    inverted leaf at BIG, which the disabled rays enter ((BIG - BIG) 2e12
    = 0 on every axis)."""
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    ro, rd, bvh = spot_rays
    dev = ro.device
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    runs = torch.randint(1, 301, (400,), generator=g, device=dev)
    src = torch.randint(0, ro.shape[0], (400,), generator=g, device=dev)
    off = torch.rand((400,), generator=g, device=dev) < 1 / 3
    n = int(runs.sum()) // 1000 * 1000
    pick = torch.repeat_interleave(src, runs)[:n]
    dead = torch.repeat_interleave(off, runs)[:n, None]
    o = torch.where(dead, torch.full_like(ro[pick], 3e37), ro[pick])
    d = torch.where(dead, torch.zeros_like(rd[pick]), rd[pick])
    rayf = bvh_mod.ray_features(o.contiguous(), d.contiguous())
    lo = torch.cat([bvh.aabb_lo, torch.full((1, 3), 3e37, device=dev)])
    hi = torch.cat([bvh.aabb_hi, torch.full((1, 3), -3e37, device=dev)])
    r = checks.check_mask(rayf, lo.contiguous(), hi.contiguous(), 1000,
                          0.0, 1e16, reps=1)
    assert r['ok'], r


SCATTER_CHANNELS = [3, 4, 6, 9, 13, 5, 500]   # the instances, generic 5, 500


def _scatter_inputs(pattern, C, dev):
    """Seeded update rows of the named pattern for C channels."""
    rng = np.random.RandomState(C)
    M, V = (100003, 20000) if C < 100 else (4099, 300)
    idx = rng.randint(0, V, M)
    vals = rng.randn(M, C).astype(np.float32)
    if pattern == 'one_id':
        idx[:] = 77
    elif pattern == 'alternate':          # lanes alternate between two ids
        idx = np.where(np.arange(M) % 2 == 0, 11, 12)
    elif pattern == 'runs':               # the vertex adjoint's runs
        idx = np.repeat(rng.randint(0, V, (M // 48 + 1, 3)), 16,
                        0).reshape(-1)[:M]
    elif pattern == 'zero_rows':          # whole zero rows, some ids bad
        vals[rng.rand(M) < 0.7] = 0.0
        idx[rng.rand(M) < 0.05] = -3
        idx[rng.rand(M) < 0.05] = V + 9
    elif pattern == 'ragged':             # M not a multiple of 32 or 256
        idx, vals = idx[:M - 90], vals[:M - 90]
    idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    vals = torch.as_tensor(vals, device=dev)
    if pattern == 'unaligned':            # vals not 16-byte aligned
        buf = torch.empty(vals.numel() + 1, device=dev)
        buf[1:] = vals.reshape(-1)
        vals = buf[1:].reshape(M, C)
        assert vals.data_ptr() % 16
    return idx, vals, V


@pytest.mark.parametrize('pattern', ['random', 'one_id', 'alternate',
                                     'runs', 'zero_rows', 'ragged',
                                     'unaligned'])
@pytest.mark.parametrize('C', SCATTER_CHANNELS)
def test_scatter_instances_match_plain(C, pattern):
    """Every template instance of the row scatter (the step's channel
    counts) and the generic one (5; 500, wider than a warp's rows could
    be staged in shared memory) on every id equal, lanes alternating between two ids,
    runs of three ids, whole zero rows with ids out of range, a row count
    that is no multiple of the block, and unaligned values."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import checks, kernels
    kernels.build()
    idx, vals, V = _scatter_inputs(pattern, C, torch.device('cuda', 0))
    r = checks.check_scatter(idx, vals, V, reps=1)
    assert r['ok'], r


def test_scatter_hot_row_integers_exact():
    """Small integers on one row: every partial sum is exact in float32,
    so the grouped sums and the atomics must give the exact total."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_scatter
    kernels.build()
    M, C = 65536 + 17, 9
    vals = (torch.arange(M * C, device='cuda') % 7).float().reshape(M, C)
    idx = torch.full((M,), 5, dtype=torch.int64, device='cuda')
    got = pallas_scatter._scatter_cuda(idx, vals, 8).cpu()
    assert torch.equal(got[5], vals.sum(0).cpu())
    got[5] = 0.0
    assert float(got.abs().max()) == 0.0


def test_validation_render_launches():
    """render_eval past 256 strata runs the stratum loop: one sample and
    one trace launch per stratum, one resolve and one guide build, nothing
    else (64x64, n_samples 17)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import config, kernels, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import vecmath
    kernels.build()
    dev = torch.device('cuda', 0)
    mesh = spot256_scene(dev)
    FLAGS = config.make_flags(train_res=[64, 64], n_samples=2,
                              envlight=SPOT256_PROBE)
    ds = DatasetMesh(mesh, 3.0, FLAGS, validate=True)
    geometry = DLMesh(ds.ref_mesh, FLAGS)
    _, mvp, campos, res = ds._rotate_scene(3)
    target = {'mvp': torch.as_tensor(mvp, device=dev),
              'campos': torch.as_tensor(campos, device=dev),
              'resolution': res,
              'background': torch.as_tensor(vecmath.checkerboard(res, 8),
                                            device=dev)[None]}
    mat = mesh.material
    kernels.reset_launches()
    buf = train.render_eval(
        geometry, geometry.parameters(),
        {'kd': mat['kd'].data, 'ks': mat['ks'].data},
        {'bsdf': 'pbr', 'no_perturbed_nrm': False,
         'min_max': {'kd': None, 'ks': None}}, ds.envlight, target, FLAGS,
        n_samples=17)
    torch.cuda.synchronize()
    assert dict(kernels.LAUNCHES) == dict(
        {k: 0 for k in kernels.LAUNCHES}, sample=289, trace=289, resolve=1,
        sample_guide=1)
    assert all(bool(torch.isfinite(v).all()) for v in buf.values())
    assert float((buf['shaded'][..., 3] > 0).float().mean()) > 0.05


def test_walk_full_size():
    """Trace + shade on one 512x512 frame of the slice (n_samples 4) and
    the standalone tracer on the 2^21 bench rays, each against its plain
    version on the three-level structure of the spot mesh."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    import chip_smoke
    from nvdiffrecmc_tpu_torch import checks, kernels
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (DatasetMesh,
                                                            spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    kernels.build()
    dev = torch.device('cuda', 0)
    mesh = spot256_scene(dev)
    FLAGS = chip_smoke.flags(512, 4)
    ds = DatasetMesh(mesh, 3.0, FLAGS, seed=0)
    geometry = DLMesh(ds.ref_mesh, FLAGS)
    with torch.no_grad(), checks.Recorder() as rec:
        chip_smoke.render_frame(ds, geometry, mesh.material, FLAGS, 0, dev)
        torch.cuda.synchronize()
    samp, gb, bvh = rec.args['trace_shade'][:3]
    assert bvh.n_leaves == 207 and bvh.sub_lo.shape == (207 * 128 //
                                                        bvh.sub_size, 3)
    with torch.no_grad():
        r = checks.run('trace_shade', rec.args, reps=1)
        assert r['ok'] and r['agree'] == 1.0, r
        ro, rd, _ = chip_smoke.tracer_rays(mesh, 1 << 21, dev)
        r = checks.check_trace(ro, rd, bvh, reps=1)
    assert r['ok'] and r['agree'] == 1.0, r


def test_trace_grazing_rays(spot_rays):
    """Rays whose origin lies on a sub-box or leaf face with a zero (or
    negative zero) direction along its normal, and rays aimed at box
    corners and at points on leaf faces: the kernel equals the plain
    tracer on every ray (the same slab arithmetic, NaN of 0 * inf
    included)."""
    from nvdiffrecmc_tpu_torch import checks
    _, _, bvh = spot_rays
    g = torch.Generator(device=bvh.tri.device)
    g.manual_seed(3)
    dev = bvh.tri.device
    boxes = []
    for lo, hi in ((bvh.sub_lo, bvh.sub_hi), (bvh.aabb_lo, bvh.aabb_hi)):
        real = lo[:, 0] <= hi[:, 0]
        boxes.append((lo[real], hi[real]))
    ros, rds = [], []
    for lo, hi in boxes:
        n = lo.shape[0]
        u = torch.rand((n, 3), generator=g, device=dev)
        inner = lo + u * (hi - lo)
        for ax in range(3):
            for face in (lo, hi):
                for sign in (1.0, -1.0):
                    o = inner.clone()
                    o[:, ax] = face[:, ax]
                    o[:, (ax + 1) % 3] = lo[:, (ax + 1) % 3] - 0.5
                    d = torch.zeros_like(o)
                    d[:, (ax + 1) % 3] = 1.0
                    d[:, ax] = 0.0 * sign             # +0 and -0
                    ros.append(o)
                    rds.append(d)
        far = inner + torch.randn((n, 3), generator=g, device=dev)
        for target in (lo, hi, inner):
            ros.append(far)
            rds.append(target - far)
    ro = torch.cat(ros).contiguous()
    rd = torch.cat(rds).contiguous()
    r = checks.check_trace(ro, rd, bvh, reps=1)
    assert r['ok'] and r['agree'] == 1.0, r
    occ_share = float(r['compared_on'].split(', ')[1].split()[0])
    assert 0.0 < occ_share < 1.0


def test_trace_edge_rays_match_plain(spot_rays):
    """Rays aimed at the spot mesh's vertices and at points on its edges,
    from random points around them: their Plücker edge terms are ~0, so
    the ray's moment o x d decides them in its last bits, and the kernel
    equals the plain tracer on every ray only if both round the moment's
    products alike (tracer.cross)."""
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import spot256_scene
    _, _, bvh = spot_rays
    dev = bvh.tri.device
    mesh = spot256_scene(dev)
    v = mesh.v_pos[mesh.t_pos_idx.long()]              # [T, 3, 3]
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    targets = [v[:, 0], v[:, 1], v[:, 2]]
    for i, j in ((0, 1), (1, 2), (2, 0)):
        for t in (0.5, 0.25):
            targets.append(v[:, i] + t * (v[:, j] - v[:, i]))
    p = torch.cat(targets)
    ro = p + torch.randn(p.shape, generator=g, device=dev)
    rd = p - ro
    r = checks.check_trace(ro.contiguous(), rd.contiguous(), bvh, reps=1)
    assert r['ok'] and r['agree'] == 1.0, r


def test_walk_refuses_too_many_boxes():
    """8,000 one-triangle leaves and 1,000 supernodes need 288,000 bytes of
    shared memory, past the 227 KB of a block: both wrappers raise."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    from nvdiffrecmc_tpu_torch.ops import pallas_shade, pallas_tracer
    dev = torch.device('cuda', 0)
    rng = np.random.RandomState(5)
    v = torch.as_tensor(rng.randn(24000, 3).astype(np.float32), device=dev)
    tri = torch.arange(24000, dtype=torch.int32, device=dev).reshape(-1, 3)
    bvh = bvh_mod.build(v, tri, leaf_size=1)
    ro = torch.zeros((64, 3), device=dev)
    rd = torch.ones((64, 3), device=dev)
    with pytest.raises(ValueError, match='shared memory'):
        pallas_tracer.any_hit_pallas(ro, rd, bvh)
    with pytest.raises(ValueError, match='shared memory'):
        pallas_shade._trace_shade_cuda(torch.zeros((1, 16, 64), device=dev),
                                       torch.zeros((19, 64), device=dev),
                                       bvh, 0, 0.0)


def _sample_inputs(Hl, Wl, S, P, seed):
    """Seeded sample-kernel inputs: S strata of uniforms and cell ids at
    n_samples 4, G-buffer lobes (unit normals, view directions in their
    hemisphere, alpha in [0.0064, 1], p_diffuse in [0, 1]) and the tables
    of a random Hl x Wl light, 20% of its texels black."""
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    dev = torch.device('cuda', 0)
    rng = np.random.RandomState(seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    u8 = pallas_shade.make_uniforms(gen, 16, P, 4, device='cpu')[:S]
    n = rng.randn(P, 3)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wo = rng.randn(P, 3)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo *= np.sign((wo * n).sum(-1, keepdims=True))
    gb8 = np.concatenate([n.T, wo.T, rng.uniform(0.0064, 1.0, (1, P)),
                          rng.uniform(0.0, 1.0, (1, P))])
    base = rng.rand(Hl, Wl, 3).astype(np.float32)
    base[rng.rand(Hl, Wl) < 0.2] = 0.0
    base = torch.as_tensor(base, device=dev)
    t = light_mod.update_pdf(base)
    rows, cols = t.rows.contiguous(), t.cols.contiguous()
    return (u8.to(dev).contiguous(),
            torch.as_tensor(gb8.astype(np.float32), device=dev).contiguous(),
            rows, cols, pallas_shade.sample_guide(rows, cols),
            t.pdf.contiguous(), base, 4)


@pytest.mark.parametrize('Hl,Wl', [(37, 75), (1024, 2048)])
@pytest.mark.parametrize('S', [1, 16])
def test_sample_odd_lights(Hl, Wl, S):
    """The guide and sample kernels against their plain versions at odd
    light sizes: 37 x 75 (guide tables of odd lengths, rows not 16-byte
    aligned) and 1024 x 2048 (the 2k probe's size: 8 KB histograms), the
    sampler at 1 and 16 strata, on 4,133 pixels (a ragged last tile); two
    launches equal on every entry."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import checks, kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    kernels.build()
    args = _sample_inputs(Hl, Wl, S, 4133, seed=Hl + S)
    with torch.no_grad():
        r = checks.check_sample_guide(args[2], args[3], reps=1)
        assert r['ok'], r
        r = checks.check_sample(*args, reps=1)
        assert r['ok'], r
        one = pallas_shade._sample_cuda(*args)
        assert torch.equal(pallas_shade._sample_cuda(*args), one)


def _ragged_step_inputs(recorded_step, n2):
    """shade_bwd's recorded step inputs cut to P - 5 pixels (not a multiple
    of 32) and to n2 strata: the first stratum, or the recorded strata
    repeated up to n2."""
    samp, gb, vw, g6, bsdf = recorded_step['shade_bwd']
    m, _, P = samp.shape
    Q = P - 5
    reps = -(-n2 // m)
    samp = samp.repeat(reps, 1, 1)[:n2, :, :Q]
    vw = vw.repeat(reps, 1)[:n2]
    vw = torch.cat([vw[:, :Q], vw[:, P:P + Q]], 1)
    return (samp.contiguous(), gb[:, :Q].contiguous(), vw.contiguous(),
            g6[:, :Q].contiguous(), bsdf)


@pytest.mark.parametrize('n2', [1, 16, 256])
def test_shade_bwd_strata_over_warps(recorded_step, n2):
    """shade_bwd at 1 stratum (one busy warp of the block's 4), 16 (4 for
    each warp) and 256 (64 each), on P - 5 pixels: within the checks'
    tolerances of the plain version on covered pixels, and two launches
    equal on every entry (the warps' partial sums meet in a fixed
    order)."""
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    args = _ragged_step_inputs(recorded_step, n2)
    assert args[0].shape[2] % 32 != 0
    r = checks.check_shade_bwd(*args, reps=1)
    assert r['ok'], r
    dgb, drad = pallas_shade._shade_bwd_cuda(*args)
    dgb2, drad2 = pallas_shade._shade_bwd_cuda(*args)
    assert torch.equal(dgb, dgb2) and torch.equal(drad, drad2)
    covered = args[1][pallas_shade.GB_MASK] > 0
    assert float(dgb[:, ~covered].abs().max()) == 0.0
    assert float(drad[:, 0:6][:, :, ~covered].abs().max()) == 0.0


@pytest.mark.parametrize('H,W', [(1, 1), (33, 9), (511, 257)])
def test_denoise_repeats_exactly(H, W):
    """20 launches of the denoiser in each mode equal the first on every
    entry (run-dependent sums were seen in development variants)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from nvdiffrecmc_tpu_torch import kernels
    from nvdiffrecmc_tpu_torch.ops import pallas_denoise
    kernels.build()
    col6, nrm, zdz, g6 = _denoise_inputs(H, W, N=1, seed=H)
    for grad_mode, c in ((False, col6), (True, g6)):
        first = pallas_denoise._launch(c, nrm, zdz, 2.0, grad_mode)
        assert bool(torch.isfinite(first).all())
        for _ in range(19):
            assert torch.equal(
                pallas_denoise._launch(c, nrm, zdz, 2.0, grad_mode), first)
