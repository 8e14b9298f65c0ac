"""The port's CUDA kernels against their plain PyTorch versions on the card
(the checks of chip_smoke.py phases 3 and 6, on smaller frames of the same
scene: the slice's settings at 256x256, and a ragged two-camera frame;
the backward kernels on the inputs of one training step at each, and the
light scatter with every ray on one texel).
Marked `gpu`; skipped where torch.cuda.is_available() is false.  On a machine with a GPU and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

# (height, width, batch, n_samples, bsdf): the slice's settings at 256^2,
# and a ragged frame (sizes not multiples of the 32-pixel tiles or the
# 16-pixel denoiser blocks, two cameras, 9 strata, Lambert only)
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


@pytest.mark.parametrize('name', ['resolve', 'sample', 'trace_shade',
                                  'denoise'])
def test_kernel_matches_plain(recorded, name):
    from nvdiffrecmc_tpu_torch import checks
    with torch.no_grad():
        r = checks.run(name, recorded, reps=1)
    assert r['ok'], r


def test_resolve_peel_layer_matches_plain(recorded):
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import pallas_raster
    coef, bbox, H, W, pz, pid = recorded['resolve']
    z1, tid1 = pallas_raster._resolve_cuda(coef, bbox, H, W, pz, pid)
    pz2 = torch.where(tid1 > 0, z1, torch.full_like(z1, 1e30)).contiguous()
    r = checks.check_resolve(coef, bbox, H, W, pz2, tid1, reps=1)
    assert r['ok'], r
    assert float((tid1 > 0).float().mean()) > 0.05


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
