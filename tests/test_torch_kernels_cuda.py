"""The port's CUDA kernels against their plain PyTorch versions on the card
(the checks of chip_smoke.py phase 3, on smaller frames of the same
scene: the slice's settings at 256x256, and a ragged two-camera frame).
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
    assert dict(kernels.LAUNCHES) == {k: 1 for k in kernels.LAUNCHES}
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
