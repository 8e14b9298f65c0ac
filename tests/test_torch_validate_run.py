"""The port's validation loop at a small size: train.validate over two
views of DatasetMesh's orbit at 24x24 (render_eval at n_samples 32, the
stratum loop, on the CPU) writes metrics.txt in the JAX package's line
formats and one PNG per view and image, and returns the average PSNR."""

import os
import re

import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import vecmath as j_vecmath
from nvdiffrecmc_tpu_torch import config, convert, train
from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import DatasetMesh
from nvdiffrecmc_tpu_torch.geometry.dlmesh import DLMesh as TDLMesh
from nvdiffrecmc_tpu_torch.render import texture as t_texture
from test_torch_validate import _scene


@pytest.fixture(autouse=True)
def _one_thread():
    """The stratum loop runs a few hundred small PyTorch ops per stratum;
    with one intra-op thread they do not oversubscribe the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_validate_writes_metrics_and_images(tmp_path):
    m, _, _, _ = _scene(sub=2)        # 128 triangles: one leaf
    FLAGS = config.make_flags(train_res=[24, 24], n_samples=2, iter=2,
                              envlight=None)
    tmesh = convert.mesh(m, device='cpu')
    ds = DatasetMesh(tmesh, 3.0, FLAGS, validate=True,
                     num_validation_frames=8)
    geometry = TDLMesh(ds.ref_mesh, FLAGS)
    mat = tmesh.material
    mat_params = {'kd': mat['kd'].data, 'ks': mat['ks'].data}
    mat_static = {'kind': 'tex', 'bsdf': 'pbr', 'no_perturbed_nrm': False,
                  'min_max': {'kd': None, 'ks': None}}
    out = str(tmp_path / 'validate')
    psnr = train.validate(geometry, geometry.parameters(), mat_params,
                          mat_static, ds.envlight, ds, out, FLAGS,
                          max_frames=2)
    assert np.isfinite(psnr) and psnr > 10.0
    names = sorted(os.listdir(out))
    assert names == ['metrics.txt', 'val_000000_opt.png',
                     'val_000000_ref.png', 'val_000001_opt.png',
                     'val_000001_ref.png']
    lines = open(os.path.join(out, 'metrics.txt')).read().splitlines(True)
    assert lines[0] == 'ID, MSE, PSNR\n'
    psnrs = []
    for it, line in enumerate(lines[1:3]):
        # JAX's "%d, %1.8f, %1.8f \n"; the PSNR is JAX's of the MSE (to the
        # 8-decimal rounding of the printed MSE: ~4e-8 / MSE dB)
        hit = re.match(r'^(\d+), (\d\.\d{8}), (\d+\.\d{8}) \n$', line)
        assert hit and int(hit.group(1)) == it, line
        mse, p = float(hit.group(2)), float(hit.group(3))
        assert abs(p - float(j_vecmath.mse_to_psnr(mse))) < 1e-4
        psnrs.append(p)
    hit = re.match(r'^AVERAGES: (\d\.\d{4}), (\d+\.\d{3})\n$', lines[3])
    assert hit and abs(float(hit.group(2)) - psnr) < 1e-3
    assert abs(psnr - np.mean(psnrs)) < 1e-6
    with open(os.path.join(out, 'val_000001_opt.png'), 'rb') as f:
        assert t_texture.decode_png(f.read()).shape == (24, 24, 3)
