"""The port's JPEG decoder and the LLFF path on JPEG captures, on the CPU.

- decode_jpeg against imageio.v2.imread on JPEGs that PIL writes from
  seeded numpy images: 4:4:4, 4:2:2 and 4:2:0 at qualities 50 and 95,
  grayscale, odd sizes (37x53, 17x3), rows of at most 2 chroma samples (box
  upsampling), restart intervals, optimized Huffman tables, and EXIF
  orientation (ignored, as imageio ignores it).  Tolerance: equal on every
  pixel in every case (the decoder computes as libjpeg-turbo's defaults
  do).  4:4:0 is not covered: PIL cannot write it.
- Every file the decoder does not read raises ValueError naming it:
  progressive, 12-bit, arithmetic-coded and lossless (frame headers of a
  baseline file patched, since PIL writes none of these), CMYK, and
  truncated data.
- read_image picks the decoder by signature (a PNG named .jpg, a JPEG
  named .png).
- The committed scene data/llff_spot_synth/: the decoded scene's sha256
  equals the port's constant under imageio's decode and the port's;
  JAX's DatasetLLFF against the port's (cameras within 1e-6, every
  item's image within 1e-6 after the sRGB linearisation: the decodes are
  equal); its cameras before the rig's recentring equal DatasetNERF's for
  the same views of data/nerf_synthetic_spot.
- A JPEG map_Kd through load_mtl against JAX's.
- The slice as a whole: train.main on a tiny JPEG LLFF capture with
  configs/nerd_gold.json's keys (grid 8, 16x16, n_samples 2, 2 iterations
  a pass, no validation): both passes to the export, every loss finite.
  It is not held to JAX's main, whose initial draws the port cannot
  reproduce."""

import io
import json
import os
import re

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from nvdiffrecmc_tpu.dataset import DatasetLLFF as JLLFF
from nvdiffrecmc_tpu.render import material as j_material
from nvdiffrecmc_tpu_torch import train
from nvdiffrecmc_tpu_torch.dataset import DatasetLLFF, DatasetNERF
from nvdiffrecmc_tpu_torch.dataset import dataset_llff
from nvdiffrecmc_tpu_torch.jpeg import decode_jpeg
from nvdiffrecmc_tpu_torch.render import material as t_material
from nvdiffrecmc_tpu_torch.render import texture as t_texture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, 'data', 'llff_spot_synth')
NERF = os.path.join(REPO, 'data', 'nerf_synthetic_spot')
F = {'pre_load': False, 'cam_near_far': [0.1, 1000.0], 'spp': 1}


def _image(h, w, c, seed):
    """A seeded image with smooth regions and noise (uint8 [h, w, c])."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 4 + 2, w // 4 + 2, c)
    x = np.kron(coarse, np.ones((4, 4, 1)))[:h, :w] + 0.25 * rng.rand(h, w, c)
    return np.clip(x * 200, 0, 255).astype(np.uint8)


def _jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img).save(
        buf, 'JPEG', **kw)
    return buf.getvalue()


def _imageio(data):
    a = np.asarray(imageio.imread(io.BytesIO(data)))
    return a[..., None] if a.ndim == 2 else a


CASES = {
    '444_q50': ((37, 53, 3), dict(subsampling=0, quality=50)),
    '444_q95': ((37, 53, 3), dict(subsampling=0, quality=95)),
    '422_q50': ((37, 53, 3), dict(subsampling=1, quality=50)),
    '422_q95': ((64, 48, 3), dict(subsampling=1, quality=95)),
    '420_q50': ((37, 53, 3), dict(subsampling=2, quality=50)),
    '420_q95': ((600, 800, 3), dict(subsampling=2, quality=95)),
    '420_narrow': ((17, 3, 3), dict(subsampling=2, quality=90)),
    '422_narrow': ((5, 4, 3), dict(subsampling=1, quality=90)),
    'gray': ((37, 53, 1), dict(quality=90)),
    'gray_restart': ((37, 53, 1), dict(quality=75, restart_marker_blocks=5)),
    '420_restart_blocks': ((37, 53, 3), dict(subsampling=2, quality=90,
                                             restart_marker_blocks=3)),
    '422_restart_rows': ((45, 70, 3), dict(subsampling=1, quality=90,
                                           restart_marker_rows=1)),
    '420_optimized': ((120, 161, 3), dict(subsampling=2, quality=80,
                                          optimize=True)),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_decode_matches_imageio(case):
    """Every pixel equal to imageio's decode of the same bytes."""
    shape, kw = CASES[case]
    data = _jpeg(_image(*shape, seed=len(case)), **kw)
    want = _imageio(data)
    got = decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape == shape
    np.testing.assert_array_equal(got, want)


def test_exif_orientation_is_ignored():
    """A 40x64 file tagged Orientation 6 reads back as 40x64, as imageio
    reads it."""
    exif = Image.Exif()
    exif[0x0112] = 6
    data = _jpeg(_image(40, 64, 3, seed=3), quality=90, exif=exif.tobytes())
    got = decode_jpeg(data)
    assert got.shape == (40, 64, 3)
    np.testing.assert_array_equal(got, _imageio(data))


def _patched(marker=None, precision=None):
    """A baseline 4:2:0 file with its SOF0 marker or precision patched."""
    data = bytearray(_jpeg(_image(24, 32, 3, seed=5), quality=90))
    i = data.index(b'\xff\xc0')
    if marker is not None:
        data[i + 1] = marker
    if precision is not None:
        data[i + 4] = precision
    return bytes(data)


def _unsupported(kind):
    img = _image(24, 32, 3, seed=7)
    if kind == 'progressive':
        return _jpeg(img, quality=90, progressive=True)
    if kind == 'cmyk':
        buf = io.BytesIO()
        Image.fromarray(img).convert('CMYK').save(buf, 'JPEG', quality=90)
        return buf.getvalue()
    if kind == '12-bit':
        return _patched(precision=12)
    if kind == 'arithmetic':
        return _patched(marker=0xC9)
    if kind == 'lossless':
        return _patched(marker=0xC3)
    if kind == 'bad_huffman':
        # the first DHT's 3-bit codes moved to length 1: three codes of
        # one bit, as many values as before
        data = bytearray(_jpeg(img, quality=90))
        bits = data.index(b'\xff\xc4') + 5        # bits[1..16]
        assert data[bits + 2] >= 3
        data[bits] += 3
        data[bits + 2] -= 3
        return bytes(data)
    data = _jpeg(img, quality=90)
    return data[:len(data) // 2] if kind == 'truncated' else data[:-2]


@pytest.mark.parametrize('kind, says', [
    ('progressive', 'progressive'), ('cmyk', 'CMYK'), ('12-bit', '12-bit'),
    ('arithmetic', 'arithmetic'), ('lossless', 'lossless'),
    ('truncated', 'truncated'), ('no_eoi', 'truncated'),
    ('bad_huffman', 'over-subscribed')])
def test_unsupported_files_raise_naming_the_file(tmp_path, kind, says):
    """ValueError naming the file, with the reason; no fallback decoder."""
    fn = str(tmp_path / ('%s.jpg' % kind))
    with open(fn, 'wb') as f:
        f.write(_unsupported(kind))
    with pytest.raises(ValueError, match=r'%s\.jpg: .*%s' % (kind, says)):
        t_texture.read_image(fn)


def test_read_image_picks_the_decoder_by_signature(tmp_path):
    """A PNG named .jpg and a JPEG named .png read as what they are; a
    file of neither kind raises naming it."""
    img = _image(21, 30, 3, seed=9)
    png_as_jpg = tmp_path / 'a.jpg'
    png_as_jpg.write_bytes(t_texture.encode_png(img))
    np.testing.assert_array_equal(t_texture.read_image(str(png_as_jpg)), img)
    data = _jpeg(img, quality=90)
    jpg_as_png = tmp_path / 'b.png'
    jpg_as_png.write_bytes(data)
    np.testing.assert_array_equal(t_texture.read_image(str(jpg_as_png)),
                                  _imageio(data))
    other = tmp_path / 'c.png'
    other.write_bytes(b'GIF89a')
    with pytest.raises(ValueError, match='c.png'):
        t_texture.read_image(str(other))


def test_scene_sha256_under_both_decoders():
    """The committed scene decoded by imageio and by the port hashes to the
    port's constant (chip_smoke.py phase 18 checks the card's build
    against it)."""
    assert dataset_llff.decoded_sha256(SCENE, imageio.imread) == \
        dataset_llff.SPOT_SYNTH_SHA256
    assert dataset_llff.decoded_sha256(SCENE) == \
        dataset_llff.SPOT_SYNTH_SHA256


def test_scene_matches_jax_dataset_llff():
    """Cameras, fovy and every item (mv, mvp, campos, the image with its
    mask as alpha) within 1e-6 of JAX's; 24 views at 800x600, grayscale
    masks as one alpha channel."""
    want = JLLFF(SCENE, dict(F))
    got = DatasetLLFF(SCENE, dict(F), device='cpu')
    assert len(got) == len(want) == 24
    assert tuple(got.resolution) == tuple(want.resolution) == (600, 800)
    np.testing.assert_allclose(got.cam_to_world, want.cam_to_world, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.fovy, want.fovy, rtol=0, atol=1e-6)
    for i in range(len(want)):
        a, b = want[i], got[i]
        assert b['img'].shape == a['img'].shape == (1, 600, 800, 4)
        np.testing.assert_allclose(b['img'].numpy(), a['img'], rtol=0,
                                   atol=1e-6)
        for k in ('mv', 'mvp', 'campos'):
            np.testing.assert_allclose(b[k].numpy(), a[k], rtol=0,
                                       atol=1e-6)


def test_scene_cameras_are_the_nerf_scene_cameras():
    """Before the rig's recentring, each view's camera-to-world is the
    NeRF scene's for the same training view (the world fix folded in),
    and its vertical FOV is the 600-row crop's at the NeRF focal length;
    the recentring moves every view by one vector."""
    llff = DatasetLLFF(SCENE, dict(F), device='cpu')
    nerf = DatasetNERF(os.path.join(NERF, 'transforms_train.json'), dict(F),
                       device='cpu')
    c2w = np.linalg.inv(nerf._mv.numpy()[:24].astype(np.float64))
    np.testing.assert_allclose(llff.cam_to_world[:, :3, :3], c2w[:, :3, :3],
                               rtol=0, atol=1e-6)
    shift = c2w[:, :3, 3] - llff.cam_to_world[:, :3, 3]
    np.testing.assert_allclose(shift, np.broadcast_to(shift[0], shift.shape),
                               rtol=0, atol=1e-5)
    with open(os.path.join(NERF, 'transforms_train.json')) as f:
        fovx = json.load(f)['camera_angle_x']
    focal = 400.0 / np.tan(0.5 * fovx)
    np.testing.assert_allclose(llff.fovy, 2 * np.arctan(300.0 / focal),
                               rtol=1e-6)


def test_jpeg_map_kd_matches_jax(tmp_path):
    """An MTL whose map_Kd is a JPEG loads as JAX's does (kd through sRGB
    to linear) within 1e-6."""
    data = _jpeg(_image(24, 40, 3, seed=11), quality=90, subsampling=2)
    (tmp_path / 'kd.jpg').write_bytes(data)
    mtl = tmp_path / 'm.mtl'
    mtl.write_text('newmtl m\nbsdf pbr\nmap_Kd kd.jpg\nKs 0 0.5 0\n')
    want = j_material.load_mtl(str(mtl))[0]['kd'].data
    got = t_material.load_mtl(str(mtl), device='cpu')[0]['kd'].data
    assert tuple(got.shape) == tuple(want.shape) == (1, 24, 40, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def write_jpeg_llff(folder, n=4, H=24, W=32):
    """A tiny LLFF capture of JPEG views: seeded images, a disc mask, eyes
    on a ring at distance 3 looking at the origin, focal 30 px."""
    for sub in ('images', 'masks'):
        os.makedirs(os.path.join(folder, sub))
    yy, xx = np.mgrid[0:H, 0:W]
    disc = (((yy - H / 2) ** 2 + (xx - W / 2) ** 2) < (H / 3) ** 2) * 255
    rows = []
    for i in range(n):
        Image.fromarray(_image(H, W, 3, seed=20 + i)).save(
            os.path.join(folder, 'images', 'v_%d.jpg' % i), 'JPEG',
            quality=90)
        Image.fromarray(disc.astype(np.uint8)).save(
            os.path.join(folder, 'masks', 'v_%d.jpg' % i), 'JPEG',
            quality=90)
        a = 2 * np.pi * i / n
        back = np.array([np.cos(a), 0.3, np.sin(a)])
        back /= np.linalg.norm(back)
        right = np.cross([0.0, 1.0, 0.0], back)
        right /= np.linalg.norm(right)
        up = np.cross(back, right)
        block = np.stack([-up, right, back, 3.0 * back, [H, W, 30.0]], 1)
        rows.append(np.concatenate([block.reshape(-1), [1.5, 4.5]]))
    np.save(os.path.join(folder, 'poses_bounds.npy'), np.stack(rows))


def nerd_argv(folder):
    """configs/nerd_gold.json's keys on write_jpeg_llff's capture in folder
    (DMTet grid 8, a sphere init, batch 2, 16x16, 32x32 textures,
    n_samples 2, a 16x16 light, 2 iterations a pass, no probe, no
    validation), written into folder; the program's argv."""
    data = os.path.join(folder, 'llff')
    write_jpeg_llff(data)
    with open(os.path.join(REPO, 'configs', 'nerd_gold.json')) as f:
        cfg = json.load(f)
    cfg.update(ref_mesh=data, iter=2, save_interval=0, batch=2,
               texture_res=[32, 32], train_res=[16, 16], dmtet_grid=8,
               sdf_init='sphere', validate=False, n_samples=2, probe_res=16,
               out_root=folder, out_dir='run')
    fn = os.path.join(folder, 'config.json')
    with open(fn, 'w') as f:
        json.dump(cfg, f)
    return ['--config', fn]


def test_main_runs_nerd_gold_keys_on_a_jpeg_capture(tmp_path, capsys):
    """nerd_argv's run: both passes run to the export, every logged loss
    finite."""
    train.main(nerd_argv(str(tmp_path)), device='cpu')
    out = capsys.readouterr().out
    assert 'DatasetLLFF: 4 views at 32x24' in out
    losses = [float(x) for x in re.findall(r'_loss=([-+\w.]+)', out)]
    assert len(losses) == 4 and all(np.isfinite(losses)), losses
    run = os.path.join(str(tmp_path), 'run')
    for d in ('dmtet_mesh', 'mesh'):
        assert os.path.isfile(os.path.join(run, d, 'mesh.obj')), d
    assert torch.isfinite(t_texture.load_texture2D(
        os.path.join(run, 'mesh', 'texture_kd.png'), device='cpu').data).all()
