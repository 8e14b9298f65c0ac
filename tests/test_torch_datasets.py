"""The port's image datasets against the JAX package's on the CPU.

- DatasetNERF on the repo's data/nerf_synthetic_spot: mv, mvp and campos
  bit-equal to JAX's for every frame of each split (and past the last
  frame, where indices wrap); the images decoded by the port's reader
  within 1e-6 of JAX's imageio decode (sRGB to linear in the same float32
  arithmetic); pre_load and collate.
- DatasetLLFF on synthetic poses, images and masks written with the port's
  encode_png: the camera table, the recentring and every item within 1e-6.
- scale_img_nhwc's area minification at non-integer ratios within 1e-6.
- The refusals: a file that is not an image the port reads raises naming
  it, a progressive JPEG view of an LLFF capture raises naming it.
- train.main on a synthetic 24x24 NeRF folder, both passes at batch 2 in
  micro-batches of 1 (training at 16x16, so the targets take the
  non-integer area path): a run stopped after pass 1's checkpoint and
  resumed equals the uninterrupted one bit for bit."""

import json
import os

import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.dataset import DatasetLLFF as JLLFF
from nvdiffrecmc_tpu.dataset import DatasetNERF as JNERF
from nvdiffrecmc_tpu.ops import vecmath as j_vecmath
from nvdiffrecmc_tpu_torch import train
from nvdiffrecmc_tpu_torch.dataset import DatasetLLFF, DatasetNERF
from nvdiffrecmc_tpu_torch.dataset import dataset_nerf
from nvdiffrecmc_tpu_torch.ops import vecmath
from nvdiffrecmc_tpu_torch.render import texture as t_texture

NERF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'data', 'nerf_synthetic_spot')
FLAGS = {'pre_load': False, 'cam_near_far': [0.1, 1000.0],
         'train_res': [800, 800], 'spp': 1}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread keeps the parallel test workers off each
    other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split(name, **kw):
    path = os.path.join(NERF, 'transforms_%s.json' % name)
    return (JNERF(path, dict(FLAGS), **kw),
            DatasetNERF(path, dict(FLAGS), device='cpu', **kw))


@pytest.mark.parametrize('split', ['train', 'test', 'val'])
def test_nerf_cameras_match_jax(split):
    """Every frame's cameras bit-equal; an item's are its frame's, also
    past the end (the training set is (iter + 1) * batch examples long
    and wraps)."""
    want, got = _split(split, examples=None)
    n = got.n_images
    assert len(got) == len(want) == n
    assert tuple(got.resolution) == tuple(want.resolution) == (800, 800)
    for k in ('mv', 'mvp', 'campos'):
        a, b = getattr(want, '_' + k), getattr(got, '_' + k)
        assert b.dtype == torch.float32 and b.device.type == 'cpu'
        assert np.array_equal(b.numpy(), a), (split, k)
    jw, tw = _split(split, examples=n + 2)
    assert len(tw) == len(jw) == n + 2
    for i in (1, n + 1):
        a, b = jw[i], tw[i]
        for k in ('mv', 'mvp', 'campos'):
            assert b[k].shape == (1,) + a[k].shape[1:]
            assert np.array_equal(b[k].numpy(), a[k]), (split, i, k)
        assert b['resolution'] == a['resolution'] and b['spp'] == a['spp']


@pytest.mark.parametrize('split, frame', [('train', 0), ('train', 13),
                                          ('train', 29), ('test', 2)])
def test_nerf_image_matches_jax(split, frame):
    """One frame's RGBA image [1, 800, 800, 4] within 1e-6 of JAX's; colour
    linearized, alpha untouched (equal to the PNG's bytes / 255)."""
    want, got = _split(split)
    a, b = want[frame]['img'], got[frame]['img']
    assert b.shape == a.shape == (1, 800, 800, 4)
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)
    raw = t_texture.read_image(dataset_nerf._image_path(got._paths[frame]))
    assert np.array_equal(b[0, ..., 3].numpy(),
                          raw[..., 3].astype(np.float32) / np.float32(255))


def test_nerf_pre_load_and_collate():
    """With pre_load the test split's images are decoded at init and
    equal the ones decoded per item; a batch of two items (one past the
    end) collates as JAX's does, on the dataset's device, and prepare_batch
    takes it to 48x48 as JAX's does."""
    path = os.path.join(NERF, 'transforms_test.json')
    pre = DatasetNERF(path, dict(FLAGS, pre_load=True), examples=8,
                      device='cpu')
    lazy = DatasetNERF(path, dict(FLAGS), examples=8, device='cpu')
    jds = JNERF(path, dict(FLAGS), examples=8)
    assert len(pre._images) == 4
    for i in range(4):
        assert torch.equal(pre[i]['img'], lazy[i]['img'])
    got = pre.collate([pre[1], pre[6]])
    want = jds.collate([jds[1], jds[6]])
    assert set(got) == set(want)
    for k in ('mv', 'mvp', 'campos', 'img'):
        assert got[k].device.type == 'cpu' and got[k].shape[0] == 2
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-6, err_msg=k)
    assert got['resolution'] == want['resolution']
    assert got['spp'] == want['spp']
    import train as j_train
    jt = j_train.prepare_batch(want, (48, 48), 'black', None, FLAGS)
    tt = train.prepare_batch(got, (48, 48), 'black', None, FLAGS)
    for k in ('img', 'background', 'mvp', 'campos'):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]), rtol=0,
                                   atol=1e-6, err_msg=k)


def _rotation(rng):
    q, r = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.diag(r))[None]


def write_llff(folder, n=4, H=24, W=32, seed=1):
    """An LLFF capture of n views: poses_bounds.npy with seeded rotations,
    centres around (0.3, -0.2, 0.5) looking roughly at it, focal 30 px;
    RGB images and gray masks written with the port's encode_png."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(folder, 'images'))
    os.makedirs(os.path.join(folder, 'masks'))
    pb = np.zeros((n, 17))
    for i in range(n):
        for sub, shape in (('images', (H, W, 3)), ('masks', (H, W))):
            with open(os.path.join(folder, sub, 'im_%d.png' % i), 'wb') as f:
                f.write(t_texture.encode_png(
                    (rng.rand(*shape) * 255).astype(np.uint8)))
        R = _rotation(rng)
        t = np.array([0.3, -0.2, 0.5]) + 4.0 * R[:, 2]
        hwf = np.array([H, W, 30.0 + i])
        pb[i, :15] = np.concatenate([R, t[:, None], hwf[:, None]],
                                    axis=1).reshape(-1)
        pb[i, 15:] = [2.0, 6.0]
    np.save(os.path.join(folder, 'poses_bounds.npy'), pb)


def test_llff_matches_jax(tmp_path):
    """The camera table (column reorder, per-image fovy, recentring) and
    every item (mv, mvp, campos, the RGB image with the mask as alpha)
    within 1e-6 of JAX's, with and without pre_load."""
    folder = str(tmp_path / 'llff')
    write_llff(folder)
    F = {'pre_load': True, 'cam_near_far': [0.1, 1000.0], 'spp': 1}
    want = JLLFF(folder, F)
    got = DatasetLLFF(folder, F, device='cpu')
    lazy = DatasetLLFF(folder, dict(F, pre_load=False), examples=6,
                       device='cpu')
    np.testing.assert_allclose(got.cam_to_world, want.cam_to_world, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.fovy, want.fovy, rtol=0, atol=1e-6)
    assert len(got) == 4 and len(lazy) == 6
    for i in range(6):
        a = want[i % 4]
        for b in ((got[i % 4], lazy[i]) if i < 4 else (lazy[i],)):
            assert tuple(b['resolution']) == tuple(a['resolution']) == (24, 32)
            for k in ('mv', 'mvp', 'campos', 'img'):
                assert b[k].device.type == 'cpu'
                np.testing.assert_allclose(b[k].numpy(), a[k], rtol=0,
                                           atol=1e-6, err_msg=(i, k))
    # the recentring: the rig's focal point at the origin
    eyes, gaze = got.cam_to_world[:, :3, 3], -got.cam_to_world[:, :3, 2]
    np.testing.assert_allclose(vecmath.lines_focal(eyes, gaze), 0.0,
                               atol=1e-5)


def test_refuses_other_formats(tmp_path):
    """A frame that is not an image the port reads raises ValueError naming
    its file (no fallback decoder); an LLFF capture of progressive JPEG
    views raises ValueError naming the first."""
    from PIL import Image
    bad = tmp_path / 'r_0.png'
    bad.write_bytes(b'\xff\xd8\xff\xe0 not a png')
    with pytest.raises(ValueError, match='r_0.png'):
        dataset_nerf._decode_image(str(tmp_path / 'r_0'))
    folder = str(tmp_path / 'llff')
    write_llff(folder, n=2)
    for sub in ('images', 'masks'):
        for i in range(2):
            src = os.path.join(folder, sub, 'im_%d.png' % i)
            Image.fromarray(t_texture.read_image(src)[..., 0]).save(
                src[:-3] + 'jpg', 'JPEG', progressive=True)
            os.remove(src)
    with pytest.raises(ValueError, match='im_0.jpg.*progressive'):
        DatasetLLFF(folder, {'pre_load': True, 'cam_near_far': [0.1, 1e3],
                             'spp': 1}, device='cpu')


@pytest.mark.parametrize('shape, size', [
    ((1, 800, 800, 4), (48, 48)), ((2, 37, 53, 3), (16, 20)),
    ((1, 24, 24, 4), (16, 16)), ((1, 90, 70, 2), (33, 7))])
def test_scale_img_area_matches_jax(shape, size):
    """Area minification at non-integer ratios within 1e-6 of JAX's, and
    each output cell the mean of the input it covers: a constant image
    stays constant within 1e-5 (the overlap weights are float32 fractions
    that sum to one within their rounding)."""
    x = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    got = vecmath.scale_img_nhwc(torch.as_tensor(x), size).numpy()
    want = np.asarray(j_vecmath.scale_img_nhwc(x, size))
    assert got.shape == want.shape == (shape[0],) + size + (shape[3],)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ones = vecmath.scale_img_nhwc(torch.ones(shape), size)
    np.testing.assert_allclose(ones.numpy(), 1.0, rtol=0, atol=1e-5)


def _look_from(eye):
    """A NeRF camera-to-world (z-up world, OpenGL camera looking down -z)
    at eye, looking at the origin."""
    back = eye / np.linalg.norm(eye)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, back, eye
    return m


def write_nerf(folder, n_train=6, n_test=2, res=24, seed=4):
    """A NeRF folder: views at radius 3 around the origin, each image a
    seeded-colour disc (alpha 1) on alpha 0, RGBA PNG."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:res, 0:res]
    disc = ((yy - res / 2 + 0.5) ** 2 + (xx - res / 2 + 0.5) ** 2
            <= (res / 3) ** 2)
    for split, n in (('train', n_train), ('test', n_test)):
        os.makedirs(os.path.join(folder, split), exist_ok=True)
        frames = []
        for i in range(n):
            img = np.zeros((res, res, 4), np.uint8)
            img[disc, 0:3] = (rng.rand(3) * 255).astype(np.uint8)
            img[disc, 3] = 255
            with open(os.path.join(folder, split, 'r_%d.png' % i),
                      'wb') as f:
                f.write(t_texture.encode_png(img))
            a, e = rng.uniform(0, 2 * np.pi), rng.uniform(-0.6, 0.9)
            eye = 3.0 * np.array([np.cos(a) * np.cos(e),
                                  np.sin(a) * np.cos(e), np.sin(e)])
            frames.append({'file_path': './%s/r_%d' % (split, i),
                           'transform_matrix': _look_from(eye).tolist()})
        with open(os.path.join(folder, 'transforms_%s.json' % split),
                  'w') as f:
            json.dump({'camera_angle_x': 0.69, 'frames': frames}, f)


def nerf_argv(folder, *extra):
    """Both passes on write_nerf's folder: DMTet grid 8 (a sphere init),
    batch 2 in micro-batches of 1, 16x16 (the 24x24 images minified),
    32x32 textures, n_samples 2, a 16x16 trainable light, 4 iterations a
    pass, no probe and no validation."""
    data = os.path.join(folder, 'nerf')
    write_nerf(data)
    cfg = {'ref_mesh': data, 'random_textures': True, 'iter': 4,
           'save_interval': 0, 'texture_res': [32, 32], 'train_res': [16, 16],
           'batch': 2, 'micro_batch': 1, 'learning_rate': [0.03, 0.01],
           'dmtet_grid': 8, 'sdf_init': 'sphere', 'mesh_scale': 2.4,
           'validate': False, 'n_samples': 2, 'probe_res': 16,
           'display': [{'latlong': True}], 'background': 'white',
           'out_root': folder, 'out_dir': 'run'}
    fn = os.path.join(folder, 'config.json')
    with open(fn, 'w') as f:
        json.dump(cfg, f)
    return ['--config', fn] + list(extra)


class _Stop(Exception):
    pass


def test_main_nerf_two_pass_resume_is_bitwise(tmp_path, monkeypatch, capsys):
    """The NeRF folder through main: both passes at 2 micro-steps a step,
    a checkpoint every 2 iterations; the same run stopped right after pass
    1's checkpoint at iteration 2 and resumed equals the whole one bit for
    bit (pass 2's parameters and the baked OBJ); the checkpoint holds no
    dataset state."""
    whole = train.main(nerf_argv(str(tmp_path / 'a'),
                                 '--checkpoint-interval', '2'), device='cpu')
    out = capsys.readouterr().out
    assert 'DatasetNERF: 6 frames at 24x24' in out
    assert 'median' in out and 'per step of 2 micro-steps' in out
    argv = nerf_argv(str(tmp_path / 'b'), '--checkpoint-interval', '2')
    save = train.save_checkpoint

    def save_then_stop(path, it, **state):
        save(path, it, **state)
        if 'dmtet_pass1' in path:
            raise _Stop(it)
    monkeypatch.setattr(train, 'save_checkpoint', save_then_stop)
    with pytest.raises(_Stop):
        train.main(argv, device='cpu')
    monkeypatch.setattr(train, 'save_checkpoint', save)
    ckpt = torch.load(os.path.join(str(tmp_path / 'b'), 'run',
                                   'checkpoint_dmtet_pass1.pkl'),
                      weights_only=True)
    assert ckpt['dataset'] == {} and len(ckpt['batches']['order']) == 10
    resumed = train.main(argv, device='cpu')
    for group in ('geo', 'mat'):
        for k, v in whole[group].items():
            assert torch.equal(v, resumed[group][k]), (group, k)
    assert torch.equal(whole['light'], resumed['light'])
    objs = [open(os.path.join(str(tmp_path / d), 'run', 'dmtet_mesh',
                              'mesh.obj')).read() for d in 'ab']
    assert objs[0] == objs[1]
    assert sorted(os.listdir(os.path.join(str(tmp_path / 'a'), 'run',
                                          'mesh'))) == [
        'mesh.mtl', 'mesh.obj', 'probe.hdr', 'texture_kd.png',
        'texture_ks.png', 'texture_n.png']


def test_main_refuses_unknown_folders(tmp_path):
    """A ref_mesh folder with neither poses_bounds.npy nor
    transforms_train.json raises AssertionError, as JAX's main does."""
    FLAGS_ = {'ref_mesh': str(tmp_path), 'data_root': '.', 'iter': 1,
              'batch': 1}
    with pytest.raises(AssertionError, match='Invalid dataset format'):
        train.make_datasets(FLAGS_, torch.device('cpu'))
