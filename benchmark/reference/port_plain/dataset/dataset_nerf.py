"""NeRF-synthetic dataset (counterpart of
nvdiffrecmc_tpu/dataset/dataset_nerf.py): `transforms_{train,test,val}.json`
and one 8-bit PNG per frame.  The camera table is built at init in numpy,
vectorized as the JAX package builds it (the -90 degree x-rotation of the
NeRF world frame, fovx -> fovy, cam_near_far); the images are decoded by
the port's own reader (texture.read_image: 8-bit PNG or baseline JPEG,
by signature), their colour taken from sRGB to linear, alpha left as it
is.  Items hold tensors on the dataset's device; with pre_load
every image is decoded once at init and held there."""

import glob
import json
import os

import numpy as np
import torch

from ..device import resolve
from ..ops import vecmath
from ..render import texture as texture_mod
from .dataset import Dataset


def _image_path(stem):
    """stem itself when it is a file, else the first file of stem.*."""
    if os.path.isfile(stem):
        return stem
    candidates = [c for c in glob.glob(glob.escape(stem) + '.*')
                  if os.path.isfile(c)]
    if not candidates:
        raise FileNotFoundError('no image matches %r' % stem)
    return candidates[0]


def _decode_image(stem):
    """The image at stem (an exact path, or any extension of it) as float32
    [H, W, C] numpy: colour channels from sRGB to linear, alpha as it is,
    in the JAX package's float32 arithmetic."""
    raw = texture_mod.read_image(_image_path(stem))
    x = raw.astype(np.float32) / np.float32(255)
    lo = x[..., :3] / 12.92
    hi = ((np.maximum(x[..., :3], 0.04045) + 0.055) / 1.055) ** 2.4
    x[..., :3] = np.where(x[..., :3] <= 0.04045, lo, hi)
    return x


class DatasetNERF(Dataset):
    """One transforms_*.json split.  Its length is the number of frames, or
    examples when given (indices wrap around the frames)."""

    def __init__(self, cfg_path, FLAGS, examples=None, device=None):
        self.FLAGS = FLAGS
        self.examples = examples
        self.device = resolve(device)
        root = os.path.dirname(cfg_path)
        with open(cfg_path) as f:
            meta = json.load(f)

        self._paths = [os.path.join(root, fr['file_path'])
                       for fr in meta['frames']]
        self.n_images = len(self._paths)

        probe = _decode_image(self._paths[0])
        self.resolution = probe.shape[:2]
        self.aspect = self.resolution[1] / self.resolution[0]
        print('DatasetNERF: %d frames at %dx%d from %s'
              % (self.n_images, self.resolution[1], self.resolution[0],
                 cfg_path))

        # NeRF stores camera-to-world in a z-up world; the renderer wants a
        # y-up modelview, so a -90 degree world x-rotation goes into each mv
        c2w = np.array([fr['transform_matrix'] for fr in meta['frames']],
                       np.float32)                           # [N, 4, 4]
        world_fix = vecmath.rotate_x(-np.pi / 2).astype(np.float32)
        mv = np.linalg.inv(c2w) @ world_fix[None]
        fovy = vecmath.fovx_to_fovy(meta['camera_angle_x'], self.aspect)
        near, far = FLAGS['cam_near_far']
        proj = vecmath.perspective(fovy, self.aspect, near, far)
        mvp = (proj[None].astype(np.float32) @ mv).astype(np.float32)
        campos = np.linalg.inv(mv)[:, :3, 3].astype(np.float32)
        self._mv, self._mvp, self._campos = (
            torch.as_tensor(a, device=self.device) for a in (mv, mvp, campos))

        self._images = None
        if FLAGS['pre_load']:
            self._images = [self._to_device(probe)] + [
                self._to_device(_decode_image(p)) for p in self._paths[1:]]

    def _to_device(self, img):
        return torch.as_tensor(img, device=self.device)

    def getMesh(self):
        return None     # supervised by images: no reference geometry

    def __len__(self):
        return self.n_images if self.examples is None else self.examples

    def __getitem__(self, itr):
        i = itr % self.n_images
        img = (self._images[i] if self._images is not None
               else self._to_device(_decode_image(self._paths[i])))
        return {
            'mv': self._mv[i][None],
            'mvp': self._mvp[i][None],
            'campos': self._campos[i][None],
            'resolution': self.FLAGS['train_res'],
            'spp': self.FLAGS['spp'],
            'img': img[None],
        }
