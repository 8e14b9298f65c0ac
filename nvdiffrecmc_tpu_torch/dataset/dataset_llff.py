"""LLFF-style real-capture dataset (counterpart of
nvdiffrecmc_tpu/dataset/dataset_llff.py): `poses_bounds.npy` with an
`images/` and a `masks/` folder.  The 3x5 pose blocks [down right back |
t | (H W f)] become OpenGL camera-to-world matrices, each image gets its
vertical FOV from its focal length, the rig is recentred on the
least-squares focal point of the views, and each mask becomes the alpha
channel of its image.  Images and masks are 8-bit PNG or baseline JPEG,
read by texture.read_image (the port's own decoders; imageio in the JAX
package).  Items hold tensors on the dataset's device."""

import glob
import hashlib
import os

import numpy as np
import torch

from ..device import resolve
from ..ops import vecmath
from .dataset import Dataset
from ..render.texture import read_image
from .dataset_nerf import _decode_image

_IMG_EXTS = ('png', 'jpg', 'jpeg')

# sha256 of data/llff_spot_synth/ decoded: each view's image, then its
# mask, as uint8 [H, W, C] in file order.  imageio's decode gives it on the
# CPU (tests/test_torch_jpeg.py) and the port's decoder on the card
# (chip_smoke.py phase 18).
SPOT_SYNTH_SHA256 = ('c9800a413895fca57b670329204e898c'
                     'f0746e74349ba07f8613967936d853e9')


def _list_images(d):
    return [f for f in sorted(glob.glob(os.path.join(d, '*')))
            if f.lower().endswith(_IMG_EXTS)]


def _read_ldr(fn):
    return _decode_image(fn)


def _read_mask(fn):
    """A mask as float32 [H, W, C] in [0, 1] (no sRGB decode); a grayscale
    mask is [H, W, 1]."""
    return read_image(fn).astype(np.float32) / 255.0


def decoded_sha256(base_dir, reader=read_image):
    """sha256 of the capture at base_dir decoded by reader (a path ->
    uint8 [H, W] or [H, W, C] array): each view's image, then its mask, as
    uint8 [H, W, C] in file order."""
    h = hashlib.sha256()
    for pair in zip(_list_images(os.path.join(base_dir, 'images')),
                    _list_images(os.path.join(base_dir, 'masks'))):
        for fn in pair:
            a = np.asarray(reader(fn))
            h.update(np.ascontiguousarray(
                a[..., None] if a.ndim == 2 else a).tobytes())
    return h.hexdigest()


class DatasetLLFF(Dataset):
    """The views of one LLFF capture.  Its length is the number of views,
    or examples when given (indices wrap around the views)."""

    def __init__(self, base_dir, FLAGS, examples=None, device=None):
        self.FLAGS = FLAGS
        self.base_dir = base_dir
        self.examples = examples
        self.device = resolve(device)
        self.image_files = _list_images(os.path.join(base_dir, 'images'))
        self.mask_files = _list_images(os.path.join(base_dir, 'masks'))

        probe = _read_ldr(self.image_files[0])
        self.resolution = probe.shape[0:2]
        self.aspect = self.resolution[1] / self.resolution[0]

        raw = np.load(os.path.join(base_dir, 'poses_bounds.npy'))
        # per image a 3x5 block [R|t|hwf], flattened, then 2 depth bounds
        blocks = raw[:, :-2].reshape([-1, 3, 5]).astype(np.float32)
        n_views = blocks.shape[0]
        if len(self.image_files) != n_views or \
                len(self.mask_files) != n_views:
            raise ValueError('%s: %d poses, %d images, %d masks'
                             % (base_dir, n_views, len(self.image_files),
                                len(self.mask_files)))

        # LLFF's axes are [down, right, back]; OpenGL's camera columns are
        # [right, up, back] = [r, -d, b]
        rot_t = blocks[:, :, 0:4]                      # [n, 3, 4]
        c2w3 = np.concatenate([rot_t[:, :, 1:2], -rot_t[:, :, 0:1],
                               rot_t[:, :, 2:4]], axis=2)
        bottom = np.zeros((n_views, 1, 4), np.float32)
        bottom[:, 0, 3] = 1.0
        self.cam_to_world = np.concatenate([c2w3, bottom], axis=1)

        hwf = blocks[:, :, 4]                          # [n, 3] = (H, W, f)
        self.fovy = vecmath.focal_length_to_fovy(hwf[:, 2], hwf[:, 0])

        # put the least-squares intersection of the view rays (where the
        # rig looks) at the origin
        eyes = self.cam_to_world[:, :3, 3]
        gaze = -self.cam_to_world[:, :3, 2]
        pivot = vecmath.lines_focal(eyes, gaze)
        self.cam_to_world[:, :3, 3] -= pivot[None]
        print('DatasetLLFF: %d views at %dx%d, recentered by %s' % (
            n_views, self.resolution[1], self.resolution[0],
            np.array2string(-pivot, precision=3)))

        self._cameras = [self._camera(i) for i in range(n_views)]
        self._images = None
        if FLAGS['pre_load']:
            self._images = [self._image(i) for i in range(n_views)]

    def _camera(self, idx):
        """(mv, mvp, campos) of view idx as [1, ...] tensors, in the JAX
        package's numpy arithmetic."""
        proj = vecmath.perspective(self.fovy[idx], self.aspect,
                                   self.FLAGS['cam_near_far'][0],
                                   self.FLAGS['cam_near_far'][1])
        mv = np.linalg.inv(self.cam_to_world[idx])
        campos = self.cam_to_world[idx][:3, 3]
        mvp = proj @ mv
        return tuple(torch.as_tensor(a[None].astype(np.float32),
                                     device=self.device)
                     for a in (mv, mvp, campos))

    def _image(self, idx):
        rgb = _read_ldr(self.image_files[idx])
        alpha = _read_mask(self.mask_files[idx])
        img = np.concatenate((rgb[..., :3], alpha[..., 0:1]), axis=-1)
        return torch.as_tensor(img[None], device=self.device)

    def getMesh(self):
        return None

    def __len__(self):
        n = self.cam_to_world.shape[0]
        return n if self.examples is None else self.examples

    def __getitem__(self, itr):
        i = itr % self.cam_to_world.shape[0]
        img = (self._images[i] if self._images is not None
               else self._image(i))
        mv, mvp, campos = self._cameras[i]
        return {'mv': mv, 'mvp': mvp, 'campos': campos,
                'resolution': self.resolution, 'spp': self.FLAGS['spp'],
                'img': img}
