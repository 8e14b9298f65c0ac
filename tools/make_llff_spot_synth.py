"""Write data/llff_spot_synth/, an LLFF capture (images/*.jpg, masks/*.jpg,
poses_bounds.npy) made from the NeRF scene data/nerf_synthetic_spot/.

The LLFF path (configs/nerd_gold.json: NeRD's moldGoldCape, JPEG images and
masks) needs a scene in the repository, and no real capture is in it.  So
this script re-packs the NeRF scene's first 24 training views as LLFF
stores a capture:
- each 800x800 RGBA frame is cropped to rows 100-699 (800 wide, 600 high;
  the crop keeps the focal length and the principal point, so the cameras
  stay exact, and some views cut the object at the border, as real
  captures do), composited over a constant grey (the mask, not the image,
  carries the silhouette) and written as a baseline 4:2:0 JPEG at quality
  90;
- its alpha channel is written as a grayscale JPEG mask at quality 90;
- poses_bounds.npy holds per view the 3x5 block [-up, right, back | t |
  (H W f)] of the camera-to-world matrix in the renderer's y-up world
  (the NeRF world fix rotate_x(-pi/2) of DatasetNERF folded in, so the
  scene sits y-up as the NeRF scene does), then two depth bounds.

It needs PIL, so it runs only where PIL is installed; the port never
imports it (the port reads the files with its own decoder).

Usage: python tools/make_llff_spot_synth.py [--src data/nerf_synthetic_spot]
       [--out data/llff_spot_synth] [--views 24]
"""

import argparse
import json
import os

import numpy as np
from PIL import Image

ROWS = (100, 700)     # the crop: 600 of the 800 rows, centred
GREY = 128
QUALITY = 90


def rotate_x(a):
    """The renderer's x rotation (vecmath.rotate_x of both packages)."""
    s, c = np.sin(a), np.cos(a)
    return np.array([[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0],
                     [0, 0, 0, 1]], np.float64)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--src', default=os.path.join('data',
                                                  'nerf_synthetic_spot'))
    ap.add_argument('--out', default=os.path.join('data', 'llff_spot_synth'))
    ap.add_argument('--views', type=int, default=24)
    args = ap.parse_args()

    with open(os.path.join(args.src, 'transforms_train.json')) as f:
        meta = json.load(f)
    frames = meta['frames'][:args.views]
    for sub in ('images', 'masks'):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
    world_fix_inv = np.linalg.inv(rotate_x(-np.pi / 2))
    rows = []
    for i, fr in enumerate(frames):
        rgba = np.asarray(Image.open(os.path.join(
            args.src, fr['file_path'] + '.png')).convert('RGBA'))
        H0, W0 = rgba.shape[:2]
        crop = rgba[ROWS[0]:ROWS[1]].astype(np.float64)
        alpha = crop[..., 3:4] / 255.0
        rgb = np.rint(crop[..., :3] * alpha + GREY * (1.0 - alpha))
        name = 'v_%03d.jpg' % i
        Image.fromarray(rgb.astype(np.uint8)).save(
            os.path.join(args.out, 'images', name), 'JPEG',
            quality=QUALITY, subsampling=2)
        Image.fromarray(crop[..., 3].astype(np.uint8)).save(
            os.path.join(args.out, 'masks', name), 'JPEG', quality=QUALITY)

        c2w = world_fix_inv @ np.array(fr['transform_matrix'], np.float64)
        right, up, back, t = (c2w[:3, k] for k in range(4))
        focal = 0.5 * W0 / np.tan(0.5 * meta['camera_angle_x'])
        hwf = np.array([ROWS[1] - ROWS[0], W0, focal])
        block = np.stack([-up, right, back, t, hwf], axis=1)     # [3, 5]
        dist = np.linalg.norm(t)
        rows.append(np.concatenate([block.reshape(-1),
                                    [dist - 1.5, dist + 1.5]]))
    np.save(os.path.join(args.out, 'poses_bounds.npy'), np.stack(rows))
    print('%s: %d views at %dx%d' % (args.out, len(frames), W0,
                                     ROWS[1] - ROWS[0]))


if __name__ == '__main__':
    main()
