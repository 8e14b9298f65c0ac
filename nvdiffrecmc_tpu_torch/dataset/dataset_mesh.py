"""Synthetic-supervision dataset (counterpart of
nvdiffrecmc_tpu/dataset/dataset_mesh.py): random cameras around a reference
mesh lit by an HDR probe, with ground truth rendered by the same renderer.
Also the textured spot scene built from the repo's own assets."""

import os

import numpy as np
import torch

from .. import tracing
from ..device import resolve, upload
from ..ops import bvh as bvh_mod
from ..ops import envshade
from ..ops import vecmath
from ..render import light as light_mod
from ..render import mesh as mesh_mod
from ..render import obj as obj_mod
from ..render import render as render_mod
from ..render import texture as texture_mod
from .dataset import Dataset, rng_state, set_rng_state

SPOT256_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'docs', 'quality_r5', 'spot256')
SPOT256_PROBE = os.path.join(SPOT256_DIR, 'probe.hdr')   # 512 x 1024


def procedural_env(res_h=256, res_w=512, device=None):
    """Deterministic sky+sun probe [res_h, res_w, 3]."""
    device = resolve(device)
    ys = (np.arange(res_h) + 0.5) / res_h
    sky = np.stack([
        0.25 + 0.45 * (1 - ys), 0.32 + 0.4 * (1 - ys), 0.5 + 0.35 * (1 - ys)
    ], axis=-1)[:, None, :].repeat(res_w, axis=1)
    ground = np.array([0.18, 0.15, 0.12])
    img = np.where(ys[:, None, None] > 0.55, ground[None, None, :], sky)
    cy, cx = int(res_h * 0.22), int(res_w * 0.3)
    yy, xx = np.mgrid[0:res_h, 0:res_w]
    d2 = ((yy - cy) / (res_h * 0.015)) ** 2 + ((xx - cx) / (res_w * 0.0075)) ** 2
    img = img + np.exp(-d2)[..., None] * np.array([60.0, 55.0, 45.0])
    return torch.as_tensor(np.clip(img, 1e-4, None).astype(np.float32),
                           device=device)


def load_env_or_procedural(fn, scale=1.0, device=None):
    device = resolve(device)
    if fn is not None and os.path.exists(fn):
        return light_mod.load_env(fn, scale=scale, device=device)
    print("WARNING: envlight '%s' not found; using procedural sky+sun probe"
          % fn)
    return procedural_env(device=device)


def make_light(base):
    """The light dict render_mesh reads: base plus its sampling tables."""
    tables = light_mod.update_pdf(base)
    return {'base': base, 'pdf': tables.pdf, 'rows': tables.rows,
            'cols': tables.cols}


def spot256_scene(device=None):
    """The textured spot mesh of docs/quality_r5/spot256 (26,474
    triangles; its probe is SPOT256_PROBE).  mesh.mtl names normal and ORM
    maps that are not in the repo, so the material is built here: kd from
    texture_kd.png (sRGB to linear), ks a constant ORM texture (0, 0.5, 0)
    of the same size, no normal map."""
    device = resolve(device)
    geo = obj_mod.read_obj(os.path.join(SPOT256_DIR, 'mesh.obj'))
    kd = texture_mod.srgb_to_rgb(texture_mod.load_texture2D(
        os.path.join(SPOT256_DIR, 'texture_kd.png'), device=device))
    H, W = kd.getRes()
    ks = torch.tensor([0.0, 0.5, 0.0], device=device)
    material = {'name': 'spot256', 'bsdf': 'pbr', 'kd': kd,
                'ks': texture_mod.Texture2D(
                    data=ks.expand(1, H, W, 3).contiguous())}
    return obj_mod.mesh_from_lists(*geo[:6], material=material,
                                   device=device)


class DatasetMesh(Dataset):
    """Seeded random training cameras, or with validate=True the
    validation orbit of num_validation_frames views, and their ground-truth
    renders.  The cameras come from self.rng and each render's noise from
    the number of frames rendered so far: state_dict holds both."""

    def __init__(self, ref_mesh: mesh_mod.Mesh, cam_radius, FLAGS,
                 validate=False, num_validation_frames=200, seed=0):
        self.cam_radius = cam_radius
        self.FLAGS = FLAGS
        self.validate = validate
        self.num_validation_frames = num_validation_frames
        self.fovy = np.deg2rad(45)
        self.rng = np.random.RandomState(seed)
        self.device = ref_mesh.v_pos.device

        if ref_mesh.v_nrm is None:
            ref_mesh = mesh_mod.auto_normals(ref_mesh)
        if ref_mesh.v_tng is None:
            ref_mesh = mesh_mod.compute_tangents(ref_mesh)
        self.ref_mesh = ref_mesh
        self.bvh = bvh_mod.build(ref_mesh.v_pos, ref_mesh.t_pos_idx)
        env_path = FLAGS.get('envlight')
        if env_path is not None and not os.path.isabs(env_path):
            env_path = os.path.join(FLAGS.get('data_root', '.'), env_path)
        self.envlight = load_env_or_procedural(
            env_path, FLAGS.get('env_scale', 1.0), device=self.device)
        self.lgt = make_light(self.envlight)
        self.perms = envshade.make_perms(FLAGS['n_samples'],
                                         device=self.device)
        self._frame_count = 0

    def getMesh(self):
        return self.ref_mesh

    def _camera(self, res, rotation):
        proj = vecmath.perspective(self.fovy, res[1] / res[0],
                                   self.FLAGS['cam_near_far'][0],
                                   self.FLAGS['cam_near_far'][1])
        mv = vecmath.translate(0, 0, -self.cam_radius) @ rotation
        mvp = proj @ mv
        campos = np.linalg.inv(mv)[:3, 3]
        return mv[None], mvp[None], campos[None], res

    def _rotate_scene(self, itr):
        """View itr of the orbit: tilted by -0.4 rad about x, turned by
        2 pi itr / num_validation_frames about y, at display_res (None:
        train_res)."""
        res = tuple(self.FLAGS.get('display_res') or self.FLAGS['train_res'])
        ang = (itr / self.num_validation_frames) * np.pi * 2
        return self._camera(res, vecmath.rotate_x(-0.4)
                            @ vecmath.rotate_y(ang))

    def _random_scene(self):
        return self._camera(tuple(self.FLAGS['train_res']),
                            vecmath.random_rotation_translation(0.25,
                                                                self.rng))

    def __len__(self):
        return (self.num_validation_frames if self.validate
                else self.FLAGS['iter'] * self.FLAGS['batch'])

    def __getitem__(self, itr):
        with tracing.span('dataset.target'):
            if self.validate:
                mv, mvp, campos, res = self._rotate_scene(itr)
            else:
                mv, mvp, campos, res = self._random_scene()
            self._frame_count += 1
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._frame_count * 7919 + 13)
            dev = self.device
            with torch.no_grad():
                img = render_mod.render_mesh(
                    self.FLAGS, self.ref_mesh,
                    upload(mvp.astype(np.float32), dev),
                    upload(campos.astype(np.float32), dev),
                    self.lgt, res, self.bvh, self.perms, gen,
                    spp=self.FLAGS['spp'], num_layers=self.FLAGS['layers'],
                    msaa=True, background=None,
                    rnd_seed=self._frame_count)['shaded']
            return {
                'mv': mv.astype(np.float32),
                'mvp': mvp.astype(np.float32),
                'campos': campos.astype(np.float32),
                'light': self.lgt,
                'resolution': res,
                'spp': self.FLAGS['spp'],
                'img': img,
            }

    def collate(self, batch):
        """Stack a list of items into one batch (images, cameras)."""
        out = dict(batch[0])
        out['img'] = torch.cat([b['img'] for b in batch])
        for k in ('mv', 'mvp', 'campos'):
            out[k] = np.concatenate([b[k] for b in batch])
        return out

    def state_dict(self):
        return {'rng': rng_state(self.rng), 'frame_count': self._frame_count}

    def load_state_dict(self, state):
        set_rng_state(self.rng, state['rng'])
        self._frame_count = state['frame_count']
