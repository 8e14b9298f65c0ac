"""Fixed-topology mesh geometry (counterpart of
nvdiffrecmc_tpu/geometry/dlmesh.py): vertex positions are the parameters;
normals, tangents and the BVH are rebuilt on every getMesh call, and
`tick` renders a view and returns its image and regularizer losses."""

import dataclasses

import torch

from ..render import mesh as mesh_mod
from ..render import regularizer
from ..render import render as render_mod
from ..ops import bvh as bvh_mod
from ..ops import mesh_ops


class DLMesh:
    def __init__(self, initial_guess: mesh_mod.Mesh, FLAGS):
        self.FLAGS = FLAGS
        self.initial_guess = initial_guess
        self.base_mesh = initial_guess
        self.init_params = {'v_pos': initial_guess.v_pos}
        print("Base mesh has %d triangles and %d vertices."
              % (initial_guess.t_pos_idx.shape[0],
                 initial_guess.v_pos.shape[0]))

    def parameters(self):
        return self.init_params

    def getMesh(self, params, material, build_bvh=True, leaf_size=128):
        m = dataclasses.replace(self.base_mesh, v_pos=params['v_pos'],
                                material=material)
        m = mesh_mod.auto_normals(m)
        m = mesh_mod.compute_tangents(m)
        bvh = (bvh_mod.build(m.v_pos, m.t_pos_idx, leaf_size=leaf_size)
               if build_bvh else None)
        return m, bvh

    def tick(self, params, material, lgt, target, loss_fn, iteration, FLAGS,
             denoiser_sigma, perms, generator, rnd_seed, uniforms=None,
             offsets=None):
        """Render target's view and return (img_loss, reg_loss).  The jitter
        and the MC uniforms come from generator and rnd_seed, or from
        offsets and uniforms (per-layer lists) when given."""
        color_ref = target['img']
        opt_mesh, bvh = self.getMesh(params, material)
        buffers = render_mod.render_mesh(
            FLAGS, opt_mesh, target['mvp'], target['campos'], lgt,
            target['resolution'], bvh, perms, generator, spp=target['spp'],
            num_layers=FLAGS['layers'], msaa=True,
            background=target['background'], denoiser_sigma=denoiser_sigma,
            shadow_scale=1.0, rnd_seed=rnd_seed, uniforms=uniforms,
            offsets=offsets)

        t_iter = iteration / FLAGS['iter']
        img_loss = torch.mean(
            (buffers['shaded'][..., 3:] - color_ref[..., 3:]) ** 2)
        img_loss = img_loss + loss_fn(
            buffers['shaded'][..., 0:3] * color_ref[..., 3:],
            color_ref[..., 0:3] * color_ref[..., 3:])

        reg_loss = regularizer.shading_loss(
            buffers['diffuse_light'], buffers['specular_light'], color_ref,
            FLAGS['lambda_diffuse'], FLAGS['lambda_specular'])
        reg_loss = reg_loss + regularizer.material_smoothness_grad(
            buffers['kd_grad'], buffers['ks_grad'], buffers['normal_grad'],
            lambda_kd=FLAGS['lambda_kd'], lambda_ks=FLAGS['lambda_ks'],
            lambda_nrm=FLAGS['lambda_nrm'])
        reg_loss = reg_loss + regularizer.chroma_loss(
            buffers['kd'], color_ref, FLAGS['lambda_chroma'])
        if 'perturbed_nrm_grad' in buffers:
            reg_loss = reg_loss + (torch.mean(buffers['perturbed_nrm_grad'])
                                   * FLAGS['lambda_nrm2'])
        if FLAGS['laplace'] == 'absolute':
            reg_loss = reg_loss + (mesh_ops.laplace_uniform(
                params['v_pos'], self.base_mesh.t_pos_idx)
                * FLAGS['laplace_scale'] * (1 - t_iter))
        elif FLAGS['laplace'] == 'relative':
            reg_loss = reg_loss + (mesh_ops.laplace_uniform(
                params['v_pos'] - self.initial_guess.v_pos,
                self.base_mesh.t_pos_idx)
                * FLAGS['laplace_scale'] * (1 - t_iter))
        return img_loss, reg_loss
