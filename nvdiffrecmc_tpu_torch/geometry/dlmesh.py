"""Fixed-topology mesh geometry (counterpart of
nvdiffrecmc_tpu/geometry/dlmesh.py): vertex positions are the parameters;
normals, tangents and the BVH are rebuilt on every getMesh call."""

import dataclasses

from ..render import mesh as mesh_mod
from ..ops import bvh as bvh_mod


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
