"""The port's benchmark (counterpart of the repository's bench.py, whose
bench_train and bench_tracer it follows) on the spot256 scene of
docs/quality_r5/spot256 and the program's own functions.  Prints ONE JSON
line:

  {"metric": "train_iters_per_sec_spot_b1_512_n4", "value": N,
   "unit": "iter/s", "vs_baseline": N, "extra": {...}}

- value: the pass-2 step (train.train_step: DLMesh on the spot mesh,
  initial_guess_material at 1024x1024, a 256x256 trainable light, targets
  from DatasetMesh over random backgrounds) at batch 1, 512x512,
  n_samples 4, one host sync per step; 1 / the median step time after a
  warm-up step;
- extra: shadow_Mrays_per_sec (any_hit_pallas on 2^21 rays as
  chip_smoke.tracer_rays makes them, the median of 7 CUDA-event timings),
  ms_per_frame (a DatasetMesh ground-truth render at 512x512, n_samples 4,
  median of 4), s_per_view (train.render_eval of validation views 0 and 1
  at n_samples 32, median), b4_ms_per_step (configs/spot.json's step:
  batch 4, 512x512 textures, lock_pos; median of 8), the device ms and
  kernel launches of 4 more steps at each batch under a kernel-only
  profiler trace, the card (nvidia-smi's name and power limit);
- extra, pass 1 (bench_pass1, the JAX bench's bench_pass1): the pass-1
  step (DMTetGeometry at grid 64, mesh_scale 2.1, the hash-grid material,
  a 256x256 trainable light, batch 1, 512x512, n_samples 4, the
  bilateral denoiser, targets as bench_train makes them) as
  pass1_dmtet_hashgrid_iters_per_sec from the random SDF init (the
  overlapping foam of a run's first iterations) and
  pass1_annealed_iters_per_sec from a sphere SDF of radius 0.35 x 2.1 (a
  closed surface, as mid-training), 1 / the median of 8 synced steps
  after a warm-up step, with pass1_note.
The JAX bench's XLA cost-analysis figures (step_gflops_*, step_gbytes_*,
mfu_*) are a TPU's and have no counterpart here.  vs_baseline divides by
the JAX bench's estimate of 3.3 iter/s for the reference on an A6000,
which publishes no number.

Usage: python3 -m nvdiffrecmc_tpu_torch.bench   (needs the CUDA card)
"""

import json
import os
import statistics
import sys
import time

import torch

from . import config, train
from .bench_common import device_ms, smi_line
from .dataset import BatchIterator
from .dataset.dataset_mesh import SPOT256_PROBE, DatasetMesh, spot256_scene
from .device import resolve
from .geometry import DLMesh, DMTetGeometry
from .ops import bvh as bvh_mod
from .ops import pallas_tracer
from .render import light as light_mod

REF_A6000_ITERS_PER_SEC_ESTIMATE = 3.3
RES = 512
N_SAMPLES = 4
PASS1_GRID = 64
PASS1_SCALE = 2.1
PASS1_NOTE = ('pass1 = the random SDF init (the overlapping foam of a run\'s '
              'first iterations, the worst case); pass1_annealed = a sphere '
              'SDF of radius 0.35 x mesh_scale (a closed surface, as '
              'mid-training)')


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _synced_ms(fn, device=torch.device('cuda')):
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


def bench_tracer(mesh, n_rays=2 ** 21):
    """Shadow Mrays/s of the standalone tracer on the spot mesh."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    bvh = bvh_mod.build(mesh.v_pos, mesh.t_pos_idx, leaf_size=128)
    ro, rd, _ = chip_smoke.tracer_rays(mesh, n_rays, mesh.v_pos.device)
    pallas_tracer.any_hit_pallas(ro, rd, bvh)
    times = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pallas_tracer.any_hit_pallas(ro, rd, bvh)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return n_rays / statistics.median(times) / 1e3


def timed_steps(ds, FLAGS, geometry, mat_params, mat_static, iters):
    """Median ms of iters synced train.train_step calls after a warm-up
    step, on a 256x256 trainable light and targets from ds over random
    backgrounds; and (next_target(), run(target, it) -> ms) for more
    steps, and the parameters."""
    device = ds.device
    light = light_mod.create_trainable_env_rnd(FLAGS['probe_res'], 0.0, 0.5,
                                               device=device)
    params = train.make_params(geometry, mat_params, light)
    opts = train.make_optimizers(params, FLAGS)
    loss_fn = train.createLoss(FLAGS)
    gen = torch.Generator(device=device)
    gen.manual_seed(42)
    batches = BatchIterator(ds, FLAGS['batch'])

    def next_target():
        return train.prepare_batch(next(batches), FLAGS['train_res'],
                                   'random', gen, FLAGS)

    def run(target, it):
        return _synced_ms(lambda: train.train_step(
            geometry, params, opts, mat_static, target, it, FLAGS, loss_fn,
            ds.perms, gen), device)
    times = [run(next_target(), it) for it in range(iters + 1)]
    return statistics.median(times[1:]), (next_target, run), params


def bench_train(ds, FLAGS, iters=12):
    """Median ms of the synced pass-2 step at FLAGS['batch'] after a
    warm-up step, and (next_target(), run(target, it) -> ms) for more
    steps, and (the trained geometry, parameters, material static)."""
    geometry = DLMesh(ds.ref_mesh, FLAGS)
    mat_params, mat_static = train.initial_guess_material(
        geometry, False, FLAGS, device=ds.device)
    ms, steps, params = timed_steps(ds, FLAGS, geometry, mat_params,
                                    mat_static, iters)
    return ms, steps, (geometry, params, mat_static)


def bench_pass1(annealed=False, iters=8, res=RES, grid=PASS1_GRID,
                device=None):
    """The pass-1 step (DMTetGeometry at grid, mesh_scale 2.1, the
    hash-grid material, batch 1, res x res, n_samples 4, the bilateral
    denoiser) on spot256 targets, from the random SDF init or, annealed,
    from a sphere SDF of radius 0.35 x 2.1.  Returns (median ms per step
    of iters after a warm-up, (next_target, run), the surface triangles
    of the init)."""
    device = resolve(device)
    FLAGS = config.make_flags(train_res=[res, res], n_samples=N_SAMPLES,
                              envlight=SPOT256_PROBE, iter=iters, batch=1,
                              layers=1, spp=1, denoiser='bilateral',
                              dmtet_grid=grid, mesh_scale=PASS1_SCALE)
    ds = DatasetMesh(spot256_scene(device), train.RADIUS, FLAGS, seed=3)
    geometry = DMTetGeometry(grid, PASS1_SCALE, FLAGS, device=device)
    if annealed:    # the JAX bench's sphere: norm(v) - r
        geometry.init_params['sdf'] = (
            torch.linalg.norm(geometry.verts, dim=-1) - 0.35 * PASS1_SCALE)
    mat_params, mat_static = train.initial_guess_material(
        geometry, True, FLAGS, device=device)
    mat_static['no_perturbed_nrm'] = True
    tris = geometry.tri_count(geometry.parameters())[0]
    ms, steps, _ = timed_steps(ds, FLAGS, geometry, mat_params, mat_static,
                               iters)
    return ms, steps, tris


def device_per_step(steps, reps=4):
    """(device ms, kernel launches) per step under a kernel-only profiler
    trace of reps more steps, their targets rendered first; the process's
    later launches run slower, so this comes after every other timing."""
    next_target, run = steps
    targets = iter([next_target() for _ in range(reps + 1)])
    return device_ms(lambda: run(next(targets), 100), reps)


def bench_view(trained, FLAGS, device, views=2):
    """Median seconds of render_eval of the first validation views."""
    geometry, p, static = trained
    ds = DatasetMesh(spot256_scene(device), train.RADIUS, FLAGS,
                     validate=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    secs = []
    for i in range(views):
        batch = ds.collate([ds[i]])
        target = train.prepare_batch(batch, tuple(batch['img'].shape[1:3]),
                                     FLAGS['background'], gen, FLAGS)
        secs.append(_synced_ms(lambda: train.render_eval(
            geometry, p['geo'], p['mat'], static, p['light'], target,
            FLAGS)) / 1e3)
    return statistics.median(secs)


def pass1_extra(iters=8, res=RES, grid=PASS1_GRID, device=None):
    """The JSON line's pass-1 keys: bench_pass1 from the random init and
    from the sphere."""
    device = resolve(device)
    ms, _, tris = bench_pass1(iters=iters, res=res, grid=grid, device=device)
    ms_a, _, tris_a = bench_pass1(annealed=True, iters=iters, res=res,
                                  grid=grid, device=device)
    return {'pass1_dmtet_hashgrid_iters_per_sec': 1e3 / ms,
            'pass1_annealed_iters_per_sec': 1e3 / ms_a,
            'pass1_ms_per_step': ms,
            'pass1_annealed_ms_per_step': ms_a,
            'pass1_init_surface_triangles': tris,
            'pass1_annealed_init_surface_triangles': tris_a,
            'pass1_note': PASS1_NOTE}


def main():
    device = resolve(None)
    t_start = time.time()
    FLAGS = config.make_flags(train_res=[RES, RES], n_samples=N_SAMPLES,
                              envlight=SPOT256_PROBE, iter=12)
    mesh = spot256_scene(device)
    ds = DatasetMesh(mesh, train.RADIUS, FLAGS, seed=5)
    mrays = bench_tracer(mesh)
    ds[0]
    frame_ms = statistics.median(_synced_ms(lambda: ds[0])
                                 for _ in range(4))
    step_ms, steps, trained = bench_train(ds, FLAGS)
    view_s = bench_view(trained, FLAGS, device)
    # configs/spot.json's step: batch 4, 512x512 textures, lock_pos
    F4 = config.make_flags(train_res=[RES, RES], n_samples=N_SAMPLES,
                           envlight=SPOT256_PROBE, iter=12, batch=4,
                           texture_res=[512, 512], lock_pos=True,
                           learning_rate=[0.03, 0.01],
                           ks_min=[0.0, 0.1, 0.0])
    ds4 = DatasetMesh(mesh, train.RADIUS, F4, seed=6)
    step4_ms, steps4, _ = bench_train(ds4, F4, iters=8)
    pass1 = pass1_extra(device=device)
    b1 = device_per_step(steps)
    b4 = device_per_step(steps4)
    rate = 1e3 / step_ms
    print(json.dumps({
        'metric': 'train_iters_per_sec_spot_b1_512_n4',
        'value': rate,
        'unit': 'iter/s',
        'vs_baseline': rate / REF_A6000_ITERS_PER_SEC_ESTIMATE,
        'extra': {
            'shadow_Mrays_per_sec': mrays,
            'ms_per_step': step_ms,
            'ms_per_frame': frame_ms,
            's_per_view': view_s,
            'b4_ms_per_step': step4_ms,
            'device_ms_per_step': b1[0],
            'launches_per_step': b1[1],
            'b4_device_ms_per_step': b4[0],
            'b4_launches_per_step': b4[1],
            **pass1,
            'device': torch.cuda.get_device_name(0),
            'card': smi_line(),
            'scene': 'docs/quality_r5/spot256 (26,474 triangles, '
                     'probe.hdr 512x1024)',
            'bench_wall_s': time.time() - t_start,
            'timing': 'median per step, one host sync per step; device '
                      'ms: a kernel-only profiler trace of 4 more steps',
            'baseline_note': 'vs the JAX bench\'s estimated A6000 3.3 '
                             'iter/s (the reference publishes no number)',
        },
    }))


if __name__ == '__main__':
    main()
