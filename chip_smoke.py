#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (nvdiffrecmc_tpu_torch) on one GPU.

Phases, in the order they run (7 runs last, so that no timed phase comes
after a torch.profiler session: a process's launches run slower after
one):
1. require CUDA; print the card's name and power limit; TF32 off;
2. build the CUDA kernels from csrc/ and print the build time, and the
   registers, spill bytes and blocks per SM of the sample kernel (for the
   probe's and the trainable light's sizes), of shade_bwd and of the mask
   kernel;
3. render one frame of the slice, recording each forward kernel's inputs,
   and hold every forward kernel against its plain PyTorch version on
   those inputs (error, share of mismatches, time of both; for the
   resolve, the ids and depths that differ, on the frame and on its
   second peel layer);
4. reset the launch counters, render 4 frames of the slice (textured spot
   mesh, 26,474 triangles, 512x512, n_samples 4, one layer, spp 1,
   bilateral denoiser sigma 2.0, white background, cameras as
   DatasetMesh._random_scene), check the buffers and that every forward
   kernel ran once per frame and no backward kernel ran, print the median
   ms per frame;
5. render a 64x64 frame with the kernels and with the plain versions on the
   CPU from the same uniforms and compare the shaded images;
6. the pass-2 training step: DLMesh on the spot mesh, initial_guess_material
   at 1024x1024 textures, create_trainable_env_rnd(256, 0.0, 0.5), targets
   from DatasetMesh (spot256 under probe.hdr) over random backgrounds,
   logl1, three Adam groups.  One recorded step holds each backward kernel
   and the resolve, guide, sample and denoiser kernels of its forward
   against their plain versions, and every row scatter launch of the step
   (one line each, with its shape) and the scatter's generic instance
   against theirs; then 8 steps with a sync each (loss and the
   gradients of all three groups finite and nonzero, every kernel launched
   as many times per step as the path needs), median ms per step and
   iterations per second; then one 64x64 step on the card against the same
   step on the CPU with the plain versions;
8. the standalone tracer on 2^21 rays as bench.py's bench_tracer makes
   them (seed 1, unit directions, origins on a sphere at 0.6 of the spot
   mesh's bounding radius around its centre; that protocol's mesh was unit
   sized): shadow Mrays/s of any_hit_pallas (CUDA events, median of 7
   after a warm-up), the trace kernel against the plain tracer (equal
   results on every ray) and the mask kernel at ray_block 1024 on the
   rays' features ([2048, 207], equal on every entry); the triangle tests
   per ray that the walk needs under the three-level structure (sub-boxes
   of bvh.SUB triangles) and under the two-level one (whole leaves);
9. validation at the reference protocol with phase 6's trained scene and
   parameters: train.validate over VAL_FRAMES view (the first) of
   DatasetMesh(validate=True)
   at 512x512, n_samples 32 (1,024 strata in one call, the stratum loop),
   no denoiser, checker background, into chiprun_out/validate/; seconds,
   MSE and PSNR per view, launches per render_eval (sample and trace
   1,024, resolve and the sampler's guide tables 1, trace_shade, denoise
   and mask 0); the first view's
   resolve and the first stratum's inputs hold resolve, sample, trace and
   mask against their plain versions (the sample line gives the kernel's
   time at one stratum, as the stratum loop launches it), and give the
   triangle tests per covered ray as in phase 8;
10. a 32x32 validation frame at n_samples SMALL_VAL_N (17: 289 strata, the
   stratum loop) with the kernels on the card and with the plain versions
   on the CPU from the same uniforms;
11. count the kernels (PyTorch's and ours) that one rasterize call of
   phase 3's frame launches, under torch.profiler: at most
   RESOLVE_MAX_LAUNCHES up to the resolve's output;
12. one recorded pass-2 step at batch 4 (512x512 textures), each kernel
   of the step (every row scatter launch among them) against its plain
   version at those shapes; then the pass-2 program, in
   chiprun_out/train_cli/ (cleared first): the
   spot256 geometry written with the port's write_obj under a constant kd
   0.5 and ks (0, 0.5, 0) at 512x512 as the base mesh; an MTL override
   that gives the reference mesh texture_kd.png and Ks 0 0.5 0; a config
   of configs/spot.json's keys (batch 4, 512x512, 512x512 textures,
   n_samples 4, lock_pos, white background, the latlong display layer)
   with that scene, probe.hdr as envlight, 20 iterations, a probe and a
   checkpoint every 10, no validation (phase 13's pass 2 validates).
   `python3 -m nvdiffrecmc_tpu_torch.train --config` runs as a
   subprocess; its log and probe lines are relayed, with the median ms
   per step, the peak device memory, the seconds per probe and for the
   export, and the kernel launches of the run and per step (every kernel
   but the mask launched; per step as in phase 6).  Checks: every loss
   and PSNR finite, mesh/ with the OBJ, MTL, three PNGs and probe.hdr,
   the OBJ read back by load_obj (26,474 triangles, v_pos within 1e-5 of
   the checkpoint's), probe.hdr read back at 512x1024, the exported kd off
   the initial gray.  Then `-i 12` into the same out_dir resumes from
   iteration 11 and runs that one step; the checkpoints are deleted;
13. pass 1, the pass boundary and both passes: the program on the config
   of phase 12 without base_mesh, no validation (phase 15's program runs
   both), in chiprun_out/train_two_pass/ (pass 1 on the DMTet Kuhn grid
   64, 98,304 triangle slots, with the default hash grid and its 32-wide
   MLP, 20 iterations; the bake at 512x512; pass 2 on the baked mesh, 20
   iterations).  Relayed and printed: each
   pass's median ms per step and launches per step (as in phase 6), the
   surface triangles against the slots at the end of pass 1 and every
   overflow warning, the boundary (check_boundary, as in phase 14), every
   probe's PSNR and seconds, peak device memory.  Checks: losses and
   PSNRs finite, dmtet_mesh/ and mesh/ read back, pass 2's mesh the
   baked one.  Then, in this process, one
   recorded pass-1 step at batch 4 (iteration PASS1_IT) holds every
   kernel of the step against its plain version (every row scatter
   launch; the hash-grid table's, 268 M rows of C = 2, also with the
   generic instance, timed against both and index_add_); PASS1_STEPS
   more steps give ms per step, launches per
   step, peak memory and, per step and image, the triangles the resolve
   gives the whole screen (a vertex at w <= 1e-6); last a kernel-only
   trace of 2 more steps gives pass 1's device ms per step;
14. the NeRF scene (users who reconstruct from photographs) at grid 64:
   the program on configs/nerf_spot_synth_g64.json as shipped
   (data/nerf_synthetic_spot, batch 8 in micro-steps of 1, 800x800,
   n_samples 8, 1024x1024 textures, DMTet grid 64 at mesh_scale 2.4, the
   white background, four display layers) but NERF_ITERS iteration a
   pass, both validations on a copy of the scene whose test split is its
   first view (NERF_VIEWS), in chiprun_out/train_nerf_grid_64/ (cleared
   first).  Relayed and printed: each pass's median ms per step,
   micro-steps and launches per step, the surface triangles against the
   98,304 slots and every overflow warning, the boundary, the probes, s
   per view and PSNR of both validations, peak device memory.  Checks:
   losses and PSNRs finite, both metrics.txt, 8 micro-steps a
   step, every kernel but the mask launched, peak memory
   under the card's, and the boundary (check_boundary): the bake holds
   every surface triangle pass 1 ends with less the prune's drops, read
   back from dmtet_mesh/, no face of zero area, covered kd and ks texels,
   and mesh/ exports that many triangles;
15. the NeRF scene at grid 128: the program on configs/nerf_spot_synth.json
   as shipped (grid 128: 12,582,912 tets, 393,216 triangle slots) but
   NERF_G128_ITERS iteration a pass, no probe and no validation (phase
   14's program runs both at grid 64), in chiprun_out/train_nerf_grid_128/,
   with phase 14's lines and checks.
   Then, in this process: the grid's set-up seconds and resident
   bytes and the init's surface triangles against the slots; the peak
   memory of one micro-step and of an unsplit batch of 2 (the unsplit
   batch 8 reckoned from them); one recorded pass-1 micro-step at 800x800
   and n2 = 64 holds each of its kernels against its plain version (every
   row scatter launch), with trace + shade's time, the walk's shared
   memory and its triangle tests per ray on 65,536 of stratum 0's shadow
   rays; the whole unpruned surface (marching tets in buffers sized to
   it, as the pass boundary extracts, 4.9 M triangles at leaf 1024) holds
   the trace against its plain version on those rays; last one pass-2
   micro-step on the program's bake, read back, whose trace + shade is
   held against its plain version at the leaf size the program chose;
16. transparency: the program on configs/nerfactor_drums.json with
   --ref_mesh data/nerf_synthetic_spot (the nerfactor scenes are not in
   the repo): batch 8 in micro-steps of TRANSPARENCY_MICRO_BATCH, 512x512
   (the 800x800 frames minified), n_samples 8, 1024x1024 textures, grid
   128 at mesh_scale 2.3, laplace_scale 6000, white background, four
   display layers; TRANSPARENCY_ITERS iterations a pass, no probe, no
   validation, in chiprun_out/train_transparency/.  Checks: losses
   finite, pass 1 at one layer and pass 2 at 8 (the summary lines), each
   kernel's launches per step (8 per micro-step for pass 2's per-layer
   kernels), the boundary, RGBA texture_kd.png files in dmtet_mesh/ (its
   alpha the bake's uniform draw) and mesh/.  Then, in this process, on
   the export read back with its alpha at 8 layers: the memory of one
   micro-step and of an unsplit batch of 2 (the unsplit batch 8
   reckoned); one recorded micro-step (one 512x512 view, n2 = 64) whose
   every kernel launch is held against its plain version (resolve,
   sample, trace + shade, denoise and their backward kernels at each
   layer, every row scatter launch), with the pixels each layer covers;
   one validation view at 8 layers (the first test view, 800x800,
   n_samples 32: its seconds, 8 x 1,024 sample and trace launches, and
   sample and trace on stratum 0 of each layer against their plain
   versions); last the resolve at each of 8 peel layers of spot256 at
   512x512, bit-equal to its plain version, layer 7 covering pixels;
17. the training options: a two-material copy of spot256 written under
   chiprun_out/train_options/base/ (the faces split by their centroid's
   x, the second material's kd the first's tinted and at half
   resolution, written with the port's encode_png); the program on
   phase 12's config of configs/spot.json's keys with that copy as
   base_mesh and custom_mip, decorrelated and denoiser_demodulate false,
   OPTIONS_ITERS iterations, a checkpoint at 5, no probe, no validation
   (launches per step as OPTIONS_STEP_LAUNCHES; the export read back with
   its 10 mip levels a texture).  Then, in this process, one recorded
   batch-4 512x512 step with those options on that mesh, whose one-buffer
   denoiser launches and decorrelated backward (sample, trace + shade,
   shade_bwd, light scatter) are held against their plain versions, the
   backward's uniforms other than the forward's; that step's ms against
   the default step's in turns; last one spot256 step at n_samples 17
   (289 strata, the stratum loop and its backward) at 512x512: s per step,
   peak memory (below one [n2, 8, P] array), launches per stratum, and
   its backward's launches on strata 0 and 288 against their plain
   versions; after them a kernel-only trace of one more such step (its
   device time, idle share and device events a stratum);
18. configs/nerd_gold.json's LLFF path (NeRD's real captures: JPEG images
   and masks) on the repo's capture data/llff_spot_synth/ (24 views at
   800x600): the scene decoded by the port's JPEG decoder (its seconds;
   the decoded uint8 scene's sha256 equal to the one the CPU tests pin
   under imageio), the LLFF dataset's load, and in this process at
   nerd_gold's keys (grid 128 at mesh_scale 2.5, 512x512, n_samples 12,
   so n2 = 144) the peak memory of one pass-1 micro-step and of an
   unsplit batch of 2, batch 8 reckoned from them, and the micro-batch
   the program gets (the largest of 8, 4, 2, 1 whose reckoned step and
   the state stay within NERD_MEMORY_SHARE of the card); one recorded
   micro-step whose every kernel launch is held against its plain
   version, with the triangles the resolve gives the whole screen; the
   capture's first view at its native 600x800 (n_samples 32) on that
   grid-128 DMTet state, with its padded triangle slots, whose first
   stratum holds sample and trace against their plain versions; then
   the program (nerd_gold.json with --ref_mesh data/llff_spot_synth,
   NERD_ITERS iteration a pass, no probe, no validation, that
   --micro-batch) through nerf_program, in chiprun_out/train_nerd_gold/,
   with phase 14's checks of the log, launches, memory and boundary;
   then one validation view
   of the bake at the capture's native 800x600 (train.validate,
   max_frames=1, the config's display layers) whose resolve and first
   stratum's sample and trace are held against their plain versions,
   with the whole-screen triangles; last a 24x32 frame (24 high, 32
   wide) through the kernels against the plain versions on the CPU;
7. with --profile only: torch.profiler over 4 more frames and over 4 more
   training steps; prints device time by kernel, launches and host gaps,
   and writes the full tables to chiprun_out/profile_port.txt and
   chiprun_out/profile_train.txt; then a kernel-only trace of 4 more of
   each gives the device's idle share within one run; then a kernel-only
   trace of one more validation view (chiprun_out/profile_validate.txt).

Each phase prints its seconds ('phase N: ... s').  Any failure raises and
exits non-zero before the last line.  The last
three lines are the kernels JSON (all thirteen entries: the ten kernels
that replace the TPU kernels, the denoiser's two modes apart, the
sampler's guide kernel, and the denoiser's one-buffer instance in its two
modes; each with its time, its plain version's, its bound and, for
the two scatters, index_add_'s, for the guide torch.searchsorted's, and
its launches in phase 12's program and per step there, in phase 13's
program and per pass-1 step there, in phase 14's and phase 15's programs
and per pass-1 step there, per grid-128 micro-step and, for the step's
kernels, its check at batch 4, at pass 1's batch 4 and at the grid-128
micro-step, for the trace on the whole grid-128 surface, and for trace +
shade at the grid-128 bake; its launches in phase 16's program and per
8-layer micro-step, its check at each layer of that micro-step (the scatter: all
its launches), for sample and trace at stratum 0 of each layer of the
8-layer validation view, and for the resolve at the 8 peel layers of
spot256; its launches in phase 17's program and per step there, per
options step and per loop step, its check in the options step's
decorrelated backward and on the loop backward's strata 0 and 288; its
launches in phase 18's program and per pass-1 step there and per
nerd_gold micro-step, its check at that micro-step, for sample and
trace at the 600x800 view of the grid-128 DMTet state and, for resolve,
sample and trace, at the 600x800 view of the bake; the
one-buffer denoiser's two rows from the options step; the row scatter's
entry is its largest launch, with every launch of the step and their
summed time and bound beside it, and pass 1's hash-grid launch with the
generic instance's and index_add_'s times), the card line, and {"ok":
true, "device": {...}}.

Usage: python3 chip_smoke.py [--profile]
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

RES = 512
N_SAMPLES = 4
FRAMES = 4
SIGMA = 2.0
CAM_RADIUS = 3.0
TRAIN_STEPS = 8
TEX_RES = 1024
# launches of each kernel per training step: the forward (one guide build
# for the step's light), the sampling replayed in the backward, one launch
# of each backward kernel, and one row scatter per rows_gather (at least
# one)
STEP_LAUNCHES = {'resolve': 1, 'sample_guide': 1, 'sample': 2,
                 'trace_shade': 1, 'denoise': 1, 'denoise_grad': 1,
                 'shade_bwd': 1, 'light_scatter': 1}
# kernels that only a training option runs (the one-buffer denoiser of
# denoiser_demodulate false): no launch on the default paths
OPTION_KERNELS = ('denoise_one', 'denoise_one_grad')
TRACER_RAYS = 2 ** 21   # bench.py's bench_tracer
RESOLVE_MAX_LAUNCHES = 10   # kernels of one rasterize call up to the resolve
VAL_FRAMES = 1
VAL_N = 32              # the reference validation protocol's n_samples
SMALL_VAL_N = 17        # phase 10's: 289 strata, past the fused path's 256,
                        # so the stratum loop runs
PROGRAM_ITERS = 20
PROGRAM_TIMEOUT = 600   # seconds for each run of the program
PASS1_IT = 3            # the recorded pass-1 step's iteration
PASS1_STEPS = 4         # pass-1 steps timed in this process
NERF_CONFIG = os.path.join('configs', 'nerf_spot_synth_g64.json')
NERF_TRAIN = os.path.join('data', 'nerf_synthetic_spot',
                          'transforms_train.json')
NERF_TEST = os.path.join('data', 'nerf_synthetic_spot',
                         'transforms_test.json')
NERF_ITERS = 1          # iterations a pass of phase 14's program
NERF_G128_CONFIG = os.path.join('configs', 'nerf_spot_synth.json')
NERF_G128_ITERS = 1     # iterations a pass of phase 15's program
NERF_VIEWS = 1          # phase 14's test split: the first of the 4 views
NERF_TIMEOUT = 700      # seconds for the program of phase 14, 15 or 16
TRANSPARENCY_CONFIG = os.path.join('configs', 'nerfactor_drums.json')
TRANSPARENCY_ITERS = 1  # iterations a pass of phase 16's program
# phase 16's --micro-batch: the largest that fits both passes (PERF.md
# section 6 reckons it: pass 2 peels 8 layers, each with its own G-buffer
# and shading, and the config sets batch 8 and no micro_batch)
TRANSPARENCY_MICRO_BATCH = 4
PEEL_LAYERS = 8         # transparency's pass 2 and its validation
NERD_CONFIG = os.path.join('configs', 'nerd_gold.json')
LLFF_SCENE = os.path.join('data', 'llff_spot_synth')
NERD_ITERS = 1          # iterations a pass of phase 18's program
NERD_MEMORY_SHARE = 0.9  # of the card that phase 18's reckoned step may
                         # take with the state (the reckoning came within
                         # 1% of the program's peak, PERF.md section 6)
SMEM_PER_SM = 233472    # shared memory of an H100 SM (1 KB of it per block
                        # is reserved)


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def flags(res, n_samples):
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import SPOT256_PROBE
    return dict(n_samples=n_samples, train_res=[res, res],
                cam_near_far=[0.1, 1000.0], spp=1, layers=1, iter=FRAMES,
                batch=1, denoiser_demodulate=True, envlight=SPOT256_PROBE)


def render_frame(ds, geometry, material, FLAGS, it, device):
    """One forward render of the slice, as DLMesh.tick calls render_mesh."""
    import torch
    from nvdiffrecmc_tpu_torch.render import render as render_mod
    _, mvp, campos, res = ds._random_scene()
    opt_mesh, bvh = geometry.getMesh(geometry.parameters(), material)
    gen = torch.Generator(device=device)
    gen.manual_seed(1000 + it)
    return render_mod.render_mesh(
        FLAGS, opt_mesh, torch.as_tensor(mvp, device=device),
        torch.as_tensor(campos, device=device), ds.lgt, res, bvh, ds.perms,
        gen, spp=1, num_layers=FLAGS['layers'], msaa=True,
        background=torch.ones((1, res[0], res[1], 3), device=device),
        denoiser_sigma=SIGMA, shadow_scale=1.0, rnd_seed=it)


def check_buffers(buf, res):
    import torch
    for k, v in buf.items():
        if tuple(v.shape) != (1, res, res, 4):
            raise RuntimeError('buffer %s has shape %s' % (k, tuple(v.shape)))
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError('buffer %s is not finite' % k)
    alpha = buf['shaded'][..., 3] > 0
    coverage = float(alpha.float().mean())
    if coverage <= 0.05:
        raise RuntimeError('coverage %.4f <= 5%%' % coverage)
    mean_col = float(buf['shaded'][..., 0:3][alpha].mean())
    if not 0.0 < mean_col <= 1.0:
        raise RuntimeError('mean shaded color %.4f outside (0, 1]' % mean_col)
    return coverage, mean_col


def small_agreement(device, res=(64, 64), n=2):
    """A res[0] x res[1] frame (height x width; a non-square one has a
    camera of that aspect) at n_samples n: kernels on the card vs plain
    versions on the CPU, same scene, cameras and uniforms."""
    import torch
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (DatasetMesh,
                                                            spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    from nvdiffrecmc_tpu_torch.render import render as render_mod
    H, W = res
    shaded = {}
    gen = torch.Generator()
    gen.manual_seed(7)
    uniforms = pallas_shade.make_uniforms(gen, n * n, H * W, n,
                                          device='cpu')
    for dev in (device, 'cpu'):
        mesh = spot256_scene(dev)
        FLAGS = dict(flags(H, n), train_res=[H, W])
        ds = DatasetMesh(mesh, CAM_RADIUS, FLAGS, seed=3)
        geometry = DLMesh(ds.ref_mesh, FLAGS)
        _, mvp, campos, r = ds._random_scene()
        m, bvh = geometry.getMesh(geometry.parameters(), mesh.material)
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        with torch.no_grad():
            buf = render_mod.render_mesh(
                FLAGS, m, torch.as_tensor(mvp, device=dev),
                torch.as_tensor(campos, device=dev), ds.lgt, r, bvh, ds.perms,
                g, msaa=True, background=torch.ones((1, H, W, 3),
                                                    device=dev),
                denoiser_sigma=SIGMA, uniforms=[uniforms.to(dev)])
        shaded[dev] = buf['shaded'].cpu()
    coverage = float((shaded['cpu'][..., 3] > 0).float().mean())
    if tuple(shaded['cpu'].shape) != (1, H, W, 4) or coverage <= 0.05:
        raise RuntimeError('%dx%d render of shape %s covers %.4f'
                           % (H, W, tuple(shaded['cpu'].shape), coverage))
    diff = (shaded[device] - shaded['cpu']).abs().amax(-1)
    share = float((diff <= 1e-3).float().mean())
    if share < 0.99:
        raise RuntimeError('%dx%d render: only %.4f of pixels within 1e-3 '
                           'of the plain CPU render' % (H, W, share))
    return share, float(diff.max())


def profile_run(run, label, device, out_path):
    """torch.profiler over run(i) for i < FRAMES after one warm-up call:
    wall and device ms per call, the device time of each kernel, kernel
    launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run(100)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(FRAMES):
            run(101 + it)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / FRAMES
    averages = prof.key_averages()
    # self_device_time_total is self_cuda_time_total in older PyTorch
    key = 'self_device_time_total'
    if averages and not hasattr(averages[0], key):
        key = 'self_cuda_time_total'
    rows = [(getattr(evt, key) / 1e3 / FRAMES, evt.count / FRAMES, evt.key)
            for evt in averages
            if evt.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0.0:
        raise RuntimeError('the profiler saw no device time')
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, 'w') as f:
        f.write(averages.table(sort_by=key, row_limit=60))
    print('profile %s: %.2f ms wall per call, %.2f ms device (%.1f%% busy), '
          '%.2f ms host gaps, %d kernel launches per call'
          % (label, wall, busy, 100.0 * busy / wall, wall - busy,
             round(sum(r[1] for r in rows))), flush=True)
    for ms, count, name in rows[:10]:
        print('profile %s: %8.3f ms per call  %6.1f launches  %s'
              % (label, ms, count, name[:80]), flush=True)
    print('profile %s: full table in %s' % (label, out_path), flush=True)
    # the idle share from one run: a kernel-only trace, whose host cost is
    # a small part of the operator trace's, timed by its own wall clock
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for it in range(FRAMES):
            run(201 + it)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / FRAMES
    busy = sum(getattr(evt, key) for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA)
    busy = busy / 1e3 / FRAMES
    if busy <= 0.0:
        raise RuntimeError('the kernel-only trace saw no device time')
    print('profile %s (kernel-only trace): %.2f ms wall per call, %.2f ms '
          'device, %.2f ms idle (%.1f%%)'
          % (label, wall, busy, wall - busy, 100.0 * (wall - busy) / wall),
          flush=True)


# ---------------------------------------------------------------------------
# The training step
# ---------------------------------------------------------------------------

def train_setup(device, res, n_samples, tex_res, kd_noise=None, layers=1):
    """The pass-2 step's state on device: flags, the spot dataset, DLMesh,
    the trainable material and light, their optimizers.  kd_noise: a
    [1, tex_res, tex_res, C] array subtracted from the constant initial kd
    (C = 4 past one depth-peel layer, the alpha among them)."""
    import torch
    from nvdiffrecmc_tpu_torch import config, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    FLAGS = config.make_flags(train_res=[res, res], n_samples=n_samples,
                              texture_res=[tex_res, tex_res],
                              envlight=SPOT256_PROBE, layers=layers)
    ds = DatasetMesh(spot256_scene(device), CAM_RADIUS, FLAGS, seed=5)
    geometry = DLMesh(ds.ref_mesh, FLAGS)
    mat_params, mat_static = train.initial_guess_material(
        geometry, False, FLAGS, device=device)
    if kd_noise is not None:
        mat_params['kd'] = mat_params['kd'] - torch.as_tensor(
            kd_noise, device=device)
    light = light_mod.create_trainable_env_rnd(FLAGS['probe_res'], 0.0, 0.5,
                                               device=device)
    params = train.make_params(geometry, mat_params, light)
    return dict(FLAGS=FLAGS, ds=ds, geometry=geometry, params=params,
                static=mat_static, opts=train.make_optimizers(params, FLAGS),
                loss_fn=train.createLoss(FLAGS))


def groups(params):
    from nvdiffrecmc_tpu_torch import train
    return {k: train._group(params[k]) for k in ('geo', 'mat', 'light')}


def check_step(params, img_loss, reg_loss):
    """The loss is finite and every group has a finite, nonzero gradient."""
    import torch
    if not (bool(torch.isfinite(img_loss)) and bool(torch.isfinite(reg_loss))):
        raise RuntimeError('loss not finite: %s %s' % (img_loss, reg_loss))
    for name, ps in groups(params).items():
        gs = [p.grad for p in ps]
        if any(g is None or not bool(torch.isfinite(g).all()) for g in gs):
            raise RuntimeError('gradient of %s missing or not finite' % name)
        if not any(bool(g.abs().max() > 0) for g in gs):
            raise RuntimeError('gradient of %s is zero' % name)


def make_targets(st, n, seed):
    """n prepared targets: DatasetMesh ground truth over random
    backgrounds."""
    import torch
    from nvdiffrecmc_tpu_torch import train
    gen = torch.Generator(device=st['ds'].device)
    gen.manual_seed(seed)
    return [train.prepare_batch(st['ds'][i], st['FLAGS']['train_res'],
                                'random', gen, st['FLAGS'])
            for i in range(n)]


def train_phase(device, results):
    """Phase 6: recorded step and kernel checks, then TRAIN_STEPS timed
    steps of the 512x512 pass-2 step.  Returns the launch counts."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, kernels, train
    t0 = time.perf_counter()
    st = train_setup(device, RES, N_SAMPLES, TEX_RES)
    targets = make_targets(st, TRAIN_STEPS + 1, 17)
    torch.cuda.synchronize()
    p = st['params']
    print('train: %d tris, kd/ks/normal %s, light %s, %d targets, %.1f s'
          % (st['geometry'].base_mesh.t_pos_idx.shape[0],
             tuple(p['mat']['kd'].shape), tuple(p['light'].shape),
             len(targets), time.perf_counter() - t0), flush=True)

    def step(i, target):
        return train.train_step(st['geometry'], p, st['opts'], st['static'],
                                target, i, st['FLAGS'], st['loss_fn'],
                                st['ds'].perms, None)

    with checks.Recorder() as rec:
        il, rl = step(0, targets[0])
        torch.cuda.synchronize()
    check_step(p, il, rl)
    for name in checks.BACKWARD:
        r = checks.run(name, rec.args)
        results[name] = dict(r, args=rec.args[name])
        print_compare(r)
    bad = [n for n in checks.BACKWARD if not results[n]['ok']]
    results['scatter']['each_launch'] = scatter_launches(
        rec.args['scatter_all'], bad)
    with torch.no_grad():
        for name in ('resolve', 'sample_guide', 'sample',
                     'denoise'):        # the step's forward kernels
            r = checks.run(name, rec.args, reps=2)
            print_compare(r, ' (step)')
            if not r['ok']:
                bad.append(name + ' (step)')
    del rec
    if bad:
        raise RuntimeError('kernels disagree with their plain versions: %s'
                           % bad)

    times = []
    kernels.reset_launches()
    for i in range(1, TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        il, rl = step(i, targets[i])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check_step(p, il, rl)
        print('step %d: %.2f ms, img_loss %.5f, reg_loss %.5f'
              % (i, times[-1], float(il), float(rl)), flush=True)
    launches = dict(kernels.LAUNCHES)
    print('launches (%d steps): %s' % (TRAIN_STEPS, launches), flush=True)
    for name, per in STEP_LAUNCHES.items():
        if launches[name] != per * TRAIN_STEPS:
            raise RuntimeError('kernel %s launched %d times in %d steps'
                               % (name, launches[name], TRAIN_STEPS))
    if launches['scatter'] < TRAIN_STEPS:
        raise RuntimeError('the row scatter launched %d times in %d steps'
                           % (launches['scatter'], TRAIN_STEPS))
    med = statistics.median(times)
    print('median ms per step: %.3f, iters/s %.3f (512x512, n_samples 4, '
          '1024^2 textures, spot 26474 tris)' % (med, 1e3 / med),
          flush=True)
    return launches, st, targets


def scatter_launches(calls, bad):
    """Hold every row scatter launch of the recorded step against its plain
    version (one compare line each), and the generic instance of the
    kernel on the largest launch's first 5 channels (the step's channel
    counts 3, 4, 6, 9 and 13 have instances of their own).  Returns each
    launch's arguments and check; appends failures to bad."""
    from nvdiffrecmc_tpu_torch import checks
    out = []
    for i, a in enumerate(calls):
        r = checks.check_scatter(*a)
        print_compare(r, ' (launch %d of %d)' % (i + 1, len(calls)))
        if not r['ok']:
            bad.append('scatter launch %d' % (i + 1))
        out.append(dict(r, args=a))
    idx, vals, rows = max(calls, key=lambda a: a[1].numel())
    r = checks.check_scatter(idx, vals[:, :5].contiguous(), rows, reps=2)
    print_compare(r, ' (generic instance)')
    if not r['ok']:
        bad.append('scatter, generic instance')
    return out


def _cos_close(g, w):
    g, w = g.reshape(-1).double(), w.reshape(-1).double()
    cos = float((g * w).sum() / (g.norm() * w.norm()))
    close = float(((g - w).abs() <= 1e-3 * w.abs().max()).double().mean())
    return cos, close


def small_step_agreement(device, layers=1):
    """One 64x64 step (n_samples 2, 256^2 textures) on the card and the same
    step on the CPU with the plain versions, from one target, one set of
    uniforms and jitter offsets for each depth-peel layer: losses within
    1e-4 relative; gradients of v_pos, kd, ks, normal and light with cosine
    >= 0.999 and >= 99% of the entries within 1e-3 max|g|.  kd gets seeded
    noise so that the smoothness term's |kd_jitter - kd| is off its kink
    (past one layer kd has 4 channels, and the noise puts its alpha in
    [0.7, 1])."""
    import numpy as np
    import torch
    from nvdiffrecmc_tpu_torch import train
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    res, n, tex = 64, 2, 256
    noise = np.random.RandomState(4).uniform(
        0.0, 0.3, (1, tex, tex, 4 if layers > 1 else 3)).astype(np.float32)
    gen = torch.Generator()
    gen.manual_seed(7)
    uniforms = [pallas_shade.make_uniforms(gen, n * n, res * res, n,
                                           device='cpu')
                for _ in range(layers)]
    offsets = [torch.randn((1, res, res, 2), generator=gen) * 0.005
               for _ in range(layers)]
    target = None
    out = {}
    for dev in ('cpu', device):
        st = train_setup(dev, res, n, tex, kd_noise=noise, layers=layers)
        if target is None:
            target = make_targets(st, 1, 3)[0]
        tgt = {k: (v.to(dev) if torch.is_tensor(v) else v)
               for k, v in target.items()}
        il, rl = train.compute_grads(
            st['geometry'], st['params'], st['static'], tgt, 0, st['FLAGS'],
            st['loss_fn'], st['ds'].perms, None,
            uniforms=[u.to(dev) for u in uniforms],
            offsets=[o.to(dev) for o in offsets])
        p = st['params']
        out[dev] = (float(il), float(rl),
                    {'v_pos': p['geo']['v_pos'].grad.cpu(),
                     'kd': p['mat']['kd'].grad.cpu(),
                     'ks': p['mat']['ks'].grad.cpu(),
                     'normal': p['mat']['normal'].grad.cpu(),
                     'light': p['light'].grad.cpu()})
    (ilc, rlc, gc), (ild, rld, gd) = out['cpu'], out[device]
    report = {'img_loss': (ild, ilc), 'reg_loss': (rld, rlc)}
    for a, b in report.values():
        if abs(a - b) > 1e-4 * abs(b):
            raise RuntimeError('64x64 step: losses %s' % report)
    for k in gc:
        cos, close = _cos_close(gd[k], gc[k])
        report[k] = (cos, close)
        if cos < 0.999 or close < 0.99:
            raise RuntimeError('64x64 step: gradient of %s: cosine %.6f, '
                               'share within 1e-3 max|g| %.4f'
                               % (k, cos, close))
    return report


# ---------------------------------------------------------------------------
# The standalone tracer and validation
# ---------------------------------------------------------------------------

def tracer_rays(mesh, n_rays, device):
    """bench.py's bench_tracer rays: seed 1, unit directions, origins on a
    sphere at 0.6 of the mesh's bounding radius around its box centre."""
    import numpy as np
    import torch
    v = mesh.v_pos.detach().cpu().numpy()
    centre = (v.min(0) + v.max(0)) * 0.5
    radius = float(np.linalg.norm(v - centre, axis=-1).max())
    rng = np.random.RandomState(1)
    n_ = rng.randn(n_rays, 3).astype(np.float32)
    n_ /= np.linalg.norm(n_, axis=-1, keepdims=True)
    d = rng.randn(n_rays, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro = (centre + n_ * 0.6 * radius).astype(np.float32)
    return (torch.as_tensor(ro, device=device),
            torch.as_tensor(d, device=device), radius)


def tracer_phase(mesh, device, results):
    """Phase 8: shadow Mrays/s, trace and mask against their plain
    versions on the bench rays."""
    import torch
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    from nvdiffrecmc_tpu_torch.ops import pallas_tracer
    bvh = bvh_mod.build(mesh.v_pos, mesh.t_pos_idx, leaf_size=128)
    ro, rd, radius = tracer_rays(mesh, TRACER_RAYS, device)
    pallas_tracer.any_hit_pallas(ro, rd, bvh)
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pallas_tracer.any_hit_pallas(ro, rd, bvh)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    print('tracer: %d rays, %d leaves, bounding radius %.4f; median %.3f ms '
          '(%s ms); shadow Mrays/s %.2f (%s)'
          % (TRACER_RAYS, bvh.n_leaves, radius, med,
             ' '.join('%.3f' % t for t in times),
             TRACER_RAYS / med / 1e3, smi_line()), flush=True)
    r = checks.check_trace(ro, rd, bvh)
    print_compare(r, ' (bench rays)')
    print_tests(checks.trace_work(ro, rd, bvh), ro.shape[0], bvh.sub_size,
                'bench rays')
    rayf = bvh_mod.ray_features(ro, rd)
    args = (rayf, bvh.aabb_lo, bvh.aabb_hi, 1024, 0.0, 1e16)
    rm = checks.check_mask(*args)
    print_compare(rm, ' (bench rays)')
    if not (r['ok'] and rm['ok']):
        raise RuntimeError('trace or mask disagrees with its plain version '
                           'on the bench rays')
    results['mask'] = dict(rm, args=args)
    return med


def profile_view(st, ds, device, out_path):
    """--profile: a kernel-only trace of one more render_eval of view 0:
    wall and device seconds, the idle share, device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nvdiffrecmc_tpu_torch import train
    FLAGS, p = st['FLAGS'], st['params']
    batch = ds.collate([ds[0]])
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    target = train.prepare_batch(batch, tuple(batch['img'].shape[1:3]),
                                 FLAGS['background'], gen, FLAGS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train.render_eval(st['geometry'], p['geo'], p['mat'], st['static'],
                          p['light'], target, FLAGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    key = 'self_device_time_total'
    if averages and not hasattr(averages[0], key):
        key = 'self_cuda_time_total'
    rows = sorted(((getattr(e, key) / 1e6, e.count, e.key) for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0.0:
        raise RuntimeError('the kernel-only trace saw no device time')
    with open(out_path, 'w') as f:
        f.write(averages.table(sort_by=key, row_limit=60))
    print('profile validation view (kernel-only trace): %.3f s wall, %.3f s '
          'device, %.3f s idle (%.1f%%), %d kernel launches'
          % (wall, busy, wall - busy, 100.0 * (wall - busy) / wall,
             sum(r[1] for r in rows)), flush=True)
    for sec, count, name in rows[:10]:
        print('profile validation view: %8.4f s  %7d launches  %s'
              % (sec, count, name[:80]), flush=True)


def validation_phase(st, device, results):
    """Phase 9: train.validate over 2 views at 512x512, n_samples 32, with
    the trained scene; per-view seconds, MSE, PSNR and launches; sample,
    trace and mask on the first stratum's inputs.  Returns the launch
    counts of the run."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, kernels, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (DatasetMesh,
                                                            spot256_scene)
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    FLAGS = st['FLAGS']
    ds = DatasetMesh(spot256_scene(device), CAM_RADIUS, FLAGS, validate=True)
    p = st['params']
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'chiprun_out', 'validate')
    frames = []
    render_eval = train.render_eval
    rec = checks.Recorder()

    def timed(*a, **k):
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if frames:
            buf = render_eval(*a, **k)
        else:
            with rec:       # the first view's kernel inputs
                buf = render_eval(*a, **k)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = {n: kernels.LAUNCHES[n] - before[n] for n in before}
        for k_, v in buf.items():
            if not bool(torch.isfinite(v).all()):
                raise RuntimeError('validation buffer %s is not finite' % k_)
        frames.append((sec, counts))
        return buf

    train.render_eval = timed
    try:
        kernels.reset_launches()
        avg_psnr = train.validate(
            st['geometry'], p['geo'], p['mat'], st['static'], p['light'], ds,
            out_dir, FLAGS, max_frames=VAL_FRAMES)
        launches = dict(kernels.LAUNCHES)
    finally:
        train.render_eval = render_eval
    lines = open(os.path.join(out_dir, 'metrics.txt')).read().splitlines()
    for i, (sec, counts) in enumerate(frames):
        print('validation view %d: %.3f s, %s; launches %s'
              % (i, sec, lines[1 + i], counts), flush=True)
        want = {n: 0 for n in counts}
        want.update(sample=VAL_N * VAL_N, trace=VAL_N * VAL_N, resolve=1,
                    sample_guide=1)
        if counts != want:
            raise RuntimeError('validation view %d launched %s, expected %s'
                               % (i, counts, want))
    print('validation: %s; average PSNR %.3f dB; launches in the run %s'
          % (lines[-1], avg_psnr, launches), flush=True)
    if not (len(frames) == VAL_FRAMES and avg_psnr == avg_psnr
            and abs(avg_psnr) != float('inf')):
        raise RuntimeError('validation gave %d views, PSNR %s'
                           % (len(frames), avg_psnr))
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith('.png'))
    if len(pngs) != 2 * VAL_FRAMES:
        raise RuntimeError('validation wrote %s' % pngs)
    print('validation: wrote metrics.txt and %d PNGs to %s'
          % (len(pngs), out_dir), flush=True)
    print('median s per validation view: %.3f (512x512, n_samples 32, '
          'spot 26474 tris; %s)' % (statistics.median(f[0] for f in frames),
                                    smi_line()), flush=True)

    ro, rd, bvh, tmin = rec.args['trace']
    u8 = rec.args['sample'][0]
    # covered pixels: the loop starts the rays of the others at BIG
    covered = ro[:u8.shape[2], 0] < 1e37
    with torch.no_grad():
        rr = checks.check_resolve(*rec.args['resolve'], reps=2)
        print_compare(rr, ' (validation view 0)')
        rs = checks.check_sample(*rec.args['sample'], mask=covered)
        print_compare(rs, ' (validation stratum 0, one stratum per launch: '
                      '%.4f ms)' % rs['ms'])
        r = checks.check_trace(ro, rd, bvh, tmin)
        print_compare(r, ' (validation stratum 0)')
        rm = checks.check_mask(bvh_mod.ray_features(ro, rd), bvh.aabb_lo,
                               bvh.aabb_hi, 1024, tmin, 1e16)
        lit = ro[:, 0] < 1e37
        print_tests(checks.trace_work(ro[lit], rd[lit], bvh, tmin),
                    int(lit.sum()), bvh.sub_size,
                    'validation stratum 0, covered rays')
    results['trace'] = dict(r, args=(ro, rd, bvh, tmin))
    print_compare(rm, ' (validation stratum 0)')
    if not (rr['ok'] and rs['ok'] and r['ok'] and rm['ok']):
        raise RuntimeError('resolve, sample, trace or mask disagrees with '
                           'its plain version on validation view 0')
    return launches


def small_validation_agreement(device):
    """A 32x32 validation frame of the spot scene at n_samples
    SMALL_VAL_N, through the stratum loop: kernels on the card vs plain
    versions on the CPU, the same uniforms."""
    import torch
    from nvdiffrecmc_tpu_torch import config, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import pallas_shade, vecmath
    res, n = 32, SMALL_VAL_N
    gen = torch.Generator()
    gen.manual_seed(9)
    uniforms = pallas_shade.make_uniforms(gen, n * n, res * res, n,
                                          device='cpu')
    shaded = {}
    for dev in (device, 'cpu'):
        mesh = spot256_scene(dev)
        FLAGS = config.make_flags(train_res=[res, res], n_samples=2,
                                  envlight=SPOT256_PROBE)
        ds = DatasetMesh(mesh, CAM_RADIUS, FLAGS, validate=True)
        geometry = DLMesh(ds.ref_mesh, FLAGS)
        _, mvp, campos, r = ds._rotate_scene(0)
        mat = mesh.material
        target = {'mvp': torch.as_tensor(mvp, device=dev),
                  'campos': torch.as_tensor(campos, device=dev),
                  'resolution': r,
                  'background': torch.as_tensor(vecmath.checkerboard(
                      r, 8), device=dev)[None]}
        buf = train.render_eval(
            geometry, geometry.parameters(),
            {'kd': mat['kd'].data, 'ks': mat['ks'].data},
            {'bsdf': 'pbr', 'no_perturbed_nrm': False,
             'min_max': {'kd': None, 'ks': None}}, ds.envlight, target,
            FLAGS, n_samples=n,
            uniforms=[uniforms.to(dev)])
        shaded[dev] = buf['shaded'].cpu()
    diff = (shaded[device] - shaded['cpu']).abs().amax(-1)
    share = float((diff <= 1e-3).float().mean())
    if share < 0.99:
        raise RuntimeError('32x32 validation frame: only %.4f of pixels '
                           'within 1e-3 of the plain CPU render' % share)
    return share, float(diff.max())


# ---------------------------------------------------------------------------
# The pass-2 program
# ---------------------------------------------------------------------------

def program_setup(work, base_mesh=True, out_dir='spot', iters=PROGRAM_ITERS,
                  validate=False):
    """The scene and config of phases 12 and 13 in work/: the reference's
    MTL override and a config of configs/spot.json's keys over the spot256
    scene, iters iterations, a probe and a checkpoint every 10, out_dir
    under work.  base_mesh: phase 12's base mesh (spot256's geometry,
    constant kd 0.5 and ks (0, 0.5, 0) at 512x512, written by the port's
    write_obj); without it the program runs pass 1 first.  Returns the
    config's path."""
    import torch
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_DIR, SPOT256_PROBE, spot256_scene)
    from nvdiffrecmc_tpu_torch.render import obj as obj_mod
    from nvdiffrecmc_tpu_torch.render import texture as texture_mod
    os.makedirs(work, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, 'configs', 'spot.json')) as f:
        cfg = json.load(f)
    if base_mesh:
        mesh = spot256_scene('cpu')
        mesh.material = {
            'bsdf': 'pbr',
            'kd': texture_mod.Texture2D(data=torch.full((1, 512, 512, 3),
                                                        0.5)),
            'ks': texture_mod.Texture2D(data=torch.tensor(
                [0.0, 0.5, 0.0]).expand(1, 512, 512, 3).contiguous())}
        os.makedirs(os.path.join(work, 'base'))
        obj_mod.write_obj(os.path.join(work, 'base'), mesh)
        cfg['base_mesh'] = os.path.join(work, 'base', 'mesh.obj')
    mtl = os.path.join(work, 'spot256.mtl')
    with open(mtl, 'w') as f:
        f.write('newmtl defaultMat\nbsdf pbr\nmap_Kd %s\nKs 0 0.5 0\n'
                % os.path.join(SPOT256_DIR, 'texture_kd.png'))
    cfg.update(ref_mesh=os.path.join(SPOT256_DIR, 'mesh.obj'),
               mtl_override=mtl, envlight=SPOT256_PROBE, iter=iters,
               save_interval=10, checkpoint_interval=10, validate=validate,
               out_root=work, out_dir=out_dir)
    path = os.path.join(work, 'config_%s.json' % out_dir)
    with open(path, 'w') as f:
        json.dump(cfg, f, indent=1)
    return path


def run_program(argv, log_path, timeout=PROGRAM_TIMEOUT):
    """python3 -m nvdiffrecmc_tpu_torch.train argv in this checkout; its
    output goes to log_path.  Returns the output's lines; raises on a
    non-zero exit."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'nvdiffrecmc_tpu_torch.train'] + argv,
        cwd=here, capture_output=True, text=True, timeout=timeout)
    with open(log_path, 'w') as f:
        f.write(proc.stdout + proc.stderr)
    print('program %s: exit %d, %.1f s (log %s)'
          % (' '.join(argv), proc.returncode, time.perf_counter() - t0,
             log_path), flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], flush=True)
        raise RuntimeError('the program exited with %d' % proc.returncode)
    return proc.stdout.splitlines()


def _after(lines, prefix):
    """The rest of each line that starts with prefix."""
    return [ln[len(prefix):] for ln in lines if ln.startswith(prefix)]


def _finite(x):
    return x == x and abs(x) != float('inf')


def batch4_checks(device):
    """One recorded pass-2 step at spot.json's batch 4 (512x512 textures,
    four DatasetMesh targets over random backgrounds): each kernel of the
    step held against its plain version at the shapes the program gives
    it, every row scatter launch among them.  Returns each kernel's
    check."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, train
    st = train_setup(device, RES, N_SAMPLES, 512)
    ds, FLAGS, p = st['ds'], st['FLAGS'], st['params']
    gen = torch.Generator(device=device)
    gen.manual_seed(23)
    target = train.prepare_batch(ds.collate([ds[i] for i in range(4)]),
                                 FLAGS['train_res'], 'random', gen, FLAGS)
    with checks.Recorder() as rec:
        il, rl = train.train_step(st['geometry'], p, st['opts'], st['static'],
                                  target, 0, FLAGS, st['loss_fn'], ds.perms,
                                  gen)
        torch.cuda.synchronize()
    check_step(p, il, rl)
    out, bad = {}, []
    with torch.no_grad():
        for name in checks.FORWARD + checks.BACKWARD:
            r = checks.run(name, rec.args, reps=2)
            print_compare(r, ' (batch 4)')
            out[name] = r
            if not r['ok']:
                bad.append(name)
        for i, a in enumerate(rec.args['scatter_all']):
            r = checks.check_scatter(*a, reps=2)
            print_compare(r, ' (batch 4, launch %d of %d)'
                          % (i + 1, len(rec.args['scatter_all'])))
            if not r['ok']:
                bad.append('scatter launch %d' % (i + 1))
    if bad:
        raise RuntimeError('kernels disagree with their plain versions at '
                           'batch 4: %s' % bad)
    return out


def pass_summary(lines, pass_name):
    """(median ms per step, kernel launches per step) from the program's
    `<pass_name>: N steps ...` line."""
    import re
    summary = [x for x in _after(lines, pass_name + ': ') if 'steps' in x][0]
    med = float(re.search(r'median ([\d.]+) ms', summary).group(1))
    return med, json.loads(summary.split('kernel launches per step ')[1])


def check_program_log(lines, n_passes, iters=PROGRAM_ITERS, probe_every=10):
    """The program's losses and probe PSNRs, all finite, one log line each
    10 iterations and one probe each probe_every iterations of each pass
    (none for 0).  Returns the PSNRs and the seconds of each probe."""
    import re
    losses = [float(x) for ln in _after(lines, 'iter=')
              for x in re.findall(r'_loss=([-+\w.]+)', ln)]
    psnrs = [float(x.split()[-2]) for x in _after(lines, '[probe] iter=')
             if 'PSNR' in x]
    logged = n_passes * len(range(0, iters, 10))
    probed = n_passes * len(range(0, iters, probe_every)) \
        if probe_every else 0
    if len(losses) != 2 * logged or len(psnrs) != probed or not all(
            _finite(x) for x in losses + psnrs):
        raise RuntimeError('program losses %s, probe PSNRs %s'
                           % (losses, psnrs))
    probe_s = [float(x.split()[-2]) for x in _after(lines, '[probe] iter=')
               if 'took' in x]
    return psnrs, probe_s


def check_step_launches(per_step, label, micro_steps=1, layers=1):
    """Each kernel launched per step as STEP_LAUNCHES says, times the
    step's micro-steps and its depth-peel layers."""
    wrong = {n: per_step[n] for n in STEP_LAUNCHES
             if per_step[n] != STEP_LAUNCHES[n] * micro_steps * layers}
    if wrong or per_step['scatter'] < micro_steps:
        raise RuntimeError('%s: kernel launches per step %s'
                           % (label, wrong or per_step))


def check_mesh_dir(mesh_dir):
    """The export's files; the OBJ read back.  Returns (files, the mesh,
    probe.hdr's shape)."""
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    from nvdiffrecmc_tpu_torch.render import obj as obj_mod
    files = sorted(os.listdir(mesh_dir))
    if files != ['mesh.mtl', 'mesh.obj', 'probe.hdr', 'texture_kd.png',
                 'texture_ks.png', 'texture_n.png']:
        raise RuntimeError('%s holds %s' % (mesh_dir, files))
    back = obj_mod.load_obj(os.path.join(mesh_dir, 'mesh.obj'), device='cpu')
    probe = light_mod._read_hdr(os.path.join(mesh_dir, 'probe.hdr'))
    if probe.shape != (512, 1024, 3):
        raise RuntimeError('%s/probe.hdr is %s' % (mesh_dir, probe.shape))
    return files, back, probe.shape


def check_boundary(lines, out, label):
    """The pass boundary of a two-pass program, from its log and
    out/dmtet_mesh/ read back: the bake holds every surface
    triangle pass 1 ends with, less the prune's drops, covers texels of kd
    and ks, and has no face of zero area (float64 areas of the read-back
    float32 vertices); raises otherwise.  Returns (the baked mesh, its
    pass-2 BVH leaf size)."""
    import re
    import torch
    end = [x for x in _after(lines, 'dmtet_pass1: ') if 'slots' in x][0]
    n1 = int(end.split()[0])
    dropped = sum(int(x.split()[0]) for x in
                  _after(lines, 'prune_small_components: dropped '))
    b = _after(lines, 'pass boundary: ')[0]
    T, V = (int(x) for x in re.match(r'(\d+) triangles, (\d+) vertices',
                                     b).groups())
    covered, texels, leaf = (int(x) for x in re.search(
        r'(\d+) of (\d+) texels covered; pass 2 BVH leaf size (\d+)',
        b).groups())
    _, mesh, _ = check_mesh_dir(os.path.join(out, 'dmtet_mesh'))
    v = mesh.v_pos.double()
    f = mesh.t_pos_idx.long()
    area = torch.linalg.cross(v[f[:, 1]] - v[f[:, 0]],
                              v[f[:, 2]] - v[f[:, 0]]).norm(dim=1)
    zero = int((area == 0).sum())
    print('%s boundary: pass 1 ends with %d surface triangles, the prune '
          'drops %d; the bake %d triangles (%d read back), %d vertices, %d '
          'of zero area (smallest area %.3e); %d of %d texels covered; pass '
          '2 BVH leaf size %d; %s (%s)'
          % (label, n1, dropped, T, f.shape[0], V, zero, float(area.min()),
             covered, texels, leaf, b.split('; ')[1], smi_line()),
          flush=True)
    if T != n1 - dropped or f.shape[0] != T:
        raise RuntimeError('%s: the bake has %d triangles (%d read back), '
                           'not the %d - %d pass 1 ends with'
                           % (label, T, f.shape[0], n1, dropped))
    if zero:
        raise RuntimeError('%s: the bake has %d faces of zero area'
                           % (label, zero))
    if covered == 0:
        raise RuntimeError('%s: the bake covers no texel of kd and ks'
                           % label)
    return mesh, leaf


def drop_checkpoints(folder):
    """Delete the program's checkpoints in folder once read (pass 1's
    holds the 2^23-row table and its Adam moments, ~200 MB), so that
    chiprun_out/ stays small enough to come back."""
    for name in sorted(os.listdir(folder)):
        if name.endswith('.pkl'):
            path = os.path.join(folder, name)
            print('dropping %s (%.1f MB)'
                  % (path, os.path.getsize(path) / 2 ** 20), flush=True)
            os.remove(path)


def check_metrics(folder, views):
    """folder/metrics.txt: views finite PSNRs and the averages line.
    Returns that line."""
    rows = open(os.path.join(folder, 'metrics.txt')).read().splitlines()
    if len(rows) != views + 2 or not rows[-1].startswith('AVERAGES') or \
            not all(_finite(float(r.split(',')[2])) for r in rows[1:-1]):
        raise RuntimeError('%s/metrics.txt: %s' % (folder, rows))
    return rows[-1]


def program_phase():
    """Phase 12: a recorded step at batch 4 against the plain versions,
    the program at spot.json's batch 4 on the base mesh (no validation:
    phase 13's pass 2 validates), then its resume.  Returns (the kernel
    launches of the program's first run, per step there, each kernel's
    check at batch 4)."""
    import numpy as np
    import torch
    from nvdiffrecmc_tpu_torch.render import texture as texture_mod
    here = os.path.dirname(os.path.abspath(__file__))
    at_batch_4 = batch4_checks('cuda')
    work = os.path.join(here, 'chiprun_out', 'train_cli')
    shutil.rmtree(work, ignore_errors=True)
    cfg = program_setup(work)
    torch.cuda.empty_cache()
    lines = run_program(['--config', cfg], os.path.join(work, 'run.log'))
    relay = ('iter=', '[probe]', 'Resumed', 'peak device memory',
             'mesh_pass:', 'export:')
    for ln in lines:
        if ln.startswith(relay):
            print('program | ' + ln, flush=True)
    _, probe_s = check_program_log(lines, 1)
    med, per_step = pass_summary(lines, 'mesh_pass')
    launches = json.loads(_after(lines, 'kernel launches: ')[0])
    export_s = float(_after(lines, 'export: ')[0].split()[0])
    peak = float(_after(lines, 'peak device memory: ')[0].split()[0])
    print('program: median %.3f ms per step at batch 4 (%d steps), peak '
          'device memory %.3f GiB, %s s per probe, export %.3f s (%s)'
          % (med, PROGRAM_ITERS, peak, ', '.join('%.3f' % x for x in probe_s),
             export_s, smi_line()), flush=True)
    print('program: kernel launches %s; per step %s' % (launches, per_step),
          flush=True)
    idle = [n for n, c in launches.items()
            if c == 0 and n not in ('mask',) + OPTION_KERNELS]
    if idle:
        raise RuntimeError('program: kernels not launched %s' % idle)
    check_step_launches(per_step, 'program')

    out = os.path.join(work, 'spot')
    files, back, probe_shape = check_mesh_dir(os.path.join(out, 'mesh'))
    ckpt = torch.load(os.path.join(out, 'checkpoint_mesh_pass.pkl'),
                      map_location='cpu', weights_only=True)
    v_err = float((back.v_pos - ckpt['params']['geo']['v_pos']).abs().max())
    kd = texture_mod.load_image(os.path.join(out, 'mesh', 'texture_kd.png'))
    gray = texture_mod.load_image(os.path.join(work, 'base',
                                               'texture_kd.png'))
    kd_moved = float(np.abs(kd - gray).mean())
    print('program: mesh/ %s; OBJ read back: %d triangles, v_pos within '
          '%.2e of the checkpoint (iteration %d); probe.hdr %s; exported kd '
          '%.4f from the initial gray on average'
          % (files, back.t_pos_idx.shape[0], v_err, ckpt['iteration'],
             probe_shape, kd_moved), flush=True)
    if back.t_pos_idx.shape[0] != 26474 or v_err > 1e-5 or \
            kd_moved < 1.0 / 255.0:
        raise RuntimeError('the exported mesh or kd is wrong')

    lines = run_program(['--config', cfg, '-i', '12'],
                        os.path.join(work, 'resume.log'))
    for ln in lines:
        if ln.startswith(('Resumed', 'mesh_pass:')):
            print('program (resume) | ' + ln, flush=True)
    resumed = _after(lines, 'Resumed ')
    if not (resumed and resumed[0].endswith('from iteration 11')
            and _after(lines, 'mesh_pass: 1 steps from iteration 11')):
        raise RuntimeError('the program did not resume from iteration 11 '
                           'for one step')
    drop_checkpoints(out)
    return launches, per_step, at_batch_4


# ---------------------------------------------------------------------------
# Pass 1 (DMTet + the hash-grid material), the pass boundary, both passes
# ---------------------------------------------------------------------------

def pass1_setup(device, res=RES, batch=4, grid=64):
    """Pass 1's state at configs/spot.json's settings (batch 4, 512x512,
    n_samples 4, lr 0.03, the trainable light) with the JAX package's
    defaults for what spot.json leaves out (DMTet grid 64, mesh_scale 2.1,
    24 grid^2 triangle slots, the default HashEncodingConfig, a 32-wide
    MLP of 2 hidden layers), PROGRAM_ITERS iterations for the schedules,
    on the spot256 dataset.  Returns the dict of train_setup."""
    from nvdiffrecmc_tpu_torch import config, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DMTetGeometry
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    FLAGS = config.make_flags(
        train_res=[res, res], n_samples=N_SAMPLES, batch=batch,
        texture_res=[512, 512], learning_rate=[0.03, 0.01],
        ks_min=[0, 0.1, 0.0], ks_max=[0, 1.0, 1.0], background='white',
        iter=PROGRAM_ITERS, envlight=SPOT256_PROBE, dmtet_grid=grid)
    ds = DatasetMesh(spot256_scene(device), CAM_RADIUS, FLAGS, seed=5)
    geometry = DMTetGeometry(grid, FLAGS['mesh_scale'], FLAGS, device=device)
    mat_params, mat_static = train.initial_guess_material(
        geometry, True, FLAGS, device=device)
    mat_static['no_perturbed_nrm'] = True
    light = light_mod.create_trainable_env_rnd(FLAGS['probe_res'], 0.0, 0.5,
                                               device=device)
    params = train.make_params(geometry, mat_params, light)
    return dict(FLAGS=FLAGS, ds=ds, geometry=geometry, params=params,
                static=mat_static, opts=train.make_optimizers(params, FLAGS),
                loss_fn=train.createLoss(FLAGS))


class FullScreenCount:
    """Counts, in each rasterize call made inside it, the triangles of each
    image that the resolve gives the whole screen: valid ones with a
    vertex at w <= 1e-6.  counts: one list per call."""

    def __init__(self):
        self.counts = []

    def __enter__(self):
        import torch
        from nvdiffrecmc_tpu_torch.ops import pallas_raster, rasterizer
        self._orig = orig = pallas_raster.resolve_batch

        def wrapped(v_clip, tri, *a):
            with torch.no_grad():
                valid = [rasterizer._tri_setup(v, tri)[4] for v in v_clip]
                w = v_clip[:, tri.long(), 3].amin(-1)          # [N, T]
                self.counts.append([int((ok & (wn <= 1e-6)).sum())
                                    for ok, wn in zip(valid, w)])
            return orig(v_clip, tri, *a)
        pallas_raster.resolve_batch = wrapped
        return self

    def __exit__(self, *exc):
        from nvdiffrecmc_tpu_torch.ops import pallas_raster
        pallas_raster.resolve_batch = self._orig
        return False


def hashgrid_scatter(args):
    """Row 7 at pass 1's largest launch, the hash-grid table's cotangent
    (C = 2): the C = 2 instance (its check), the generic instance and
    index_add_ on the same input, and the bound."""
    from nvdiffrecmc_tpu_torch import checks
    idx, vals, rows = args
    r = checks.check_scatter(idx, vals, rows, reps=3)
    g = checks.check_scatter(idx, vals, rows, reps=3, generic=True)
    b = checks.bound('scatter', args)
    r.update(generic_ms=g['ms'], generic_ok=g['ok'],
             library_ms=checks.library_ms('scatter', args, reps=3),
             bound_ms=b['bound_ms'], bound_by=b['bound_by'])
    print_compare(r, ' (pass 1, the hash-grid table)')
    print_compare(g, ' (pass 1, the hash-grid table, generic instance)')
    r['ok'] = r['ok'] and g['ok']
    print('hash-grid scatter (C = 2): %s; instance %.3f ms, generic %.3f ms, '
          'index_add_ %.3f ms, bound %.3f ms by %s (%s)'
          % (r['compared_on'], r['ms'], r['generic_ms'], r['library_ms'],
             r['bound_ms'], r['bound_by'], smi_line()), flush=True)
    return r


def pass1_checks(device):
    """Phase 13, in this process: one recorded pass-1 step at batch 4
    (iteration PASS1_IT, so that the shadow and denoiser ramps are under
    way), each of its kernels against its plain version (every row scatter
    launch among them, the hash-grid table's at C = 2 timed against the
    generic instance and index_add_); then PASS1_STEPS steps, their ms,
    launches, the full-screen triangles of each image and the triangle
    count.  Returns (the checks, the hash-grid scatter's row, launches per
    step, the state)."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, kernels, train
    torch.cuda.reset_peak_memory_stats()
    st = pass1_setup(device)
    ds, FLAGS, p = st['ds'], st['FLAGS'], st['params']
    gen = torch.Generator(device=device)
    gen.manual_seed(29)
    targets = [train.prepare_batch(
        ds.collate([ds[4 * i + j] for j in range(4)]), FLAGS['train_res'],
        'random', gen, FLAGS) for i in range(PASS1_STEPS + 1)]

    def step(it, target):
        return train.train_step(st['geometry'], p, st['opts'], st['static'],
                                target, it, FLAGS, st['loss_fn'], ds.perms,
                                gen)
    with FullScreenCount() as full:
        with checks.Recorder() as rec:
            il, rl = step(PASS1_IT, targets[0])
            torch.cuda.synchronize()
        check_step(p, il, rl)
        out, bad = {}, []
        with torch.no_grad():
            for name in checks.FORWARD + checks.BACKWARD:
                if name == 'scatter':
                    continue
                r = checks.run(name, rec.args, reps=2)
                print_compare(r, ' (pass 1, batch 4)')
                out[name] = r
                if not r['ok']:
                    bad.append(name)
            calls = rec.args['scatter_all']
            big = max(range(len(calls)), key=lambda i: calls[i][1].numel())
            for i, a in enumerate(calls):
                if i == big:
                    r = out['scatter'] = hashgrid_scatter(a)
                else:
                    r = checks.check_scatter(*a, reps=2)
                    print_compare(r, ' (pass 1, batch 4, launch %d of %d)'
                                  % (i + 1, len(calls)))
                if not r['ok']:
                    bad.append('scatter launch %d' % (i + 1))
        del rec, calls
        if bad:
            raise RuntimeError('kernels disagree with their plain versions '
                               'at pass 1: %s' % bad)
        times = []
        kernels.reset_launches()
        for i in range(1, PASS1_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            il, rl = step(PASS1_IT + i, targets[i])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check_step(p, il, rl)
            n, cap = st['geometry'].tri_count(p['geo'])
            print('pass 1 step %d: %.2f ms, img_loss %.5f, reg_loss %.5f, '
                  '%d surface triangles of %d slots'
                  % (PASS1_IT + i, times[-1], float(il), float(rl), n, cap),
                  flush=True)
        per_step = {k: v / PASS1_STEPS for k, v in kernels.LAUNCHES.items()}
    check_step_launches(per_step, 'pass 1 (in this process)')
    for i, c in enumerate(full.counts):
        print('pass 1 step %d: triangles with a vertex at w <= 1e-6 (whole-'
              'screen rectangles) per image %s' % (PASS1_IT + i, c),
              flush=True)
    print('pass 1 in this process: median %.3f ms per step over %d steps '
          '(batch 4, 512x512, n_samples 4, grid 64, %d slots); launches per '
          'step %s; peak device memory %.3f GiB (%s)'
          % (statistics.median(times), PASS1_STEPS,
             st['geometry'].max_tris, per_step,
             torch.cuda.max_memory_allocated() / 2 ** 30, smi_line()),
          flush=True)
    return out, per_step, st, targets


def two_pass_program():
    """Phase 13, the program: configs/spot.json's keys with no base_mesh,
    PROGRAM_ITERS iterations in each pass, a checkpoint every 10, no probe
    and no validation (phase 14's program runs both validations, phase 12
    its probes), in
    chiprun_out/train_two_pass/.  Returns (the kernel launches of the
    run, per pass-1 step)."""
    import re
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, 'chiprun_out', 'train_two_pass')
    shutil.rmtree(work, ignore_errors=True)
    cfg = program_setup(work, base_mesh=False)
    torch.cuda.empty_cache()
    lines = run_program(['--config', cfg, '-si', '0'],
                        os.path.join(work, 'run.log'))
    relay = ('iter=', '[probe]', 'WARNING', 'peak device memory',
             'dmtet_pass1:', 'prune_small', 'pass boundary:', 'Base mesh',
             'mesh_pass:', 'export:')
    for ln in lines:
        if ln.startswith(relay):
            print('two passes | ' + ln, flush=True)
    check_program_log(lines, 2, PROGRAM_ITERS, 0)
    med1, per_step1 = pass_summary(lines, 'dmtet_pass1')
    med2, per_step2 = pass_summary(lines, 'mesh_pass')
    tris = [x for x in _after(lines, 'dmtet_pass1: ') if 'slots' in x][0]
    boundary = _after(lines, 'pass boundary: ')[0]
    launches = json.loads(_after(lines, 'kernel launches: ')[0])
    peak = float(_after(lines, 'peak device memory: ')[0].split()[0])
    secs = dict(re.findall(r'(extract|prune|unwrap|bake) ([\d.]+) s',
                           boundary))
    print('two passes: pass 1 median %.3f ms per step, pass 2 %.3f ms (batch '
          '4, %d steps each); pass 1 ends with %s; boundary: extract %s s, '
          'prune %s s, unwrap %s s, bake %s s; peak device memory %.3f GiB '
          '(%s)' % (med1, med2, PROGRAM_ITERS, tris, secs['extract'],
                    secs['prune'], secs['unwrap'], secs['bake'], peak,
                    smi_line()), flush=True)
    print('two passes: kernel launches %s; per pass-1 step %s; per pass-2 '
          'step %s' % (launches, per_step1, per_step2), flush=True)
    check_step_launches(per_step1, 'pass 1')
    check_step_launches(per_step2, 'pass 2')
    if 'OVERFLOW' in tris:
        print('two passes: WARNING, marching tets overflowed at the end of '
              'pass 1', flush=True)
    out = os.path.join(work, 'spot')
    mesh1, _ = check_boundary(lines, out, 'two passes')
    _, mesh2, _ = check_mesh_dir(os.path.join(out, 'mesh'))
    print('two passes: dmtet_mesh/ %d triangles, %d vertices; mesh/ %d '
          'triangles' % (mesh1.t_pos_idx.shape[0], mesh1.v_pos.shape[0],
                         mesh2.t_pos_idx.shape[0]), flush=True)
    if mesh1.t_pos_idx.shape[0] == 0 or \
            mesh2.t_pos_idx.shape[0] != mesh1.t_pos_idx.shape[0]:
        raise RuntimeError('the baked mesh is empty or pass 2 changed it')
    drop_checkpoints(out)
    return launches, per_step1


# ---------------------------------------------------------------------------
# The NeRF scene: both passes at batch 8 in micro-steps of 1, 800x800
# ---------------------------------------------------------------------------

def nerf_one_test_view():
    """A copy of data/nerf_synthetic_spot whose transforms_test.json holds
    its first view only (the rest links to the repo's files), under
    build/nvdiffrecmc_tpu_torch/.  Returns its path."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, 'data', 'nerf_synthetic_spot')
    dst = os.path.join(here, 'build', 'nvdiffrecmc_tpu_torch',
                       'nerf_spot_one_test_view')
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    for name in ('train', 'test', 'transforms_train.json'):
        os.symlink(os.path.join(src, name), os.path.join(dst, name))
    with open(os.path.join(src, 'transforms_test.json')) as f:
        test = json.load(f)
    test['frames'] = test['frames'][:1]
    with open(os.path.join(dst, 'transforms_test.json'), 'w') as f:
        json.dump(test, f)
    return dst


def nerf_setup(work, config, iters, validate, ref_mesh=None, probes=True):
    """config as shipped, but iters iterations a pass, validate, out_root
    work, data_root this checkout, when given ref_mesh, and without
    probes save_interval 0, written into work/.  Returns its path."""
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, config)) as f:
        cfg = json.load(f)
    cfg.update(iter=iters, validate=validate, out_root=work, data_root=here)
    if not probes:
        cfg['save_interval'] = 0
    if ref_mesh is not None:
        cfg['ref_mesh'] = ref_mesh
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, 'config.json')
    with open(path, 'w') as f:
        json.dump(cfg, f, indent=1)
    return path


def nerf_program(config, iters, validate, label, probes=True, ref_mesh=None,
                 micro_batch=None):
    """Phases 14, 15 and 18, the program: config (a NeRF or LLFF config of
    the spot scene) as nerf_setup writes it (without its probes unless
    probes; with ref_mesh when given), in chiprun_out/train_<label>/
    (spaces as underscores; cleared first), with --micro-batch
    micro_batch when given; with validate, on nerf_one_test_view's copy
    of the scene, so that each validation renders NERF_VIEWS view.
    Relays and prints each pass's median ms per step, micro-steps and
    launches per step, the surface triangles at the end of pass 1 and
    every overflow warning, the boundary (check_boundary), s per view and
    PSNR of both validations when validate, the probes and peak device
    memory; checks losses and PSNRs finite, both metrics.txt, batch /
    micro_batch micro-steps a step, mesh/ read back with the bake's
    triangles, every kernel but the mask launched (the trace only in
    validation), peak memory under the card's.  Returns a dict: the
    argv, the kernel launches of the run, per pass-1 step and per pass-2
    step, each pass's median ms per step, the peak memory, the bake's OBJ
    and its pass-2 leaf size."""
    import re
    import torch
    from nvdiffrecmc_tpu_torch import config as config_mod
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, 'chiprun_out',
                        'train_' + label.replace(' ', '_'))
    shutil.rmtree(work, ignore_errors=True)
    if ref_mesh is None and validate:
        ref_mesh = nerf_one_test_view()
    cfg = nerf_setup(work, config, iters, validate, ref_mesh, probes)
    argv = ['--config', cfg]
    if micro_batch is not None:
        argv += ['--micro-batch', str(micro_batch)]
    F = config_mod.parse_flags(argv)
    n_micro = config_mod.micro_slices(F)
    torch.cuda.empty_cache()
    lines = run_program(argv, os.path.join(work, 'run.log'),
                        timeout=NERF_TIMEOUT)
    relay = ('DatasetNERF', 'DatasetLLFF', 'iter=', '[probe]', 'WARNING',
             'MSE', 'peak device memory', 'dmtet_pass1:', 'dmtet_validate:',
             'prune_small', 'pass boundary:', 'Base mesh', 'mesh_pass:',
             'validation:', 'export:')
    for i, ln in enumerate(lines):
        if ln.startswith(relay) or (i and lines[i - 1].startswith('MSE')):
            print(label + ' | ' + ln, flush=True)
    psnrs, probe_s = check_program_log(lines, 2, iters, 100 if probes else 0)
    med1, per_step1 = pass_summary(lines, 'dmtet_pass1')
    med2, per_step2 = pass_summary(lines, 'mesh_pass')
    micro = [int(x) for x in re.findall(r'of (\d+) micro-steps',
                                        '\n'.join(lines))]
    tris = [x for x in _after(lines, 'dmtet_pass1: ') if 'slots' in x][0]
    overflows = len([x for x in lines if 'OVERFLOW' in x])
    launches = json.loads(_after(lines, 'kernel launches: ')[0])
    peak = float(_after(lines, 'peak device memory: ')[0].split()[0])
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    out = os.path.join(work, os.path.splitext(os.path.basename(config))[0])
    views = 'no validation'
    if validate:
        val1 = float(_after(lines, 'dmtet_validate: ')[0].split()[0])
        val2 = float(_after(lines, 'validation: ')[0].split()[0])
        views = ('dmtet_validate %.3f s per view (%s), validate %.3f s per '
                 'view (%s)' % (
                     val1 / NERF_VIEWS,
                     check_metrics(os.path.join(out, 'dmtet_validate'),
                                   NERF_VIEWS),
                     val2 / NERF_VIEWS,
                     check_metrics(os.path.join(out, 'validate'),
                                   NERF_VIEWS)))
    print('%s: pass 1 median %.3f ms per step, pass 2 %.3f ms (batch %d in '
          '%s micro-steps, %dx%d, n_samples %d, grid %d, %d steps each); '
          'pass 1 ends with %s; %d overflow lines; %s; probes PSNR %s dB, %s '
          's; peak device memory %.3f GiB of the card\'s %.3f (%s)'
          % (label, med1, med2, F['batch'], micro, *F['train_res'],
             F['n_samples'], F['dmtet_grid'], iters, tris, overflows, views,
             psnrs, probe_s, peak, card, smi_line()), flush=True)
    print('%s: kernel launches %s; per pass-1 step %s; per pass-2 step %s'
          % (label, launches, per_step1, per_step2), flush=True)
    if micro != [n_micro, n_micro]:
        raise RuntimeError('%s: micro-steps per step %s, not %d'
                           % (label, micro, n_micro))
    check_step_launches(per_step1, label + ' pass 1', n_micro)
    check_step_launches(per_step2, label + ' pass 2', n_micro)
    unused = (('mask',) if validate else ('mask', 'trace')) + OPTION_KERNELS
    idle = [n for n, c in launches.items() if c == 0 and n not in unused]
    if idle:
        raise RuntimeError('%s: kernels not launched %s' % (label, idle))
    if not peak < card:
        raise RuntimeError('%s: peak device memory %.3f GiB' % (label, peak))
    mesh1, leaf = check_boundary(lines, out, label)
    _, mesh2, _ = check_mesh_dir(os.path.join(out, 'mesh'))
    print('%s: dmtet_mesh/ %d triangles, %d vertices; mesh/ %d triangles'
          % (label, mesh1.t_pos_idx.shape[0], mesh1.v_pos.shape[0],
             mesh2.t_pos_idx.shape[0]), flush=True)
    if mesh2.t_pos_idx.shape[0] != mesh1.t_pos_idx.shape[0]:
        raise RuntimeError('%s: pass 2 changed the baked mesh' % label)
    drop_checkpoints(out)
    return dict(argv=argv, launches=launches, per_step1=per_step1,
                per_step2=per_step2, med1=med1, med2=med2, peak=peak,
                bake=os.path.join(out, 'dmtet_mesh', 'mesh.obj'), leaf=leaf)


def _peak_gib(run):
    """Peak device memory (GiB) while run() runs, above what was held
    before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    run()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2 ** 30


def micro_step_checks(rec, label):
    """Each kernel of a recorded micro-step against its plain version,
    every row scatter launch among them.  Returns the checks (the row
    scatter's is its largest launch); raises on a disagreement."""
    import torch
    from nvdiffrecmc_tpu_torch import checks
    out, bad = {}, []
    with torch.no_grad():
        for name in checks.FORWARD + checks.BACKWARD:
            if name == 'scatter':
                continue
            r = checks.run(name, rec.args, reps=2)
            print_compare(r, ' (%s)' % label)
            out[name] = r
            if not r['ok']:
                bad.append(name)
        calls = rec.args['scatter_all']
        big = max(range(len(calls)), key=lambda i: calls[i][1].numel())
        for i, a in enumerate(calls):
            r = checks.check_scatter(*a, reps=2)
            print_compare(r, ' (%s, launch %d of %d)'
                          % (label, i + 1, len(calls)))
            if i == big:
                out['scatter'] = r
            if not r['ok']:
                bad.append('scatter launch %d' % (i + 1))
    if bad:
        raise RuntimeError('kernels disagree with their plain versions at '
                           'the %s: %s' % (label, bad))
    return out


def stratum0_rays(samp, gb, n_rays):
    """Up to n_rays of stratum 0's shadow rays (light and BSDF
    directions) from the covered pixels of a recorded trace + shade,
    evenly strided: (ro, rd) [R, 3]."""
    import torch
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    covered = gb[pallas_shade.GB_MASK] > 0
    ro = gb[0:3].T[covered]
    rd = torch.cat([samp[0, k:k + 3].T[covered]
                    for k in (pallas_shade.S_LDIR, pallas_shade.S_BDIR)])
    ro = torch.cat([ro, ro])
    idx = torch.arange(0, ro.shape[0], max(1, ro.shape[0] // n_rays),
                       device=ro.device)[:n_rays]
    return ro[idx].contiguous(), rd[idx].contiguous()


def nerf_g128_checks(device, cfg, bake_obj, leaf):
    """Phase 15, in this process: configs/nerf_spot_synth.json's pass-1
    state (DMTet grid 128) with the first 8 training views.  Prints the
    grid's set-up seconds and resident bytes and the init's surface
    triangles against the 393,216 slots; the peak memory of one
    micro-step and of an unsplit batch of 2 (the unsplit batch 8 reckoned
    from them); one recorded micro-step (one view at 800x800, n2 = 64,
    iteration PASS1_IT) holds each of its kernels against its plain
    version (every row scatter launch among them), with trace + shade's
    time, the walk's shared memory and its triangle tests per ray; the
    whole unpruned surface, extracted as the boundary extracts it, holds
    the trace against its plain version on 65,536 of stratum 0's shadow
    rays at the leaf size bvh.build picks; last one pass-2 micro-step on
    the program's count-sized bake (bake_obj, read back) holds trace +
    shade against its plain version at the leaf size the program chose
    (leaf).  Returns (the checks, launches per micro-step, the whole
    surface's trace check, the pass-2 trace + shade check)."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, config, kernels, train
    from nvdiffrecmc_tpu_torch.dataset import DatasetNERF
    from nvdiffrecmc_tpu_torch.geometry import DLMesh, DMTetGeometry
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    from nvdiffrecmc_tpu_torch.ops import envshade, pallas_tracer
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    from nvdiffrecmc_tpu_torch.render import obj as obj_mod
    here = os.path.dirname(os.path.abspath(__file__))
    FLAGS = config.parse_flags(['--config', cfg])
    FLAGS['pre_load'] = False
    ds = DatasetNERF(os.path.join(here, NERF_TRAIN), FLAGS, device=device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    geometry = DMTetGeometry(FLAGS['dmtet_grid'], FLAGS['mesh_scale'], FLAGS,
                             max_tris=FLAGS['max_tris'], device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() - before
    n0, cap = geometry.tri_count(geometry.parameters())
    print('nerf grid 128 set-up: %.3f s (the Kuhn grid: %d tets, %d '
          'vertices, %d unique edges); the geometry holds %.3f GiB on the '
          'card (indices %.3f, edge_map %.3f, edge_uniq %.3f); the init\'s '
          'surface %d triangles in %d slots (%.2fx) (%s)'
          % (setup_s, geometry.num_tets, geometry.verts.shape[0],
             geometry.edge_uniq.shape[0], resident / 2 ** 30,
             *(t.numel() * t.element_size() / 2 ** 30 for t in (
                 geometry.indices, geometry.edge_map, geometry.edge_uniq)),
             n0, cap, n0 / cap, smi_line()), flush=True)
    mat_params, static = train.initial_guess_material(geometry, True, FLAGS,
                                                      device=device)
    static['no_perturbed_nrm'] = True
    light = light_mod.create_trainable_env_rnd(FLAGS['probe_res'], 0.0, 0.5,
                                               device=device)
    p = train.make_params(geometry, mat_params, light)
    loss_fn = train.createLoss(FLAGS)
    perms = envshade.make_perms(FLAGS['n_samples'], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(37)
    batch = train.prepare_batch(ds.collate([ds[i] for i in range(8)]),
                                FLAGS['train_res'], 'random', gen, FLAGS)
    target = {k: batch[k] for k in ('img', 'mvp', 'campos', 'background')}
    one = train.batch_slice(target, 0, 8)

    def grads(geo, params, st, t):
        train.clear_grads(params)
        return train.compute_grads(geo, params, st, t, PASS1_IT, FLAGS,
                                   loss_fn, perms, gen)
    peak1 = _peak_gib(lambda: grads(geometry, p, static, one))
    peak2 = _peak_gib(lambda: grads(geometry, p, static,
                                    train.batch_slice(target, 0, 4)))
    print('nerf grid 128 memory: one micro-step (batch 1) %.3f GiB above '
          'the state, an unsplit batch of 2 %.3f GiB; an unsplit batch of 8 '
          'reckoned at %.3f GiB (peak(1) + 7 (peak(2) - peak(1))) (%s)'
          % (peak1, peak2, peak1 + 7 * (peak2 - peak1), smi_line()),
          flush=True)
    kernels.reset_launches()
    with checks.Recorder() as rec:
        il, rl = grads(geometry, p, static, one)
        torch.cuda.synchronize()
    per_micro = dict(kernels.LAUNCHES)
    check_step(p, il, rl)
    check_step_launches(per_micro, 'nerf grid 128 micro-step')
    out = micro_step_checks(rec, 'nerf grid 128 micro-step')
    samp, gb, bvh = rec.args['trace_shade'][:3]
    smem = pallas_tracer.walk_smem_bytes(bvh)
    print('nerf grid 128 micro-step: trace + shade %.3f ms (kernel, CUDA '
          'events) on %d pixels, n2 = %d; the walk over %d slots (%d leaves '
          'of %d, %d supernodes) holds %d bytes of shared memory a block, so '
          'at most %d blocks fit on an SM (%s)'
          % (out['trace_shade']['ms'], gb.shape[1], samp.shape[0],
             bvh.tri.shape[0], bvh.n_leaves, bvh.leaf_size,
             bvh.super_lo.shape[0], smem, SMEM_PER_SM // (smem + 1024),
             smi_line()), flush=True)
    tmin = rec.args['trace_shade'][4]
    with torch.no_grad():
        ro, rd = stratum0_rays(samp, gb, 1 << 16)
        print_tests(checks.trace_work(ro, rd, bvh, tmin), ro.shape[0],
                    bvh.sub_size, 'nerf grid 128 micro-step, stratum 0')
    del rec, samp, gb, bvh

    # the whole unpruned surface, as the pass boundary extracts it
    with torch.no_grad():
        whole, bvh_w = geometry.getMesh(p['geo'], None, whole=True)
        T_w = whole.t_pos_idx.shape[0]
        r_w = checks.check_trace(ro, rd, bvh_w, tmin, reps=2)
        r_w['leaf_size'] = bvh_w.leaf_size
    print_compare(r_w, ' (nerf grid 128, stratum 0 rays, the whole surface: '
                  '%d triangles, leaf %d)' % (T_w, bvh_w.leaf_size))
    print('nerf grid 128 whole surface: %d triangles (%d counted), %d '
          'vertices; its BVH %d leaves of %d (%d bytes of the walk\'s shared '
          'memory) (%s)' % (T_w, n0, whole.v_pos.shape[0], bvh_w.n_leaves,
                            bvh_w.leaf_size,
                            pallas_tracer.walk_smem_bytes(bvh_w), smi_line()),
          flush=True)
    if T_w != n0 or bvh_w.leaf_size != bvh_mod.leaf_size_for(T_w):
        raise RuntimeError('the whole surface: %d triangles of the %d '
                           'counted, leaf %d' % (T_w, n0, bvh_w.leaf_size))
    if not r_w['ok']:
        raise RuntimeError('trace disagrees with its plain version on the '
                           'whole grid-128 surface')
    del whole, bvh_w, ro, rd

    # pass 2 on the program's count-sized bake
    bake = obj_mod.load_obj(bake_obj, device=device)
    mat2, static2 = train.initial_guess_material(
        None, False, FLAGS, init_mat=bake.material, device=device)
    geometry2 = DLMesh(bake, FLAGS)
    p2 = train.make_params(geometry2, mat2, light)
    with checks.Recorder() as rec:
        il, rl = grads(geometry2, p2, static2, one)
        torch.cuda.synchronize()
    check_step(p2, il, rl)
    bvh2 = rec.args['trace_shade'][2]
    T = bake.t_pos_idx.shape[0]
    with torch.no_grad():
        r2 = checks.run('trace_shade', rec.args, reps=2)
    print_compare(r2, ' (nerf grid 128 pass 2 on the bake, %d triangles, '
                  'leaf %d)' % (T, bvh2.leaf_size))
    print('nerf grid 128 pass 2 on the bake: img_loss %.5f, reg_loss %.5f; '
          'its BVH %d leaves of %d (%d bytes of the walk\'s shared memory) '
          '(%s)' % (float(il), float(rl), bvh2.n_leaves, bvh2.leaf_size,
                    pallas_tracer.walk_smem_bytes(bvh2), smi_line()),
          flush=True)
    if bvh2.leaf_size != leaf or leaf != bvh_mod.leaf_size_for(T):
        raise RuntimeError('pass 2 BVH leaf size %d, the program said %d, '
                           'leaf_size_for gives %d'
                           % (bvh2.leaf_size, leaf, bvh_mod.leaf_size_for(T)))
    if not r2['ok']:
        raise RuntimeError('trace + shade disagrees with its plain version '
                           'on the grid-128 bake')
    return out, per_micro, r_w, r2


def nerf_view_checks(device, FLAGS, geometry, p, static, label,
                     state='the pass-1 state', ds=None):
    """train.render_eval of the first view of ds (by default the NeRF test
    split, 800x800) at its own size, n_samples 32, at FLAGS['layers']
    depth-peel layers on the state p: its seconds
    and launches (sample and trace once a stratum of each layer), finite
    buffers, and sample and trace on the first stratum of each layer
    (the launches of layer i's stratum 0, i 1,024 launches in) against
    their plain versions on the pixels the layer covers (for pass 1, the
    DMTet mesh with its padded triangle slots).  Returns {'sample': check,
    'trace': check} of layer 0, with 'layers': [{'sample', 'trace',
    'covered'}] of every layer."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, kernels, train
    from nvdiffrecmc_tpu_torch.dataset import DatasetNERF
    here = os.path.dirname(os.path.abspath(__file__))
    layers = FLAGS['layers']
    if ds is None:
        ds = DatasetNERF(os.path.join(here, NERF_TEST), FLAGS, device=device)
    batch = ds.collate([ds[0]])
    target = train.prepare_batch(batch, tuple(batch['img'].shape[1:3]),
                                 FLAGS['background'], None, FLAGS)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), checks.Recorder(every=VAL_N * VAL_N) as rec:
        buf = train.render_eval(geometry, p['geo'], p['mat'], static,
                                p['light'], target, FLAGS)
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    for k, v in buf.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError('%s validation buffer %s is not finite'
                               % (label, k))
    want = VAL_N * VAL_N * layers
    if counts['sample'] != want or counts['trace'] != want:
        raise RuntimeError('%s validation view launched %s' % (label, counts))
    out, bad = [], []
    for i in range(layers):
        ro, rd, bvh, tmin = rec.each['trace'][i]
        u8 = rec.each['sample'][i][0]
        # covered pixels: the loop starts the rays of the others at BIG
        covered = ro[:u8.shape[2], 0] < 1e37
        tag = (' (%s validation stratum 0)' % label if layers == 1 else
               ' (%s validation stratum 0, layer %d, %d pixels covered)'
               % (label, i, int(covered.sum())))
        with torch.no_grad():
            rs = checks.check_sample(*rec.each['sample'][i], mask=covered,
                                     reps=2)
            print_compare(rs, tag)
            r = checks.check_trace(ro, rd, bvh, tmin, reps=2)
            print_compare(r, tag)
        out.append(dict(sample=rs, trace=r, covered=int(covered.sum())))
        if not (rs['ok'] and r['ok']):
            bad.append(i)
    n, cap = geometry.tri_count(p['geo']) if hasattr(geometry, 'tri_count') \
        else (geometry.base_mesh.t_pos_idx.shape[0],) * 2
    print('%s validation view on %s: %.3f s (%dx%d, n_samples 32, %d '
          'layers, %d surface triangles of %d slots); launches %s (%s)'
          % (label, state, sec, *target['img'].shape[1:3], layers, n, cap,
             counts, smi_line()), flush=True)
    if bad:
        raise RuntimeError('sample or trace disagrees with its plain version '
                           'on the %s validation stratum 0 of layers %s'
                           % (label, bad))
    return dict(out[0], layers=out, seconds=sec)


# ---------------------------------------------------------------------------
# Transparency: configs/nerfactor_drums.json's keys on the NeRF scene; pass
# 2, its validation and the export through 8 depth-peeled layers
# ---------------------------------------------------------------------------

def transparency_program():
    """Phase 16, the program: configs/nerfactor_drums.json (out_root and
    data_root set to this checkout) with --ref_mesh data/nerf_synthetic_spot
    (the nerfactor scenes are not in the repo), TRANSPARENCY_ITERS
    iterations a pass, no probe, no validation and --micro-batch
    TRANSPARENCY_MICRO_BATCH, in chiprun_out/train_transparency/ (cleared
    first).  Relays the log; checks losses finite, pass 1 at one layer and
    pass 2 at PEEL_LAYERS, each kernel's launches per step, every kernel
    but the mask and the trace launched, peak memory under the card's, the
    boundary (check_boundary), and an RGBA texture_kd.png in dmtet_mesh/
    (its alpha the bake's uniform draw) and in mesh/.  Returns a dict: the
    program's flags, the kernel launches of the run, per pass-1 and per
    pass-2 step, the exported OBJ, the peak memory and the micro-steps."""
    import re
    import numpy as np
    import torch
    from nvdiffrecmc_tpu_torch.render import texture as texture_mod
    here = os.path.dirname(os.path.abspath(__file__))
    label = 'transparency'
    work = os.path.join(here, 'chiprun_out', 'train_transparency')
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(here, TRANSPARENCY_CONFIG)) as f:
        cfg = json.load(f)
    cfg.update(out_root=work, data_root=here)
    path = os.path.join(work, 'config.json')
    with open(path, 'w') as f:
        json.dump(cfg, f, indent=1)
    argv = ['--config', path, '--ref_mesh',
            os.path.join('data', 'nerf_synthetic_spot'), '-o',
            'nerfactor_drums', '-i', str(TRANSPARENCY_ITERS), '-si', '0',
            '--validate', 'false', '--micro-batch',
            str(TRANSPARENCY_MICRO_BATCH)]
    torch.cuda.empty_cache()
    lines = run_program(argv, os.path.join(work, 'run.log'),
                        timeout=NERF_TIMEOUT)
    relay = ('DatasetNERF', 'iter=', 'WARNING', 'peak device memory',
             'dmtet_pass1:', 'prune_small', 'pass boundary:', 'Base mesh',
             'mesh_pass:', 'export:')
    for ln in lines:
        if ln.startswith(relay):
            print(label + ' | ' + ln, flush=True)
    check_program_log(lines, 2, TRANSPARENCY_ITERS, 0)
    med1, per_step1 = pass_summary(lines, 'dmtet_pass1')
    med2, per_step2 = pass_summary(lines, 'mesh_pass')
    text = '\n'.join(lines)
    micro = [int(x) for x in re.findall(r'of (\d+) micro-steps', text)]
    layers = [int(x) for x in re.findall(r'micro-steps at (\d+) layers',
                                         text)]
    launches = json.loads(_after(lines, 'kernel launches: ')[0])
    peak = float(_after(lines, 'peak device memory: ')[0].split()[0])
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    out = os.path.join(work, 'nerfactor_drums')
    n_micro = 8 // TRANSPARENCY_MICRO_BATCH
    print('%s: pass 1 median %.3f ms per step at %d layer, pass 2 %.3f ms '
          'at %d layers (batch 8 in %s micro-steps, 512x512, n_samples 8, '
          'grid 128, %d steps each); peak device memory %.3f GiB of the '
          'card\'s %.3f (%s)'
          % (label, med1, layers[0], med2, layers[1], micro, TRANSPARENCY_ITERS,
             peak, card, smi_line()), flush=True)
    print('%s: kernel launches %s; per pass-1 step %s; per pass-2 step %s'
          % (label, launches, per_step1, per_step2), flush=True)
    if micro != [n_micro, n_micro] or layers != [1, PEEL_LAYERS]:
        raise RuntimeError('%s: micro-steps %s, layers %s per pass'
                           % (label, micro, layers))
    check_step_launches(per_step1, label + ' pass 1', n_micro)
    check_step_launches(per_step2, label + ' pass 2', n_micro, PEEL_LAYERS)
    idle = [n for n, c in launches.items()
            if c == 0 and n not in ('mask', 'trace') + OPTION_KERNELS]
    if idle:
        raise RuntimeError('%s: kernels not launched %s' % (label, idle))
    if not peak < card:
        raise RuntimeError('%s: peak device memory %.3f GiB' % (label, peak))
    mesh1, _ = check_boundary(lines, out, label)
    _, mesh2, _ = check_mesh_dir(os.path.join(out, 'mesh'))
    kd = {}
    for d in ('dmtet_mesh', 'mesh'):
        with open(os.path.join(out, d, 'texture_kd.png'), 'rb') as f:
            kd[d] = texture_mod.decode_png(f.read())
    alpha = kd['dmtet_mesh'][..., 3].astype(np.float64) / 255.0
    print('%s: dmtet_mesh/ %d triangles; mesh/ %d triangles; texture_kd.png '
          '%s (dmtet_mesh/, alpha mean %.4f, std %.4f) and %s (mesh/)'
          % (label, mesh1.t_pos_idx.shape[0], mesh2.t_pos_idx.shape[0],
             kd['dmtet_mesh'].shape, alpha.mean(), alpha.std(),
             kd['mesh'].shape), flush=True)
    if kd['dmtet_mesh'].shape[-1] != 4 or kd['mesh'].shape[-1] != 4 or \
            abs(alpha.mean() - 0.5) > 0.05 or abs(alpha.std() - 0.2887) > 0.05:
        raise RuntimeError('%s: the baked or exported kd is not RGBA with '
                           'the bake\'s uniform alpha' % label)
    if mesh2.t_pos_idx.shape[0] != mesh1.t_pos_idx.shape[0]:
        raise RuntimeError('%s: pass 2 changed the baked mesh' % label)
    drop_checkpoints(out)
    return dict(argv=argv, launches=launches, per_step1=per_step1,
                per_step2=per_step2, peak=peak, micro=n_micro,
                mesh=os.path.join(out, 'mesh', 'mesh.obj'))


def peel_checks(rec, label):
    """Each launch of each kernel of a recorded 8-layer micro-step against
    its plain version: resolve, the guide tables, sample (forward), trace
    + shade and the denoiser at every layer (layer 0 first), the
    denoiser's transpose, shade_bwd and the light scatter once a layer (in
    the order the backward runs the layers), every row scatter launch.
    Returns {name: [check, ...]} in launch order; raises on a
    disagreement."""
    import torch
    from nvdiffrecmc_tpu_torch import checks
    out, bad = {}, []
    with torch.no_grad():
        for name in checks.FORWARD + checks.BACKWARD:
            if name == 'scatter':
                rs = [checks.check_scatter(*a, reps=2)
                      for a in rec.each['scatter']]
            else:
                rs = checks.run_launches(name, rec.each, reps=2)
                if len(rs) != PEEL_LAYERS:
                    bad.append('%s: %d launches' % (name, len(rs)))
            tags = [('layer %d' % i) if name in checks.FORWARD else
                    ('launch %d of %d' % (i + 1, len(rs)))
                    for i in range(len(rs))]
            for r, tag in zip(rs, tags):
                print_compare(r, ' (%s, %s)' % (label, tag))
                if not r['ok']:
                    bad.append('%s %s' % (name, tag))
            out[name] = rs
    if bad:
        raise RuntimeError('kernels disagree with their plain versions at '
                           'the %s: %s' % (label, bad))
    return out


def peel_resolve_checks(device):
    """The resolve at every one of PEEL_LAYERS depth-peel layers of
    spot256 (its inner shells reach layer 7 from every side) at 512x512,
    from a DatasetMesh camera: each layer's launch, with the previous
    layer's depths and ids as rasterize passes them, bit-equal to
    resolve_plain.  Prints the pixels each layer covers; raises unless
    layer 7 covers some.  Returns [check, ...] with 'covered'."""
    import torch
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (DatasetMesh,
                                                            spot256_scene)
    from nvdiffrecmc_tpu_torch.ops import pallas_raster, rasterizer, xfm
    mesh = spot256_scene(device)
    ds = DatasetMesh(mesh, CAM_RADIUS, flags(RES, N_SAMPLES), seed=3)
    mvp = torch.as_tensor(ds._random_scene()[1], device=device)
    v_clip = xfm.xfm_points(mesh.v_pos, mvp)
    with torch.no_grad(), checks.Recorder(every=1) as rec:
        prev = None
        for _ in range(PEEL_LAYERS):
            prev, _ = rasterizer.rasterize(v_clip, mesh.t_pos_idx, (RES, RES),
                                           prev_rast=prev)
        torch.cuda.synchronize()
    out = []
    with torch.no_grad():
        for i, args in enumerate(rec.each['resolve']):
            r = checks.check_resolve(*args, reps=2)
            r['covered'] = int((pallas_raster._resolve_cuda(*args)[1] > 0)
                               .sum())
            print_compare(r, ' (spot256, peel layer %d of %d, %d pixels '
                          'covered)' % (i, PEEL_LAYERS, r['covered']))
            out.append(r)
    covered = [r['covered'] for r in out]
    print('peel layers of spot256 at %dx%d: pixels covered %s (%s)'
          % (RES, RES, covered, smi_line()), flush=True)
    if len(out) != PEEL_LAYERS or not covered[-1] or \
            not all(r['ok'] for r in out):
        raise RuntimeError('the resolve at the peel layers: %s' % [
            (r['ids_differ'], r['z_differ'], r['covered']) for r in out])
    return out


def transparency_checks(device, prog):
    """Phase 16, in this process, on the program's export (mesh/, its RGBA
    kd read back) at FLAGS['layers'] = PEEL_LAYERS as main sets it for
    pass 2: the peak memory of one 8-layer micro-step (one 512x512 view of
    the NeRF scene, n2 = 64) and of an unsplit batch of 2, with the
    unsplit batch 8 reckoned from them; one recorded micro-step whose
    every kernel launch is held against its plain version (peel_checks),
    with the pixels each layer covers; one validation view at 8 layers
    (nerf_view_checks); the resolve at 8 peel layers of spot256
    (peel_resolve_checks).  Returns (peel_checks' checks, launches per
    micro-step, the view's checks, the peel layers' resolve checks)."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, config, kernels, train
    from nvdiffrecmc_tpu_torch.dataset import DatasetNERF
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import envshade, pallas_shade
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    from nvdiffrecmc_tpu_torch.render import obj as obj_mod
    here = os.path.dirname(os.path.abspath(__file__))
    label = 'transparency micro-step'
    FLAGS = config.parse_flags(prog['argv'])
    FLAGS['layers'] = PEEL_LAYERS
    FLAGS['pre_load'] = False
    mesh = obj_mod.load_obj(prog['mesh'], device=device)
    kd = mesh.material['kd'].data
    if kd.shape[-1] != 4:
        raise RuntimeError('the exported kd read back has %d channels'
                           % kd.shape[-1])
    ds = DatasetNERF(os.path.join(here, NERF_TRAIN), FLAGS, device=device)
    geometry = DLMesh(mesh, FLAGS)
    mat, static = train.initial_guess_material(
        None, False, FLAGS, init_mat=mesh.material, device=device)
    light = light_mod.create_trainable_env_rnd(FLAGS['probe_res'], 0.0, 0.5,
                                               device=device)
    p = train.make_params(geometry, mat, light)
    loss_fn = train.createLoss(FLAGS)
    perms = envshade.make_perms(FLAGS['n_samples'], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(41)
    batch = train.prepare_batch(ds.collate([ds[i] for i in range(8)]),
                                FLAGS['train_res'], 'random', gen, FLAGS)
    target = {k: batch[k] for k in ('img', 'mvp', 'campos', 'background')}
    one = train.batch_slice(target, 0, 8)

    def grads(t):
        train.clear_grads(p)
        return train.compute_grads(geometry, p, static, t, 0, FLAGS, loss_fn,
                                   perms, gen)
    peak1 = _peak_gib(lambda: grads(one))
    peak2 = _peak_gib(lambda: grads(train.batch_slice(target, 0, 4)))
    print('transparency memory: one 8-layer micro-step (batch 1, 512x512, '
          'n2 = 64) %.3f GiB above the state, an unsplit batch of 2 %.3f '
          'GiB; an unsplit batch of 8 reckoned at %.3f GiB (peak(1) + 7 '
          '(peak(2) - peak(1))); the program at --micro-batch %d (%d '
          'micro-steps a step) peaked at %.3f GiB (%s)'
          % (peak1, peak2, peak1 + 7 * (peak2 - peak1),
             TRANSPARENCY_MICRO_BATCH, prog['micro'], prog['peak'],
             smi_line()), flush=True)
    kernels.reset_launches()
    with checks.Recorder(every=1) as rec:
        il, rl = grads(one)
        torch.cuda.synchronize()
    per_micro = dict(kernels.LAUNCHES)
    check_step(p, il, rl)
    check_step_launches(per_micro, label, 1, PEEL_LAYERS)
    covered = [int((a[1][pallas_shade.GB_MASK] > 0).sum())
               for a in rec.each['trace_shade']]
    print('%s: img_loss %.5f, reg_loss %.5f; pixels covered by layer %s of '
          '%d; %d triangles; launches %s (%s)'
          % (label, float(il), float(rl), covered, one['img'].shape[1]
             * one['img'].shape[2], mesh.t_pos_idx.shape[0], per_micro,
             smi_line()), flush=True)
    if not covered[1]:
        raise RuntimeError('%s: the second layer covers no pixel' % label)
    at_micro = peel_checks(rec, label)
    del rec
    torch.cuda.empty_cache()
    at_view = nerf_view_checks(device, FLAGS, geometry, p, static,
                               'transparency', 'the exported mesh')
    at_peel = peel_resolve_checks(device)
    return at_micro, per_micro, at_view, at_peel


# ---------------------------------------------------------------------------
# Phase 17: the training options (multi-material OBJ, custom mips,
# decorrelated shading, the modulated denoiser, the stratum loop's
# backward)
# ---------------------------------------------------------------------------

def write_two_material_spot(work):
    """A two-material copy of spot256 in work/: the faces split by their
    centroid's x (x < 0: material m0, the rest m1), m0's kd the scene's
    texture_kd.png, m1's that texture tinted and at half resolution
    (written with the port's encode_png), ks (0, 0.5, 0) for both.
    Returns the OBJ's path."""
    import numpy as np
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import SPOT256_DIR
    from nvdiffrecmc_tpu_torch.render import obj as obj_mod
    from nvdiffrecmc_tpu_torch.render import texture as texture_mod
    os.makedirs(work, exist_ok=True)
    src = os.path.join(SPOT256_DIR, 'mesh.obj')
    v, _, _, faces, tfaces, nfaces = obj_mod.read_obj(src)[:6]
    kd = texture_mod.load_image(os.path.join(SPOT256_DIR, 'texture_kd.png'))
    half = kd.reshape(kd.shape[0] // 2, 2, kd.shape[1] // 2, 2, -1).mean(
        (1, 3))
    tint = np.clip(half[..., 0:3] * np.array([1.0, 0.6, 0.4]), 0.0, 1.0)
    with open(os.path.join(work, 'kd_m1.png'), 'wb') as f:
        f.write(texture_mod.encode_png(np.rint(tint * 255.0).astype(
            np.uint8)))
    shutil.copy(os.path.join(SPOT256_DIR, 'texture_kd.png'),
                os.path.join(work, 'kd_m0.png'))
    with open(os.path.join(work, 'mesh.mtl'), 'w') as f:
        for m in ('m0', 'm1'):
            f.write('newmtl %s\nbsdf pbr\nmap_Kd kd_%s.png\nKs 0 0.5 0\n'
                    % (m, m))
    cx = np.asarray(v, np.float64)[np.asarray(faces)].mean(1)[:, 0]
    with open(src) as f:
        head = [ln for ln in f if ln.startswith(('v ', 'vt ', 'vn '))]

    def corner(k, i):
        return '%d/%s/%s' % (faces[k][i] + 1,
                             '' if tfaces[k][i] < 0 else tfaces[k][i] + 1,
                             '' if nfaces[k][i] < 0 else nfaces[k][i] + 1)
    path = os.path.join(work, 'mesh.obj')
    with open(path, 'w') as f:
        f.write('mtllib mesh.mtl\n')
        f.writelines(head)
        for name, sel in (('m0', cx < 0.0), ('m1', cx >= 0.0)):
            f.write('usemtl %s\n' % name)
            for k in np.nonzero(sel)[0]:
                f.write('f %s %s %s\n' % tuple(corner(k, i)
                                               for i in range(3)))
    print('options: two-material spot256 %s: %d + %d faces, kd %s and %s'
          % (path, int((cx < 0).sum()), int((cx >= 0).sum()),
             kd.shape[:2], tint.shape[:2]), flush=True)
    return path


# launches per step of the options program (custom_mip, decorrelated,
# denoiser_demodulate false): the backward samples and traces anew, the
# one-buffer denoiser runs in place of the pair
OPTIONS_STEP_LAUNCHES = {'resolve': 1, 'sample_guide': 1, 'sample': 2,
                         'trace_shade': 2, 'denoise': 0, 'denoise_grad': 0,
                         'denoise_one': 1, 'denoise_one_grad': 1,
                         'shade_bwd': 1, 'light_scatter': 1}
OPTIONS = dict(custom_mip=True, decorrelated=True, denoiser_demodulate=False)
OPTIONS_ITERS = 10
LOOP_N = 17             # 289 strata: the stratum loop and its backward


def options_program(work, base_obj):
    """The program on configs/spot.json's keys with the two-material base
    mesh and the three options, OPTIONS_ITERS iterations, a checkpoint at
    5, no probe and no validation; the export read back with its mip
    levels.  Returns (launches, per step)."""
    from nvdiffrecmc_tpu_torch.render import obj as obj_mod
    cfg_path = program_setup(work, base_mesh=False, out_dir='spot_options',
                             iters=OPTIONS_ITERS)
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.update(OPTIONS, base_mesh=base_obj, save_interval=0,
               checkpoint_interval=5)
    with open(cfg_path, 'w') as f:
        json.dump(cfg, f, indent=1)
    lines = run_program(['--config', cfg_path],
                        os.path.join(work, 'run.log'))
    for ln in lines:
        if ln.startswith(('iter=', 'peak device memory', 'mesh_pass:',
                          'export:', 'custom_mip', 'decorrelated',
                          'denoiser_demodulate')):
            print('options program | ' + ln, flush=True)
    check_program_log(lines, 1, iters=OPTIONS_ITERS, probe_every=0)
    med, per_step = pass_summary(lines, 'mesh_pass')
    launches = json.loads(_after(lines, 'kernel launches: ')[0])
    wrong = {n: per_step[n] for n, c in OPTIONS_STEP_LAUNCHES.items()
             if per_step[n] != c}
    if wrong or per_step['scatter'] < 1:
        raise RuntimeError('options program: launches per step %s'
                           % (wrong or per_step))
    out = os.path.join(work, 'spot_options')
    mesh_dir = os.path.join(out, 'mesh')
    files = sorted(os.listdir(mesh_dir))
    back = obj_mod.load_obj(os.path.join(mesh_dir, 'mesh.obj'), device='cpu')
    levels = {k: len(back.material[k].data) for k in ('kd', 'ks', 'normal')
              if isinstance(back.material[k].data, list)}
    print('options program: median %.3f ms per step at batch 4 with %s; '
          'per step %s; mesh/ %d files, mip levels read back %s; %d '
          'triangles (%s)' % (med, OPTIONS, per_step, len(files), levels,
                              back.t_pos_idx.shape[0], smi_line()),
          flush=True)
    if levels != {'kd': 10, 'ks': 10, 'normal': 10} or \
            back.t_pos_idx.shape[0] != 26474:
        raise RuntimeError('options program: the export is wrong: %s'
                           % files)
    drop_checkpoints(out)
    return launches, per_step, med


def options_setup(device, base_obj, batch, n_samples, options):
    """A pass-2 step's state at 512x512 and 512x512 textures on the base
    mesh base_obj (its material the initial guess), with spot256 as the
    reference, batch targets over random backgrounds."""
    import torch
    from nvdiffrecmc_tpu_torch import config, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    from nvdiffrecmc_tpu_torch.render import obj as obj_mod
    FLAGS = config.make_flags(train_res=[RES, RES], n_samples=n_samples,
                              texture_res=[512, 512], batch=batch,
                              envlight=SPOT256_PROBE, **options)
    ds = DatasetMesh(spot256_scene(device), CAM_RADIUS, FLAGS, seed=29)
    base = obj_mod.load_obj(base_obj, device=device)
    geometry = DLMesh(base, FLAGS)
    mat, static = train.initial_guess_material(
        geometry, False, FLAGS, init_mat=base.material, device=device)
    light = light_mod.create_trainable_env_rnd(FLAGS['probe_res'], 0.0, 0.5,
                                               device=device)
    params = train.make_params(geometry, mat, light)
    gen = torch.Generator(device=device)
    gen.manual_seed(31)
    target = train.prepare_batch(ds.collate([ds[i] for i in range(batch)]),
                                 FLAGS['train_res'], 'random', gen, FLAGS)
    return dict(FLAGS=FLAGS, ds=ds, geometry=geometry, params=params,
                static=static, opts=train.make_optimizers(params, FLAGS),
                loss_fn=train.createLoss(FLAGS), target=target)


def _step(st, it):
    import torch
    from nvdiffrecmc_tpu_torch import train
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    il, rl = train.train_step(st['geometry'], st['params'], st['opts'],
                              st['static'], st['target'], it, st['FLAGS'],
                              st['loss_fn'], st['ds'].perms, None)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, il, rl


def options_checks(device, base_obj):
    """In process: one recorded batch-4 512x512 step with the three
    options on the two-material mesh, its one-buffer denoiser launches and
    its decorrelated backward's sample, trace + shade, shade_bwd and light
    scatter held against their plain versions (the backward's uniforms
    other than the forward's); its ms per step against the default step's
    at batch 4 in turns (default, options, options, default, ...); then
    one spot256 step at n_samples 17 (289 strata, the loop) at 512x512:
    s per step, peak memory, the loop backward's launches per stratum,
    and its launches on strata 0 and 288 against their plain versions.
    Returns (name -> check of the options step, launches per options
    step, loop strata checks, launches of the loop's step)."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, kernels, train
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    opt = options_setup(device, base_obj, 4, N_SAMPLES, OPTIONS)
    kernels.reset_launches()
    with checks.Recorder(every=1) as rec:
        _, il, rl = _step(opt, 0)
    per_step = dict(kernels.LAUNCHES)
    check_step(opt['params'], il, rl)
    out, differ = checks.check_decorrelated_backward(rec.each, reps=2)
    with torch.no_grad():
        for name in checks.OPTIONS:
            out[name] = dict(checks.run(name, rec.args, reps=5),
                             args=rec.args[name])
    del rec
    bad = []
    for name, r in out.items():
        print_compare(r, ' (options step, batch 4%s)' % (
            ', decorrelated backward' if name not in checks.OPTIONS
            else ''))
        if not r['ok']:
            bad.append(name)
    print('options step: the backward\'s uniforms differ from the '
          'forward\'s in %.6f of their entries; launches %s'
          % (differ, {k: v for k, v in per_step.items() if v}), flush=True)
    wrong = {n: per_step[n] for n, c in OPTIONS_STEP_LAUNCHES.items()
             if per_step[n] != c}
    if bad or wrong or differ < 0.99:
        raise RuntimeError('options step: disagree %s, launches %s, '
                           'uniforms differ %.4f' % (bad, wrong, differ))

    plain = options_setup(device, base_obj, 4, N_SAMPLES, {})
    times = {'default': [], 'options': []}
    for i in range(4):
        for name in (('default', 'options') if i % 2 == 0
                     else ('options', 'default')):
            ms, il, rl = _step(plain if name == 'default' else opt, i + 1)
            times[name].append(ms)
    print('options step vs default step, batch 4 at 512x512 in turns: '
          'median %.3f vs %.3f ms (%s vs %s) (%s)'
          % (statistics.median(times['options']),
             statistics.median(times['default']),
             ', '.join('%.1f' % x for x in times['options']),
             ', '.join('%.1f' % x for x in times['default']), smi_line()),
          flush=True)
    del opt, plain
    torch.cuda.empty_cache()

    # the stratum loop's backward: one spot256 step at n_samples 17
    st = options_setup(device, base_obj, 1, LOOP_N, {})
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms, il, rl = _step(st, 0)
    peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 30
    loop_launches = dict(kernels.LAUNCHES)
    check_step(st['params'], il, rl)
    P, n2 = RES * RES, LOOP_N * LOOP_N
    one = n2 * 8 * P * 4 / 2 ** 30       # the smallest [n2, ., P] array
    print('loop step (spot256, 512x512, n_samples %d, %d strata): %.3f s, '
          'peak %.3f GiB above the state (one [n2, 8, P] array would be '
          '%.3f GiB); launches %s (%s)'
          % (LOOP_N, n2, ms / 1e3, peak, one,
             {k: v for k, v in loop_launches.items() if v}, smi_line()),
          flush=True)
    per_stratum = {k: loop_launches[k] for k in ('sample', 'trace',
                                                 'shade_bwd',
                                                 'light_scatter')}
    if per_stratum != dict(sample=2 * n2, trace=2 * n2, shade_bwd=n2,
                           light_scatter=n2) or peak >= one:
        raise RuntimeError('loop step: launches %s, peak %.3f GiB'
                           % (per_stratum, peak))
    # again, the backward recorded on strata 0 and n2 - 1
    train.clear_grads(st['params'])
    p = st['params']
    tables = light_mod.update_pdf(p['light'])
    lgt = {'base': p['light'], 'pdf': tables.pdf, 'rows': tables.rows,
           'cols': tables.cols}
    il, rl = st['geometry'].tick(
        p['geo'], train.make_material(p['mat'], st['static']), lgt,
        dict(st['target'], resolution=(RES, RES), spp=1), st['loss_fn'], 1,
        st['FLAGS'], 2.0, st['ds'].perms, None, rnd_seed=1)
    with checks.Recorder(every=n2 - 1) as rec:
        (il + rl).backward()
        torch.cuda.synchronize()
    strata = checks.check_loop_strata(rec.each, reps=2)
    del rec
    bad = []
    for name, rs in strata.items():
        for s, r in zip((0, n2 - 1), rs):
            print_compare(r, ' (loop backward, stratum %d of %d)' % (s, n2))
            if not r['ok']:
                bad.append('%s stratum %d' % (name, s))
    if bad or any(len(rs) != 2 for rs in strata.values()):
        raise RuntimeError('loop backward: disagree %s' % bad)
    # last, as it runs under a profiler: a kernel-only trace of one more
    # loop step, its device time against its wall time
    dev_ms, wall, events = device_ms_per_step(lambda i: _step(st, 2 + i), 1)
    print('loop step under a kernel-only trace: %.3f ms device of %.3f ms '
          'wall (%.1f%% idle), %.1f device events a stratum (%s)'
          % (dev_ms, wall, 100.0 * (1.0 - dev_ms / wall), events / n2,
             smi_line()), flush=True)
    return out, per_step, strata, loop_launches, dict(
        loop_step_s=ms / 1e3, loop_peak_gib=peak, loop_device_ms=dev_ms,
        loop_traced_wall_ms=wall, loop_idle_share=1.0 - dev_ms / wall,
        loop_device_events_per_stratum=events / n2)


# ---------------------------------------------------------------------------
# Phase 18: configs/nerd_gold.json's LLFF path (JPEG images and masks) on
# data/llff_spot_synth/, 800x600 views
# ---------------------------------------------------------------------------

def nerd_setup_checks(device, cfg):
    """Phase 18, in this process, before the program: the scene decoded
    (the port's decoder; its seconds, and the decoded uint8 scene's
    sha256 against the one the CPU tests pin under imageio), the LLFF
    dataset's load, the grid-128 DMTet geometry at nerd_gold's mesh_scale
    2.5; the peak memory of one pass-1 micro-step (one 512x512 view, n2 =
    144) and of an unsplit batch of 2, batch 8 reckoned from them, and
    the micro-batch the program gets: the largest of 8, 4, 2, 1 whose
    reckoned step keeps the state and the step within NERD_MEMORY_SHARE
    of the card; one recorded micro-step (iteration PASS1_IT) whose every
    kernel launch is held against its plain version (micro_step_checks),
    with the triangles the resolve gives the whole screen; then the
    capture's first view at its native 600x800 on that grid-128 DMTet
    state (nerf_view_checks: the padded triangle slots, sample and trace
    on its first stratum against their plain versions).  Returns
    (micro-batch, the checks, launches per micro-step, the view's checks,
    a dict of the numbers printed)."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, config, jpeg, kernels, train
    from nvdiffrecmc_tpu_torch.dataset import DatasetLLFF
    from nvdiffrecmc_tpu_torch.dataset import dataset_llff
    from nvdiffrecmc_tpu_torch.geometry import DMTetGeometry
    from nvdiffrecmc_tpu_torch.ops import envshade
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    here = os.path.dirname(os.path.abspath(__file__))
    label = 'nerd gold'
    scene = os.path.join(here, LLFF_SCENE)
    jpeg.lib()      # built with g++ at first use: not part of the decode
    t0 = time.perf_counter()
    sha = dataset_llff.decoded_sha256(scene)
    decode_s = time.perf_counter() - t0
    n_files = 2 * len(dataset_llff._list_images(os.path.join(scene,
                                                             'images')))
    print('%s decode: %d JPEG files (images 4:2:0, masks grayscale) in '
          '%.3f s with the port\'s decoder; the decoded scene\'s sha256 %s, '
          'imageio\'s on the CPU %s: %s'
          % (label, n_files, decode_s, sha, dataset_llff.SPOT_SYNTH_SHA256,
             'equal' if sha == dataset_llff.SPOT_SYNTH_SHA256 else 'DIFFER'),
          flush=True)
    if sha != dataset_llff.SPOT_SYNTH_SHA256:
        raise RuntimeError('the decoded LLFF scene differs from imageio\'s')
    FLAGS = config.parse_flags(['--config', cfg])
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ds = DatasetLLFF(scene, FLAGS, device=device)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    geometry = DMTetGeometry(FLAGS['dmtet_grid'], FLAGS['mesh_scale'], FLAGS,
                             max_tris=FLAGS['max_tris'], device=device)
    mat_params, static = train.initial_guess_material(geometry, True, FLAGS,
                                                      device=device)
    static['no_perturbed_nrm'] = True
    light = light_mod.create_trainable_env_rnd(FLAGS['probe_res'], 0.0, 0.5,
                                               device=device)
    p = train.make_params(geometry, mat_params, light)
    loss_fn = train.createLoss(FLAGS)
    perms = envshade.make_perms(FLAGS['n_samples'], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(43)
    batch = train.prepare_batch(ds.collate([ds[i] for i in range(8)]),
                                FLAGS['train_res'], FLAGS['background'], gen,
                                FLAGS)
    target = {k: batch[k] for k in ('img', 'mvp', 'campos', 'background')}
    one = train.batch_slice(target, 0, 8)
    n0, cap = geometry.tri_count(p['geo'])
    torch.cuda.synchronize()
    state = (torch.cuda.memory_allocated() - before) / 2 ** 30
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30

    def grads(t):
        train.clear_grads(p)
        return train.compute_grads(geometry, p, static, t, PASS1_IT, FLAGS,
                                   loss_fn, perms, gen)
    peak1 = _peak_gib(lambda: grads(one))
    peak2 = _peak_gib(lambda: grads(train.batch_slice(target, 0, 4)))

    def reckoned(m):
        return peak1 + (m - 1) * (peak2 - peak1)
    fits = [m for m in (8, 4, 2, 1)
            if state + reckoned(m) <= NERD_MEMORY_SHARE * card]
    micro = fits[0] if fits else 1
    print('%s memory: the state (the grid-%d geometry, %d views on the card, '
          'the parameters) %.3f GiB; one pass-1 micro-step (batch 1, %dx%d, '
          'n2 = %d) %.3f GiB above it, an unsplit batch of 2 %.3f GiB; '
          'reckoned (peak(1) + (m - 1) (peak(2) - peak(1))): batch 8 unsplit '
          '%.3f GiB, micro-batch 4 %.3f, 2 %.3f; the largest that keeps the '
          'state and the step within %.0f%% of the card\'s %.3f GiB: '
          '--micro-batch %d (%s)'
          % (label, FLAGS['dmtet_grid'], len(ds), state,
             *FLAGS['train_res'], FLAGS['n_samples'] ** 2, peak1, peak2,
             reckoned(8), reckoned(4), reckoned(2), 100 * NERD_MEMORY_SHARE,
             card, micro, smi_line()), flush=True)
    kernels.reset_launches()
    with checks.Recorder() as rec, FullScreenCount() as fs:
        il, rl = grads(one)
        torch.cuda.synchronize()
    per_micro = dict(kernels.LAUNCHES)
    check_step(p, il, rl)
    check_step_launches(per_micro, label + ' micro-step')
    print('%s micro-step: img_loss %.5f, reg_loss %.5f; the init\'s surface '
          '%d triangles in %d slots (%.2fx); triangles with a vertex at w <= '
          '1e-6 (the whole screen in the resolve) %s; launches %s (%s)'
          % (label, float(il), float(rl), n0, cap, n0 / cap, fs.counts,
             per_micro, smi_line()), flush=True)
    out = micro_step_checks(rec, label + ' micro-step')
    del rec
    torch.cuda.empty_cache()
    at_view = nerf_view_checks(device, FLAGS, geometry, p, static, label,
                               ds=ds)
    info = dict(decode_s=decode_s, dataset_load_s=load_s, state_gib=state,
                micro_step_gib=peak1, batch_2_gib=peak2,
                batch_8_reckoned_gib=reckoned(8), micro_batch=micro,
                init_triangles=n0, slots=cap,
                fullscreen_micro_step=fs.counts)
    del p, geometry, ds, batch, target, one
    torch.cuda.empty_cache()
    return micro, out, per_micro, at_view, info


def nerd_view_checks(device, prog):
    """Phase 18, in this process, on the program's bake (dmtet_mesh/, read
    back): train.validate of the capture's first view at its native
    800x600 (max_frames=1; n_samples 32, the stratum loop, and the
    config's kd, ks and normal display layers) into
    chiprun_out/train_nerd_gold/view/: its seconds and the process's CPU
    seconds in them, launches (sample and
    trace once a stratum), metrics.txt and the PNGs' shape; the view's
    resolve, and sample and trace on its first stratum, against their
    plain versions; the triangles the resolve gives the whole screen.
    Returns {'resolve', 'sample', 'trace': check} and a dict of the
    numbers printed."""
    import torch
    from nvdiffrecmc_tpu_torch import checks, config, kernels, train
    from nvdiffrecmc_tpu_torch.dataset import DatasetLLFF
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    from nvdiffrecmc_tpu_torch.render import obj as obj_mod
    from nvdiffrecmc_tpu_torch.render import texture as texture_mod
    here = os.path.dirname(os.path.abspath(__file__))
    label = 'nerd gold view'
    FLAGS = config.parse_flags(prog['argv'])
    FLAGS['pre_load'] = False
    bake = obj_mod.load_obj(prog['bake'], device=device)
    geometry = DLMesh(bake, FLAGS)
    mat, static = train.initial_guess_material(
        None, False, FLAGS, init_mat=bake.material, device=device)
    light = light_mod.create_trainable_env_rnd(FLAGS['probe_res'], 0.0, 0.5,
                                               device=device)
    p = train.make_params(geometry, mat, light)
    ds = DatasetLLFF(os.path.join(here, LLFF_SCENE), FLAGS, device=device)
    out_dir = os.path.join(os.path.dirname(os.path.dirname(prog['bake'])),
                           'view')
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0, c0 = time.perf_counter(), time.process_time()
    with torch.no_grad(), checks.Recorder(every=VAL_N * VAL_N) as rec, \
            FullScreenCount() as fs:
        psnr = train.validate(geometry, p['geo'], p['mat'], static,
                              p['light'], ds, out_dir, FLAGS, max_frames=1)
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    cpu = time.process_time() - c0
    counts = dict(kernels.LAUNCHES)
    metrics = check_metrics(out_dir, 1)
    shapes = {}
    for k in ('ref', 'opt', 'kd', 'ks', 'normal'):
        shapes[k] = texture_mod.read_image(os.path.join(
            out_dir, 'val_000000_%s.png' % k)).shape[:2]
    want = VAL_N * VAL_N
    if counts['sample'] != want or counts['trace'] != want:
        raise RuntimeError('%s launched %s' % (label, counts))
    if set(shapes.values()) != {(600, 800)}:
        raise RuntimeError('%s: images of %s, not 600x800' % (label, shapes))
    out, bad = {}, []
    with torch.no_grad():
        args = rec.each['resolve'][0]
        if tuple(args[2:4]) != (600, 800):
            raise RuntimeError('%s: resolved at %s' % (label, args[2:4]))
        out['resolve'] = checks.check_resolve(*args, reps=2)
        ro, rd, bvh, tmin = rec.each['trace'][0]
        u8 = rec.each['sample'][0][0]
        covered = ro[:u8.shape[2], 0] < 1e37
        out['sample'] = checks.check_sample(*rec.each['sample'][0],
                                            mask=covered, reps=2)
        out['trace'] = checks.check_trace(ro, rd, bvh, tmin, reps=2)
    tag = ' (%s, 600x800, stratum 0, %d pixels covered)' % (
        label, int(covered.sum()))
    for name, r in out.items():
        print_compare(r, tag if name != 'resolve' else ' (%s, 600x800)'
                      % label)
        if not r['ok']:
            bad.append(name)
    print('%s on the bake (%d triangles): %.3f s, the process\'s CPU time '
          '%.3f s in it (600x800, n_samples 32, PSNR %.3f dB; %s); launches '
          '%s; images %s; triangles with a vertex at w <= 1e-6 per '
          'rasterize call %s (%s)'
          % (label, bake.t_pos_idx.shape[0], sec, cpu, psnr, metrics, counts,
             shapes, fs.counts, smi_line()), flush=True)
    if bad:
        raise RuntimeError('%s: %s disagree with their plain versions'
                           % (label, bad))
    return out, dict(view_s=sec, view_cpu_s=cpu, view_psnr=psnr,
                     fullscreen_view=fs.counts)


def nerd_phase(device):
    """Phase 18: nerd_setup_checks, then the program at the micro-batch it
    reckons (nerf_program), nerd_view_checks on the bake, and a 24x32
    frame (height 24, width 32) through the kernels against the plain
    versions on the CPU (small_agreement).  Returns (the micro-step's
    checks, launches per micro-step, the program's dict, the checks of
    the view on the DMTet state, those of the view on the bake, a dict of
    the numbers printed)."""
    here = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(here, 'chiprun_out', 'train_nerd_gold')
    shutil.rmtree(work, ignore_errors=True)
    cfg = nerf_setup(work, NERD_CONFIG, NERD_ITERS, False, LLFF_SCENE,
                     probes=False)
    micro, at_micro, per_micro, at_dmtet_view, info = nerd_setup_checks(
        device, cfg)
    prog = nerf_program(NERD_CONFIG, NERD_ITERS, False, 'nerd gold',
                        probes=False, ref_mesh=LLFF_SCENE, micro_batch=micro)
    at_view, view_info = nerd_view_checks(device, prog)
    share, worst = small_agreement(device, (24, 32), 2)
    print('24x32 render (height 24, width 32, n_samples 2) vs plain CPU '
          'render: %.4f of pixels within 1e-3 (max %.3e)' % (share, worst),
          flush=True)
    info.update(view_info, dmtet_view_s=at_dmtet_view['seconds'],
                program_pass1_ms=prog['med1'],
                program_pass2_ms=prog['med2'], program_peak_gib=prog['peak'],
                non_square_share=share, non_square_max_err=worst)
    print('nerd gold: %s' % json.dumps(info), flush=True)
    return at_micro, per_micro, prog, at_dmtet_view, at_view, info


def device_ms_per_step(run, steps):
    """Device ms per call of run(i) under a kernel-only torch.profiler
    trace of `steps` calls (after one warm-up): the sum of the device
    events' time (kernels, copies, sets); the wall ms per call in that
    trace; and the device events per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            run(1 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    averages = prof.key_averages()
    key = 'self_device_time_total'
    if averages and not hasattr(averages[0], key):
        key = 'self_cuda_time_total'
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, key) for e in events)
    return busy / 1e3 / steps, wall, sum(e.count for e in events) / steps


def print_tests(work, rays, G, label):
    """Triangle tests per ray (checks.trace_work): the walk's, in its order
    with its early exit, and the least any walk needs, each with sub-boxes
    of G triangles and with whole leaves."""
    print('triangle tests per ray (%s, %d rays): walk %.2f with sub-boxes of '
          '%d, %.2f with whole leaves; least %.2f and %.2f; box tests per '
          'ray (least) %.2f'
          % (label, rays, work['walk_tris'] / rays, G,
             work['walk_tris_two_level'] / rays, work['tris'] / rays,
             work['tris_two_level'] / rays, work['slabs'] / rays),
          flush=True)


def brief(r):
    """A check's numbers for the kernels JSON."""
    return dict(ms=r['ms'], plain_ms=r['plain_ms'],
                max_abs_err=r['max_abs_err'], compared_on=r.get('compared_on'))


def phase_timer():
    """A function of a phase's name that prints the seconds since its
    last call, or since phase_timer's."""
    last = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        print('phase %s: %.1f s' % (name, now - last[0]), flush=True)
        last[0] = now
    return done


def print_compare(r, label=''):
    print('compare %-13s%s mismatch share %.2e max_abs_err %.3e ok %s'
          '  kernel %.3f ms  plain %.3f ms%s%s%s'
          % (r['name'], label, 1.0 - r['agree'], r['max_abs_err'], r['ok'],
             r['ms'], r['plain_ms'],
             ('  err/bound %.3f' % r['err_over_bound'])
             if 'err_over_bound' in r else '',
             ('  ids differ %d, depths differ %d'
              % (r['ids_differ'], r['z_differ']))
             if 'ids_differ' in r else '',
             ('  (compared on %s)' % r['compared_on'])
             if 'compared_on' in r else ''), flush=True)


def rasterize_launches(v_clip, tri, res):
    """Kernels (PyTorch's and ours, memsets included) that one rasterize
    call launches on the card, up to the resolve's output (its unpack
    kernel, in the order they ran) and in all, under a kernel-only
    torch.profiler trace; fails past RESOLVE_MAX_LAUNCHES up to the
    resolve's output."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from nvdiffrecmc_tpu_torch.ops import rasterizer
    rasterizer.rasterize(v_clip, tri, res)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rasterizer.rasterize(v_clip, tri, res)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    ends = [i for i, name in enumerate(names) if 'unpack_kernel' in name]
    if len(ends) != 1:
        raise RuntimeError('one rasterize call ran the resolve\'s unpack '
                           'kernel %d times: %s' % (len(ends), names))
    n = ends[0] + 1
    print('rasterize launches: %d up to the resolve\'s output (%s); %d in '
          'all' % (n, ', '.join(name[:40] for name in names[:n]),
                   len(names)), flush=True)
    if n > RESOLVE_MAX_LAUNCHES:
        raise RuntimeError('rasterize launched %d kernels up to the '
                           'resolve\'s output' % n)


def print_occupancy():
    """Registers and spill bytes per thread, blocks per SM and shared bytes
    per block of the sample kernel (for the probe's and the trainable
    light's sizes), of shade_bwd and of the mask kernel."""
    from nvdiffrecmc_tpu_torch import kernels
    for Hl, Wl in ((512, 1024), (256, 256)):
        print('occupancy sample (%dx%d light): %s'
              % (Hl, Wl, kernels.occupancy('nvk_sample_info', Hl)),
              flush=True)
    print('occupancy shade_bwd: %s'
          % kernels.occupancy('nvk_shade_bwd_info'), flush=True)
    print('occupancy mask: %s' % kernels.occupancy('nvk_mask_info'),
          flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--profile', action='store_true',
                        help='also profile 4 frames and 4 training steps '
                             'with torch.profiler')
    args = parser.parse_args()
    phase_seconds = phase_timer()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false')
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from nvdiffrecmc_tpu_torch import checks, kernels
    except ImportError as e:
        raise SystemExit('chip_smoke: the port is not beside this script (%s)'
                         % e)
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh

    # 1. device
    print('card:', smi_line(), flush=True)
    print('torch', torch.__version__, 'cuda', torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)

    # 2. build
    t0 = time.perf_counter()
    built = kernels.build(verbose=True)
    kernels.lib()
    print('build: %.1f s (nvcc %.1f s)' % (time.perf_counter() - t0, built),
          flush=True)
    print_occupancy()
    phase_seconds('1-2 (device, build)')

    # 3. scene, one recorded frame, kernel vs plain
    t0 = time.perf_counter()
    mesh = spot256_scene(device)
    FLAGS = flags(RES, N_SAMPLES)
    ds = DatasetMesh(mesh, CAM_RADIUS, FLAGS, seed=0)
    geometry = DLMesh(ds.ref_mesh, FLAGS)
    torch.cuda.synchronize()
    # the dataset falls back to a procedural sky when the probe is missing
    if not os.path.exists(SPOT256_PROBE) or \
            tuple(ds.envlight.shape) != (512, 1024, 3):
        raise RuntimeError('the light is not the 512x1024 probe %s'
                           % SPOT256_PROBE)
    print('scene: %d tris, %d verts, light %s, %.1f s'
          % (mesh.t_pos_idx.shape[0], mesh.v_pos.shape[0],
             tuple(ds.envlight.shape), time.perf_counter() - t0), flush=True)
    with torch.no_grad(), checks.Recorder() as rec:
        render_frame(ds, geometry, mesh.material, FLAGS, 0, device)
        torch.cuda.synchronize()
    results = {}
    with torch.no_grad():
        for name in checks.FORWARD:
            r = checks.run(name, rec.args)
            results[name] = dict(r, args=rec.args[name])
            print_compare(r)
        # the depth-peel rule: a second layer behind the first one
        from nvdiffrecmc_tpu_torch.ops import pallas_raster
        v_clip, tri, H, W, pz, pid = rec.args['resolve']
        z1, tid1 = pallas_raster._resolve_cuda(v_clip, tri, H, W, pz, pid)
        pz2 = torch.where(tid1 > 0, z1, torch.full_like(z1, 1e30))
        r2 = checks.check_resolve(v_clip, tri, H, W, pz2.contiguous(),
                                  tid1.contiguous(), reps=2)
        print_compare(r2, ' (peel layer 2)')
        if not r2['ok']:
            raise RuntimeError('resolve layer 2 disagrees with its plain '
                               'version')
    bad = [n for n, r in results.items() if not r['ok']]
    if bad:
        raise RuntimeError('kernels disagree with their plain versions: %s'
                           % bad)

    phase_seconds('3 (one recorded frame)')

    # 4. the main path: 4 frames, counted launches
    times = []
    kernels.reset_launches()
    with torch.no_grad():
        for it in range(1, FRAMES + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            buf = render_frame(ds, geometry, mesh.material, FLAGS, it, device)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            coverage, mean_col = check_buffers(buf, RES)
            print('frame %d: %.2f ms, coverage %.4f, mean shaded %.4f'
                  % (it, times[-1], coverage, mean_col), flush=True)
    launches = dict(kernels.LAUNCHES)
    print('launches:', launches, flush=True)
    for name, count in launches.items():
        want = FRAMES if name in checks.FORWARD else 0
        if count != want:
            raise RuntimeError('kernel %s launched %d times in %d frames'
                               % (name, count, FRAMES))
    print('median ms per frame: %.3f (512x512, n_samples 4, spot 26474 '
          'tris)' % statistics.median(times), flush=True)

    # 5. small input against the plain versions on the CPU
    share, worst = small_agreement(device)
    print('64x64 render vs plain CPU render: %.4f of pixels within 1e-3 '
          '(max %.3e)' % (share, worst), flush=True)
    phase_seconds('4-5 (frames, 64x64 render)')

    # 6. the training step
    step_launches, st, targets = train_phase(device, results)
    report = small_step_agreement(device)
    print('64x64 step vs plain CPU step: losses (card, cpu) %s %s; '
          'gradients (cosine, share within 1e-3 max|g|) %s'
          % (report['img_loss'], report['reg_loss'],
             {k: v for k, v in report.items() if 'loss' not in k}),
          flush=True)

    phase_seconds('6 (training step)')

    # 8. the standalone tracer on the bench rays
    tracer_phase(mesh, device, results)
    phase_seconds('8 (tracer)')

    # 9. validation at the reference protocol
    val_launches = validation_phase(st, device, results)

    phase_seconds('9 (validation)')

    # 10. a small validation frame against the plain versions on the CPU
    share, worst = small_validation_agreement(device)
    print('32x32 validation frame (n_samples %d) vs plain CPU render: %.4f '
          'of pixels within 1e-3 (max %.3e)' % (SMALL_VAL_N, share, worst),
          flush=True)
    phase_seconds('10 (32x32 validation frame)')

    # the kernels' rows (library_ms is timed here, before any profiler)
    rows = []
    for name in checks.FORWARD + checks.BACKWARD + checks.VALIDATE:
        r = results[name]
        kargs = r['args']
        src, rep = checks.SOURCES[name]
        path = (launches if name in checks.FORWARD else step_launches
                if name in checks.BACKWARD else val_launches)
        b = checks.bound(name, kargs)
        row = dict(name=name, route='cuda', source=src, replaces=rep,
                   launches=path[name], max_abs_err=r['max_abs_err'],
                   ms=r['ms'], plain_ms=r['plain_ms'],
                   bound_ms=b['bound_ms'], bound_by=b['bound_by'],
                   library_ms=checks.library_ms(name, kargs),
                   agree=r['agree'], bound_bytes=b['bound_bytes'],
                   bound_ops=b['bound_ops'])
        if name in checks.FORWARD:
            row['launches_in_%d_train_steps' % TRAIN_STEPS] = \
                step_launches[name]
        if 'compared_on' in r:
            row['compared_on'] = r['compared_on']
        if name == 'scatter':   # row 7: the largest launch, and all of them
            row['all_launches'] = [
                dict(compared_on=x['compared_on'], ms=x['ms'],
                     plain_ms=x['plain_ms'], max_abs_err=x['max_abs_err'],
                     bound_ms=checks.bound(name, x['args'])['bound_ms'])
                for x in r['each_launch']]
            row['all_launches_ms'] = sum(x['ms'] for x in row['all_launches'])
            row['all_launches_bound_ms'] = sum(
                x['bound_ms'] for x in row['all_launches'])
            print('bound scatter, all %d launches: %.4f ms; kernel %.4f ms'
                  % (len(row['all_launches']), row['all_launches_bound_ms'],
                     row['all_launches_ms']), flush=True)
        print('bound %-13s %.4f ms by %s (%.3e bytes, %.3e ops); kernel '
              '%.4f ms%s' % (name, b['bound_ms'], b['bound_by'],
                             b['bound_bytes'], b['bound_ops'], r['ms'],
                             '' if row['library_ms'] is None else
                             '; library call %.4f ms' % row['library_ms']),
              flush=True)
        if 'rays' in b:
            print_tests(b, b['rays'], kargs[2].sub_size, name + ' bound')
        if 'rays_needed' in b:
            print('bound %s reads %d of the %d rays' % (
                name, b['rays_needed'], kargs[0].shape[0]), flush=True)
        rows.append(row)

    phase_seconds('the kernels\' rows (bounds, library calls)')

    # 11. the launches of one rasterize call
    v_clip, tri, H, W = results['resolve']['args'][:4]
    with torch.no_grad():
        rasterize_launches(v_clip, tri, (H, W))

    # 12. the pass-2 program at spot.json's batch 4, and its resume
    del results
    program_launches, program_per_step, at_batch_4 = program_phase()
    for row in rows:
        row['launches_in_program'] = program_launches[row['name']]
        row['launches_per_program_step'] = program_per_step[row['name']]
        if row['name'] in at_batch_4:
            row['at_batch_4'] = brief(at_batch_4[row['name']])

    phase_seconds('11-12 (rasterize launches, pass-2 program)')

    # 13. pass 1, the pass boundary and pass 2 through the program at
    # spot.json's settings; then pass 1's kernels at batch 4 in this process
    two_launches, pass1_per_step = two_pass_program()
    at_pass1, _, st1, targets1 = pass1_checks(device)
    for row in rows:
        name = row['name']
        row['launches_in_two_pass_program'] = two_launches[name]
        row['launches_per_pass1_step'] = pass1_per_step[name]
        if name in at_pass1:
            row['at_pass1_batch_4'] = brief(at_pass1[name])
        if name == 'scatter':
            r = at_pass1[name]
            row['pass1_hashgrid'] = {k: r[k] for k in (
                'compared_on', 'ms', 'plain_ms', 'generic_ms', 'library_ms',
                'bound_ms', 'bound_by', 'max_abs_err', 'err_over_bound')}

    def pass1_step(i):
        from nvdiffrecmc_tpu_torch import train
        train.train_step(st1['geometry'], st1['params'], st1['opts'],
                         st1['static'], targets1[i % len(targets1)],
                         PASS1_IT + PASS1_STEPS + 1 + i, st1['FLAGS'],
                         st1['loss_fn'], st1['ds'].perms, None)
    dev_ms, wall, _ = device_ms_per_step(pass1_step, 2)
    print('pass 1 (kernel-only trace, batch 4): %.3f ms device per step, '
          '%.3f ms wall in the trace (%s)' % (dev_ms, wall, smi_line()),
          flush=True)
    del st1, targets1
    phase_seconds('13 (two passes, spot)')

    # 14. the NeRF scene at grid 64: both passes through the program at
    # configs/nerf_spot_synth_g64.json's width (batch 8 in micro-steps of
    # 1, 800x800, n_samples 8), NERF_ITERS iteration a pass, both
    # validations on the first test view
    torch.cuda.empty_cache()
    g64 = nerf_program(NERF_CONFIG, NERF_ITERS, True, 'nerf grid 64')
    for row in rows:
        row['launches_in_nerf_program'] = g64['launches'][row['name']]
        row['launches_per_nerf_pass1_step'] = g64['per_step1'][row['name']]
    del g64
    phase_seconds('14 (NeRF, grid 64)')

    # 15. the NeRF scene at grid 128: configs/nerf_spot_synth.json as
    # shipped through the program, NERF_G128_ITERS iteration a pass, no
    # probe and no validation (phase 14 runs both); then in this process
    # one micro-step's kernels, the trace over the whole unpruned surface
    # and a pass-2 micro-step on the program's count-sized bake
    torch.cuda.empty_cache()
    g128 = nerf_program(NERF_G128_CONFIG, NERF_G128_ITERS, False,
                        'nerf grid 128', probes=False)
    at_g128, g128_micro, g128_whole, g128_bake = nerf_g128_checks(
        device, g128['argv'][1], g128['bake'], g128['leaf'])
    for row in rows:
        name = row['name']
        row['launches_in_nerf_g128_program'] = g128['launches'][name]
        row['launches_per_nerf_g128_pass1_step'] = g128['per_step1'][name]
        row['launches_per_nerf_g128_micro_step'] = g128_micro[name]
        if name in at_g128:
            row['at_nerf_g128_micro_step'] = brief(at_g128[name])
        if name == 'trace':
            row['at_nerf_g128_whole_surface'] = dict(
                brief(g128_whole), leaf_size=g128_whole['leaf_size'])
        if name == 'trace_shade':
            row['at_nerf_g128_pass2_bake'] = dict(brief(g128_bake),
                                                  leaf_size=g128['leaf'])
    phase_seconds('15 (NeRF, grid 128)')

    # 16. transparency: configs/nerfactor_drums.json's keys on the NeRF
    # scene through the program (pass 2 and its export at 8 depth-peeled
    # layers, the bake's alpha); then in this process an 8-layer
    # micro-step's every kernel launch, an 8-layer validation view and the
    # resolve at 8 peel layers, each against its plain version
    del g128
    torch.cuda.empty_cache()
    prog = transparency_program()
    at_tp, tp_micro, at_tp_view, at_peel = transparency_checks(device, prog)
    for row in rows:
        name = row['name']
        row['launches_in_transparency_program'] = prog['launches'][name]
        row['launches_per_transparency_micro_step'] = tp_micro[name]
        if name == 'scatter':
            row['at_transparency_micro_step'] = dict(
                launches=len(at_tp[name]),
                largest=brief(max(at_tp[name],
                                  key=lambda r: r['plain_ms'])),
                ms=sum(r['ms'] for r in at_tp[name]),
                plain_ms=sum(r['plain_ms'] for r in at_tp[name]))
        elif name in at_tp:
            row['at_transparency_micro_step'] = [brief(r)
                                                 for r in at_tp[name]]
        if name in ('sample', 'trace'):
            row['at_transparency_validation_stratum'] = [
                dict(brief(x[name]), covered=x['covered'])
                for x in at_tp_view['layers']]
        if name == 'resolve':
            row['at_peel_layers'] = [dict(brief(r), covered=r['covered'])
                                     for r in at_peel]
    phase_seconds('16 (transparency)')

    # 17. the training options: the program with custom_mip, decorrelated
    # and denoiser_demodulate false on a two-material copy of spot256, then
    # in this process a recorded step with them, and a step at n_samples 17
    # through the stratum loop's backward
    del prog, at_tp, at_tp_view, at_peel
    torch.cuda.empty_cache()
    work = os.path.join(here, 'chiprun_out', 'train_options')
    shutil.rmtree(work, ignore_errors=True)
    base_obj = write_two_material_spot(os.path.join(work, 'base'))
    opt_launches, opt_per_step, _ = options_program(work, base_obj)
    at_opt, opt_step, at_loop, loop_launches, loop_info = options_checks(
        device, base_obj)
    for row in rows:
        name = row['name']
        row['launches_in_options_program'] = opt_launches[name]
        row['launches_per_options_program_step'] = opt_per_step[name]
        row['launches_per_options_step'] = opt_step[name]
        row['launches_per_loop_step'] = loop_launches[name]
        if name in at_opt:
            row['at_options_decorrelated_backward'] = brief(at_opt[name])
        if name in at_loop:
            row['at_options_loop_strata'] = [brief(r) for r in at_loop[name]]
    for name in checks.OPTIONS:     # the one-buffer denoiser's rows
        r = at_opt[name]
        src, rep = checks.SOURCES[name]
        b = checks.bound(name, r['args'])
        rows.append(dict(
            name=name, route='cuda', source=src, replaces=rep,
            launches=opt_step[name], max_abs_err=r['max_abs_err'],
            ms=r['ms'], plain_ms=r['plain_ms'], bound_ms=b['bound_ms'],
            bound_by=b['bound_by'], library_ms=None, agree=r['agree'],
            bound_bytes=b['bound_bytes'], bound_ops=b['bound_ops'],
            compared_on='options step, batch 4, 512x512',
            launches_in_options_program=opt_launches[name],
            launches_per_options_program_step=opt_per_step[name]))
        print('bound %-13s %.4f ms by %s (%.3e bytes, %.3e ops); kernel '
              '%.4f ms' % (name, b['bound_ms'], b['bound_by'],
                           b['bound_bytes'], b['bound_ops'], r['ms']),
              flush=True)
    print('options: %s' % json.dumps(loop_info), flush=True)
    del at_opt, at_loop
    phase_seconds('17 (options)')

    # 18. configs/nerd_gold.json's LLFF path on the repo's JPEG capture:
    # the decode held to imageio's, one pass-1 micro-step at n2 = 144 and
    # the memory that sets the micro-batch, a native 600x800 view of the
    # grid-128 DMTet state, the program at that micro-batch, a native
    # 600x800 view of the bake, a non-square frame against the CPU
    torch.cuda.empty_cache()
    at_nerd, nerd_micro, nerd, at_nerd_dmtet, at_nerd_view, _ = \
        nerd_phase(device)
    for row in rows:
        name = row['name']
        row['launches_in_nerd_program'] = nerd['launches'][name]
        row['launches_per_nerd_pass1_step'] = nerd['per_step1'][name]
        row['launches_per_nerd_micro_step'] = nerd_micro[name]
        if name in at_nerd:
            row['at_nerd_micro_step'] = brief(at_nerd[name])
        if name in at_nerd_dmtet:
            row['at_nerd_dmtet_view_600x800'] = brief(at_nerd_dmtet[name])
        if name in at_nerd_view:
            row['at_nerd_view_600x800'] = brief(at_nerd_view[name])
    del at_nerd, at_nerd_dmtet, at_nerd_view
    phase_seconds('18 (nerd_gold, LLFF)')

    # 7. optional profile: every profiler session after every timed phase
    if args.profile:
        def frame(it):
            with torch.no_grad():
                render_frame(ds, geometry, mesh.material, FLAGS, it, device)

        def train_step(it):
            from nvdiffrecmc_tpu_torch import train
            train.train_step(st['geometry'], st['params'], st['opts'],
                             st['static'], targets[it % len(targets)], it,
                             st['FLAGS'], st['loss_fn'], st['ds'].perms, None)
        out_dir = os.path.join(here, 'chiprun_out')
        profile_run(frame, 'frame', device,
                    os.path.join(out_dir, 'profile_port.txt'))
        profile_run(train_step, 'train step', device,
                    os.path.join(out_dir, 'profile_train.txt'))
        profile_view(st, DatasetMesh(spot256_scene(device), CAM_RADIUS,
                                     st['FLAGS'], validate=True), device,
                     os.path.join(out_dir, 'profile_validate.txt'))

    print(json.dumps({'kernels': rows}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
