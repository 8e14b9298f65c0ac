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
   parameters: train.validate over 2 views of DatasetMesh(validate=True)
   at 512x512, n_samples 32 (1,024 strata in one call, the stratum loop),
   no denoiser, checker background, into chiprun_out/validate/; seconds,
   MSE and PSNR per view, launches per render_eval (sample and trace
   1,024, resolve and the sampler's guide tables 1, trace_shade, denoise
   and mask 0); the first view's
   resolve and the first stratum's inputs hold resolve, sample, trace and
   mask against their plain versions (the sample line gives the kernel's
   time at one stratum, as the stratum loop launches it), and give the
   triangle tests per covered ray as in phase 8;
10. a 32x32 validation frame at n_samples 32 with the kernels on the card
   and with the plain versions on the CPU from the same uniforms;
11. count the kernels (PyTorch's and ours) that one rasterize call of
   phase 3's frame launches, under torch.profiler: at most
   RESOLVE_MAX_LAUNCHES up to the resolve's output;
7. with --profile only: torch.profiler over 4 more frames and over 4 more
   training steps; prints device time by kernel, launches and host gaps,
   and writes the full tables to chiprun_out/profile_port.txt and
   chiprun_out/profile_train.txt; then a kernel-only trace of 4 more of
   each gives the device's idle share within one run; then a kernel-only
   trace of one more validation view (chiprun_out/profile_validate.txt).

Any failure raises and exits non-zero before the last line.  The last
three lines are the kernels JSON (all eleven entries: the ten kernels that
replace the TPU kernels, the denoiser's two modes apart, and the sampler's
guide kernel; each with its time, its plain version's, its bound and, for
the two scatters, index_add_'s, for the guide torch.searchsorted's; the
row scatter's entry is its largest launch, with every launch of the step
and their summed time and bound beside it), the card line, and {"ok":
true, "device": {...}}.

Usage: python3 chip_smoke.py [--profile]
"""

import argparse
import json
import os
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
TRACER_RAYS = 2 ** 21   # bench.py's bench_tracer
RESOLVE_MAX_LAUNCHES = 10   # kernels of one rasterize call up to the resolve
VAL_FRAMES = 2
VAL_N = 32              # the reference validation protocol's n_samples


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


def small_agreement(device):
    """64x64, n_samples 2: kernels on the card vs plain versions on the
    CPU, same scene, cameras and uniforms."""
    import torch
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (DatasetMesh,
                                                            spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    from nvdiffrecmc_tpu_torch.render import render as render_mod
    res, n = 64, 2
    shaded = {}
    gen = torch.Generator()
    gen.manual_seed(7)
    uniforms = pallas_shade.make_uniforms(gen, n * n, res * res, n,
                                          device='cpu')
    for dev in (device, 'cpu'):
        mesh = spot256_scene(dev)
        FLAGS = flags(res, n)
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
                g, msaa=True, background=torch.ones((1, res, res, 3),
                                                    device=dev),
                denoiser_sigma=SIGMA, uniforms=[uniforms.to(dev)])
        shaded[dev] = buf['shaded'].cpu()
    diff = (shaded[device] - shaded['cpu']).abs().amax(-1)
    share = float((diff <= 1e-3).float().mean())
    if share < 0.99:
        raise RuntimeError('64x64 render: only %.4f of pixels within 1e-3 '
                           'of the plain CPU render' % share)
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

def train_setup(device, res, n_samples, tex_res, kd_noise=None):
    """The pass-2 step's state on device: flags, the spot dataset, DLMesh,
    the trainable material and light, their optimizers.  kd_noise: a
    [1, tex_res, tex_res, 3] array subtracted from the constant initial kd."""
    import torch
    from nvdiffrecmc_tpu_torch import config, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.render import light as light_mod
    FLAGS = config.make_flags(train_res=[res, res], n_samples=n_samples,
                              texture_res=[tex_res, tex_res],
                              envlight=SPOT256_PROBE)
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
    return {'geo': list(params['geo'].values()),
            'mat': list(params['mat'].values()), 'light': [params['light']]}


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


def small_step_agreement(device):
    """One 64x64 step (n_samples 2, 256^2 textures) on the card and the same
    step on the CPU with the plain versions, from one target, one set of
    uniforms and jitter offsets: losses within 1e-4 relative; gradients of
    v_pos, kd, ks, normal and light with cosine >= 0.999 and >= 99% of the
    entries within 1e-3 max|g|.  kd gets seeded noise so that the
    smoothness term's |kd_jitter - kd| is off its kink."""
    import numpy as np
    import torch
    from nvdiffrecmc_tpu_torch import train
    from nvdiffrecmc_tpu_torch.ops import pallas_shade
    res, n, tex = 64, 2, 256
    noise = np.random.RandomState(4).uniform(
        0.0, 0.3, (1, tex, tex, 3)).astype(np.float32)
    gen = torch.Generator()
    gen.manual_seed(7)
    uniforms = pallas_shade.make_uniforms(gen, n * n, res * res, n,
                                          device='cpu')
    offsets = torch.randn((1, res, res, 2), generator=gen) * 0.005
    target = None
    out = {}
    for dev in ('cpu', device):
        st = train_setup(dev, res, n, tex, kd_noise=noise)
        if target is None:
            target = make_targets(st, 1, 3)[0]
        tgt = {k: (v.to(dev) if torch.is_tensor(v) else v)
               for k, v in target.items()}
        il, rl = train.compute_grads(
            st['geometry'], st['params'], st['static'], tgt, 0, st['FLAGS'],
            st['loss_fn'], st['ds'].perms, None,
            uniforms=[uniforms.to(dev)], offsets=[offsets.to(dev)])
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
    """A 32x32 validation frame of the spot scene at n_samples 32: kernels
    on the card vs plain versions on the CPU, the same uniforms."""
    import torch
    from nvdiffrecmc_tpu_torch import config, train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (
        SPOT256_PROBE, DatasetMesh, spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import pallas_shade, vecmath
    res, n = 32, VAL_N
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

    # 6. the training step
    step_launches, st, targets = train_phase(device, results)
    report = small_step_agreement(device)
    print('64x64 step vs plain CPU step: losses (card, cpu) %s %s; '
          'gradients (cosine, share within 1e-3 max|g|) %s'
          % (report['img_loss'], report['reg_loss'],
             {k: v for k, v in report.items() if 'loss' not in k}),
          flush=True)

    # 8. the standalone tracer on the bench rays
    tracer_phase(mesh, device, results)

    # 9. validation at the reference protocol
    val_launches = validation_phase(st, device, results)

    # 10. a small validation frame against the plain versions on the CPU
    share, worst = small_validation_agreement(device)
    print('32x32 validation frame (n_samples 32) vs plain CPU render: %.4f '
          'of pixels within 1e-3 (max %.3e)' % (share, worst), flush=True)

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

    # 11. the launches of one rasterize call
    v_clip, tri, H, W = results['resolve']['args'][:4]
    with torch.no_grad():
        rasterize_launches(v_clip, tri, (H, W))

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
