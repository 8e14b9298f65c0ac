#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (nvdiffrecmc_tpu_torch) on one GPU.

Phases:
1. require CUDA; print the card's name and power limit; TF32 off;
2. build the four CUDA kernels from csrc/ and print the build time;
3. render one frame of the slice, recording each kernel's inputs, and hold
   every kernel against its plain PyTorch version on those inputs (error,
   share of mismatches, time of both);
4. reset the launch counters, render 4 frames of the slice (textured spot
   mesh, 26,474 triangles, 512x512, n_samples 4, one layer, spp 1,
   bilateral denoiser sigma 2.0, white background, cameras as
   DatasetMesh._random_scene), check the buffers and that every kernel ran
   once per frame, print the median ms per frame;
5. render a 64x64 frame with the kernels and with the plain versions on the
   CPU from the same uniforms and compare the shaded images;
6. with --profile only: torch.profiler over 4 more frames; prints device
   time per frame by kernel, launches and host gaps, and writes the full
   table to chiprun_out/profile_port.txt.

Any failure raises and exits non-zero before the last line.  The last
three lines are the kernels JSON, the card line, and
{"ok": true, "device": {...}}.

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
    uniforms = pallas_shade.make_uniforms(gen, n * n, res * res, n)
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


def profile_frames(ds, geometry, material, FLAGS, device, out_path):
    """torch.profiler over FRAMES frames: wall and device ms per frame, the
    device time of each kernel, kernel launches per frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        render_frame(ds, geometry, material, FLAGS, 100, device)   # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for it in range(FRAMES):
                render_frame(ds, geometry, material, FLAGS, 101 + it, device)
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
    device = sum(r[0] for r in rows)
    if device <= 0.0:
        raise RuntimeError('the profiler saw no device time')
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, 'w') as f:
        f.write(averages.table(sort_by=key, row_limit=60))
    print('profile: %.2f ms wall per frame, %.2f ms device (%.1f%% busy), '
          '%.2f ms host gaps, %d kernel launches per frame'
          % (wall, device, 100.0 * device / wall, wall - device,
             round(sum(r[1] for r in rows))), flush=True)
    for ms, count, key in rows[:8]:
        print('profile: %8.3f ms per frame  %6.1f launches  %s'
              % (ms, count, key[:80]), flush=True)
    print('profile: full table in %s' % out_path, flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--profile', action='store_true',
                        help='also profile 4 frames with torch.profiler')
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
        for name in checks.CHECKS:
            r = checks.run(name, rec.args)
            results[name] = r
            print('compare %-11s mismatch share %.2e max_abs_err %.3e ok %s'
                  '  kernel %.3f ms  plain %.3f ms%s%s'
                  % (name, 1.0 - r['agree'], r['max_abs_err'], r['ok'],
                     r['ms'], r['plain_ms'],
                     ('  err/bound %.3f' % r['err_over_bound'])
                     if 'err_over_bound' in r else '',
                     ('  (compared on %s)' % r['compared_on'])
                     if 'compared_on' in r else ''), flush=True)
        # the depth-peel rule: a second layer behind the first one
        from nvdiffrecmc_tpu_torch.ops import pallas_raster
        coef, bbox, H, W, pz, pid = rec.args['resolve']
        z1, tid1 = pallas_raster._resolve_cuda(coef, bbox, H, W, pz, pid)
        pz2 = torch.where(tid1 > 0, z1, torch.full_like(z1, 1e30))
        r2 = checks.check_resolve(coef, bbox, H, W, pz2.contiguous(),
                                  tid1.contiguous(), reps=2)
        print('compare resolve (peel layer 2) mismatch share %.2e '
              'max_abs_err %.3e ok %s'
              % (1.0 - r2['agree'], r2['max_abs_err'], r2['ok']), flush=True)
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
        if count != FRAMES:
            raise RuntimeError('kernel %s launched %d times in %d frames'
                               % (name, count, FRAMES))
    print('median ms per frame: %.3f (512x512, n_samples 4, spot 26474 '
          'tris)' % statistics.median(times), flush=True)

    # 5. small input against the plain versions on the CPU
    share, worst = small_agreement(device)
    print('64x64 render vs plain CPU render: %.4f of pixels within 1e-3 '
          '(max %.3e)' % (share, worst), flush=True)

    # 6. optional profile
    if args.profile:
        profile_frames(ds, geometry, mesh.material, FLAGS, device,
                       os.path.join(here, 'chiprun_out', 'profile_port.txt'))

    rows = []
    for name, r in results.items():
        src, rep = checks.SOURCES[name]
        row = dict(name=name, route='cuda', source=src, replaces=rep,
                   launches=launches[name], max_abs_err=r['max_abs_err'],
                   ms=r['ms'], plain_ms=r['plain_ms'], agree=r['agree'])
        if 'compared_on' in r:
            row['compared_on'] = r['compared_on']
        rows.append(row)
    print(json.dumps({'kernels': rows}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
