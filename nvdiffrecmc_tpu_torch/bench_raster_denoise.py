#!/usr/bin/env python3
"""Time the coverage resolve and the bilateral denoiser on one GPU, against
another checkout of the port, on inputs recorded from the main path.

    python3 nvdiffrecmc_tpu_torch/bench_raster_denoise.py [--root DIR] \
        --inputs FILE --out FILE
    python3 nvdiffrecmc_tpu_torch/bench_raster_denoise.py --compare FILE FILE

--root DIR imports nvdiffrecmc_tpu_torch and chip_smoke from the checkout
at DIR (default: the one holding this script); its kernels build into
DIR/build.  The inputs are recorded once, into --inputs, from one 512x512
frame of chip_smoke.py's slice (the arguments of resolve_batch and of the
forward denoiser) and one pass-2 training step (the grad-mode denoiser's),
so that every run and checkout works on the same tensors.  By CUDA events
(means of 20 calls after one warm-up):

- resolve_batch, the whole call from v_clip (the same entry in every
  checkout of the port), on the frame, on its second peel layer and on one
  triangle that covers the whole 512x512 screen (the worst case of a
  route that works per triangle): the stream's time, with the host's
  launches, and on the frame, under a CUDA-only torch.profiler trace of 20
  calls, its device time and launches per call;
- the denoiser's kernel, forward and grad mode.

The results (z and tid of both layers, both denoiser outputs) go to --out;
--compare counts the entries in which two such files differ and the
non-finite entries of each."""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from nvdiffrecmc_tpu_torch.bench_walk import (device_ms,  # noqa: E402
                                              events_ms, smi_line)


def record(dev, path):
    """Record the inputs of the resolve and both denoiser modes from one
    frame and one training step, and write them to path."""
    import torch
    import chip_smoke
    from nvdiffrecmc_tpu_torch import train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (DatasetMesh,
                                                            spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import pallas_denoise, pallas_raster
    rec = {}
    targets = ((pallas_raster, 'resolve_batch', 'resolve'),
               (pallas_denoise, '_denoise_cuda', 'denoise'),
               (pallas_denoise, '_denoise_grad_cuda', 'denoise_grad'))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for (mod, attr, name), (_, _, orig) in zip(targets, saved):
        def wrapped(*a, _orig=orig, _name=name):
            rec.setdefault(_name, tuple(
                x.detach().clone() if torch.is_tensor(x) else x for x in a))
            return _orig(*a)
        setattr(mod, attr, wrapped)
    try:
        mesh = spot256_scene(dev)
        FLAGS = chip_smoke.flags(512, 4)
        ds = DatasetMesh(mesh, chip_smoke.CAM_RADIUS, FLAGS, seed=0)
        with torch.no_grad():
            chip_smoke.render_frame(ds, DLMesh(ds.ref_mesh, FLAGS),
                                    mesh.material, FLAGS, 0, dev)
        st = chip_smoke.train_setup(dev, 512, 4, 1024)
        target = chip_smoke.make_targets(st, 1, 17)[0]
        train.train_step(st['geometry'], st['params'], st['opts'],
                         st['static'], target, 0, st['FLAGS'], st['loss_fn'],
                         st['ds'].perms, None)
        torch.cuda.synchronize()
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    rec = {k: tuple(x.cpu() if torch.is_tensor(x) else x for x in v)
           for k, v in rec.items()}
    torch.save(rec, path)


def full_screen(dev, H, W):
    """One triangle over the whole screen, depth 0.5."""
    import torch
    v = torch.tensor([[[-3.0, -3.0, 0.5, 1.0], [3.0, -3.0, 0.5, 1.0],
                       [0.0, 4.0, 0.5, 1.0]]], device=dev)
    return (v, torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev),
            H, W, torch.full((1, H, W), -1e30, device=dev),
            torch.zeros((1, H, W), dtype=torch.int32, device=dev))


def run(dev, inputs):
    import torch
    from nvdiffrecmc_tpu_torch.ops import pallas_denoise, pallas_raster
    rec = {k: tuple(x.to(dev) if torch.is_tensor(x) else x for x in v)
           for k, v in torch.load(inputs).items()}
    v_clip, tri, H, W = rec['resolve'][:4]
    t, res = {}, {}
    res['z1'], res['tid1'] = pallas_raster.resolve_batch(*rec['resolve'])
    pz2 = torch.where(res['tid1'] > 0, res['z1'],
                      torch.full_like(res['z1'], 1e30))
    layer2 = (v_clip, tri, H, W, pz2, res['tid1'])
    res['z2'], res['tid2'] = pallas_raster.resolve_batch(*layer2)
    for key, args in (('resolve', rec['resolve']), ('resolve_layer2', layer2),
                      ('resolve_full_screen', full_screen(dev, H, W))):
        t[key + '_ms'] = events_ms(
            lambda: pallas_raster.resolve_batch(*args), 20)
    t['resolve_device_ms'], t['resolve_launches'] = device_ms(
        lambda: pallas_raster.resolve_batch(*rec['resolve']), 20)
    for name, fn in (('denoise', pallas_denoise._denoise_cuda),
                     ('denoise_grad', pallas_denoise._denoise_grad_cuda)):
        args = rec[name]
        res[name] = fn(*args)
        t[name + '_ms'] = events_ms(lambda: fn(*args), 20)
    return t, res


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--root', default=ROOT)
    parser.add_argument('--out')
    parser.add_argument('--inputs',
                        help='the recorded inputs (read if present, else '
                             'recorded and written)')
    parser.add_argument('--compare', nargs=2)
    args = parser.parse_args()
    import torch
    if args.compare:
        a, b = (torch.load(f) for f in args.compare)
        keys = sorted(k for k in a if torch.is_tensor(a[k]))
        print('compare %s %s: entries that differ %s; max abs difference %s; '
              'non-finite entries %s'
              % (args.compare[0], args.compare[1],
                 {k: '%d of %d' % (int((a[k] != b[k]).sum()), a[k].numel())
                  for k in keys},
                 {k: float((a[k].double() - b[k].double()).abs().max())
                  for k in keys},
                 {k: (int((~a[k].isfinite()).sum()),
                      int((~b[k].isfinite()).sum())) for k in keys}))
        return
    if not torch.cuda.is_available():
        raise SystemExit('bench_raster_denoise: torch.cuda.is_available() '
                         'is false')
    if not (args.out and args.inputs):
        parser.error('--out and --inputs are required')
    sys.path[:] = [os.path.abspath(args.root)] + [
        p for p in sys.path if os.path.abspath(p or '.') != ROOT]
    for name in list(sys.modules):
        if name == 'chip_smoke' or name.startswith('nvdiffrecmc_tpu_torch'):
            del sys.modules[name]
    from nvdiffrecmc_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    kernels.build()
    kernels.lib()
    print('root %s; build %.1f s; %s'
          % (args.root, time.perf_counter() - t0, smi_line()), flush=True)
    if not os.path.exists(args.inputs):
        record(dev, args.inputs)
    times, res = run(dev, args.inputs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({k: v.cpu() for k, v in res.items()}, args.out)
    print(json.dumps(dict(root=args.root, card=smi_line(), **times)),
          flush=True)


if __name__ == '__main__':
    main()
