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

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from nvdiffrecmc_tpu_torch.bench_common import (device_ms,  # noqa: E402
                                                events_ms, main, recording,
                                                to_device)


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
    targets = ((pallas_raster, 'resolve_batch', 'resolve'),
               (pallas_denoise, '_denoise_cuda', 'denoise'),
               (pallas_denoise, '_denoise_grad_cuda', 'denoise_grad'))
    room = {}
    with recording(targets, room) as calls:
        mesh = spot256_scene(dev)
        FLAGS = chip_smoke.flags(512, 4)
        ds = DatasetMesh(mesh, chip_smoke.CAM_RADIUS, FLAGS, seed=0)
        room.update(resolve=1, denoise=1)
        with torch.no_grad():
            chip_smoke.render_frame(ds, DLMesh(ds.ref_mesh, FLAGS),
                                    mesh.material, FLAGS, 0, dev)
        room.clear()
        st = chip_smoke.train_setup(dev, 512, 4, 1024)
        target = chip_smoke.make_targets(st, 1, 17)[0]
        room.update(denoise_grad=1)
        train.train_step(st['geometry'], st['params'], st['opts'],
                         st['static'], target, 0, st['FLAGS'], st['loss_fn'],
                         st['ds'].perms, None)
        torch.cuda.synchronize()
    torch.save({k: v[0] for k, v in calls.items()}, path)


def full_screen(dev, H, W):
    """One triangle over the whole screen, depth 0.5."""
    import torch
    v = torch.tensor([[[-3.0, -3.0, 0.5, 1.0], [3.0, -3.0, 0.5, 1.0],
                       [0.0, 4.0, 0.5, 1.0]]], device=dev)
    return (v, torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev),
            H, W, torch.full((1, H, W), -1e30, device=dev),
            torch.zeros((1, H, W), dtype=torch.int32, device=dev))


def run(dev, args):
    import torch
    from nvdiffrecmc_tpu_torch.ops import pallas_denoise, pallas_raster
    rec = {k: to_device(v, dev) for k, v in torch.load(args.inputs).items()}
    v_clip, tri, H, W = rec['resolve'][:4]
    t, res = {}, {}
    res['z1'], res['tid1'] = pallas_raster.resolve_batch(*rec['resolve'])
    pz2 = torch.where(res['tid1'] > 0, res['z1'],
                      torch.full_like(res['z1'], 1e30))
    layer2 = (v_clip, tri, H, W, pz2, res['tid1'])
    res['z2'], res['tid2'] = pallas_raster.resolve_batch(*layer2)
    for key, a in (('resolve', rec['resolve']), ('resolve_layer2', layer2),
                   ('resolve_full_screen', full_screen(dev, H, W))):
        t[key + '_ms'] = events_ms(
            lambda: pallas_raster.resolve_batch(*a), 20)
    for name, fn in (('denoise', pallas_denoise._denoise_cuda),
                     ('denoise_grad', pallas_denoise._denoise_grad_cuda)):
        a = rec[name]
        res[name] = fn(*a)
        t[name + '_ms'] = events_ms(lambda: fn(*a), 20)
    # the profiler session last
    t['resolve_device_ms'], t['resolve_launches'] = device_ms(
        lambda: pallas_raster.resolve_batch(*rec['resolve']), 20)
    return t, res


if __name__ == '__main__':
    main(__doc__, run, record)
