#!/usr/bin/env python3
"""Time the sample kernel (with its guide tables), the shade backward, the
row scatter's launches and the visit mask on one GPU, on inputs recorded
from the main path.

    python3 nvdiffrecmc_tpu_torch/bench_sample_bwd.py [--root DIR] \
        --inputs FILE --out FILE
    python3 nvdiffrecmc_tpu_torch/bench_sample_bwd.py --compare FILE FILE

--root DIR imports nvdiffrecmc_tpu_torch and chip_smoke from the checkout
at DIR (default: the one holding this script), which must have the same
wrappers; its kernels build into DIR/build.  The inputs are recorded once,
into --inputs: the arguments of the guide and sample kernels' wrappers
from one 512x512 frame of chip_smoke.py's slice (16 strata), from one
pass-2 training step (its forward and the backward's replay) and from the
first stratum of a 512x512 validation view (n_samples 32, one stratum per
launch); from the same step the arguments of shade_bwd and of every row
scatter; and the visit mask's inputs at ray_block 1024 against the spot
mesh's leaves: the 2^21 bench rays (chip_smoke.tracer_rays) and the rays
of that validation stratum.  By CUDA events (means of 20 calls after one
warm-up, through the wrappers, so a short launch's time includes the
host's):

- the sample kernel on each recording, and the guide kernel on the
  frame's and the step's lights;
- shade_bwd on the step, launched twice more to count the entries in which
  two launches differ;
- every row scatter of the step, with its size, bound (checks.bound),
  check (checks.check_scatter) and how often its ids repeat inside a warp
  (id_repeats), and the generic instance on the largest launch's first 5
  channels;
- pass 1's largest scatter, the hash-grid table's cotangent (C = 2) of
  one batch-1 pass-1 step at spot.json's settings (chip_smoke.pass1_setup,
  iteration chip_smoke.PASS1_IT): the C = 2 instance, the generic instance
  on the same input and index_add_, with its bound, checks and id repeats;
- the mask on both inputs, with its bound and the entries that differ
  from its plain version (must be 0);
- the sample kernel's, shade_bwd's and the mask's registers, spill bytes
  and blocks per SM (kernels.occupancy); the build prints ptxas's lines
  (-Xptxas -v);
- last, under a CUDA-only torch.profiler trace (a profiler session slows
  the process's later launches): the device time and launches per call of
  the sample kernel on the frame and the validation stratum, of the guide
  kernel on the frame's light, of shade_bwd, of each row scatter, of the
  generic instance, of the hash-grid scatter's two instances and of the
  mask on both inputs.

The results (every sample output, shade_bwd's dgb and drad, both masks)
go to --out; --compare counts the entries in which two such files differ
and the non-finite entries of each."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from nvdiffrecmc_tpu_torch.bench_common import (device_ms,  # noqa: E402
                                                events_ms, main, recording,
                                                to_device)

SAMPLE_KEYS = ('sample_frame', 'sample_step_forward', 'sample_step_replay',
               'sample_validation_stratum0')
MASK_KEYS = ('mask_bench', 'mask_validation_stratum0')


def record(dev, path):
    """Record the wrappers' arguments (see the module docstring) and write
    them to path."""
    import torch
    import chip_smoke
    from nvdiffrecmc_tpu_torch import train
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (DatasetMesh,
                                                            spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    from nvdiffrecmc_tpu_torch.ops import (pallas_scatter, pallas_shade,
                                           pallas_tracer)
    targets = ((pallas_shade, '_sample_guide_cuda', 'guide'),
               (pallas_shade, '_sample_cuda', 'sample'),
               (pallas_shade, '_shade_bwd_cuda', 'shade_bwd'),
               (pallas_scatter, '_scatter_cuda', 'scatter'),
               (pallas_tracer, '_trace_cuda', 'trace'))
    room = {}
    rec = {}
    with recording(targets, room) as calls:
        mesh = spot256_scene(dev)
        FLAGS = chip_smoke.flags(512, 4)
        ds = DatasetMesh(mesh, chip_smoke.CAM_RADIUS, FLAGS, seed=0)
        geometry = DLMesh(ds.ref_mesh, FLAGS)
        room.update(guide=1, sample=1)
        with torch.no_grad():
            chip_smoke.render_frame(ds, geometry, mesh.material, FLAGS, 0,
                                    dev)
        room.clear()
        rec['guide_frame'] = calls['guide'].pop()
        rec['sample_frame'] = calls['sample'].pop()
        bvh = bvh_mod.build(mesh.v_pos, mesh.t_pos_idx, leaf_size=128)
        ro, rd, _ = chip_smoke.tracer_rays(mesh, chip_smoke.TRACER_RAYS, dev)
        rec['mask_bench'] = (bvh_mod.ray_features(ro, rd).cpu(),
                             bvh.aabb_lo.cpu(), bvh.aabb_hi.cpu(), 1024, 0.0,
                             1e16)
        st = chip_smoke.train_setup(dev, 512, 4, 1024)
        target = chip_smoke.make_targets(st, 1, 17)[0]
        room.update(guide=1, sample=2, shade_bwd=1, scatter=100)
        train.train_step(st['geometry'], st['params'], st['opts'],
                         st['static'], target, 0, st['FLAGS'], st['loss_fn'],
                         st['ds'].perms, None)
        torch.cuda.synchronize()
        room.clear()
        rec['guide_step'] = calls['guide'].pop()
        rec['sample_step_forward'], rec['sample_step_replay'] = \
            calls['sample']
        rec['shade_bwd'] = calls['shade_bwd'][0]
        rec['scatter'] = calls['scatter']
        calls['sample'].clear()
        vds = DatasetMesh(spot256_scene(dev), chip_smoke.CAM_RADIUS,
                          st['FLAGS'], validate=True)
        batch = vds.collate([vds[0]])
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        tgt = train.prepare_batch(batch, tuple(batch['img'].shape[1:3]),
                                  st['FLAGS']['background'], gen,
                                  st['FLAGS'])
        p = st['params']
        room.update(sample=1, trace=1)
        train.render_eval(st['geometry'], p['geo'], p['mat'], st['static'],
                          p['light'], tgt, st['FLAGS'])
        torch.cuda.synchronize()
        rec['sample_validation_stratum0'], = calls['sample']
        (ro, rd, bvh, tmin), = calls['trace']
        rec['mask_validation_stratum0'] = (
            bvh_mod.ray_features(ro, rd).cpu(), bvh.aabb_lo.cpu(),
            bvh.aabb_hi.cpu(), 1024, tmin, 1e16)
        # pass 1's largest launch: the hash-grid table's cotangent (C = 2)
        del st, p
        st1 = chip_smoke.pass1_setup(dev, batch=1)
        gen.manual_seed(29)
        tgt = train.prepare_batch(st1['ds'].collate([st1['ds'][0]]),
                                  st1['FLAGS']['train_res'], 'random', gen,
                                  st1['FLAGS'])
        calls['scatter'] = []
        room.update(scatter=100)
        train.train_step(st1['geometry'], st1['params'], st1['opts'],
                         st1['static'], tgt, chip_smoke.PASS1_IT,
                         st1['FLAGS'], st1['loss_fn'], st1['ds'].perms, gen)
        torch.cuda.synchronize()
        room.clear()
        rec['scatter_hashgrid'] = max(calls['scatter'],
                                      key=lambda a: a[1].numel())
    torch.save(rec, path)


def generic_args(calls, dev):
    """The largest scatter launch cut to its first 5 channels, a count
    with no instance of its own: the generic instance's input."""
    idx, vals, out_rows = to_device(
        max(calls, key=lambda a: a[1].numel()), dev)
    return idx, vals[:, :5].contiguous(), out_rows


def id_repeats(idx, vals, out_rows):
    """How often the ids of a scatter's live rows (a nonzero value and an
    id in range) repeat: the live rows, and the distinct (window, id) pairs
    among them for windows of 32 rows (a warp of the kernel), 256 and the
    whole launch: the sets of atomics a grouping of that width issues."""
    import torch
    live = (vals != 0).any(1) & (idx >= 0) & (idx < out_rows)
    pos = torch.arange(idx.shape[0], device=idx.device)[live]
    ids = idx[live]
    out = dict(live_rows=int(live.sum()))
    for width in (32, 256):
        out['distinct_per_%d' % width] = int(torch.unique(
            (pos // width) * (out_rows + 1) + ids).numel())
    out['distinct_ids'] = int(torch.unique(ids).numel())
    return out


def run(dev, args):
    import torch
    from nvdiffrecmc_tpu_torch import checks, kernels
    from nvdiffrecmc_tpu_torch.ops import (pallas_scatter, pallas_shade,
                                           pallas_tracer)
    rec = torch.load(args.inputs)
    t, res = {}, {}
    for key in SAMPLE_KEYS:
        a = to_device(rec[key], dev)
        res[key] = pallas_shade._sample_cuda(*a)
        t[key + '_ms'] = events_ms(lambda: pallas_shade._sample_cuda(*a), 20)
        t[key + '_strata'] = a[0].shape[0]
    for key in ('guide_frame', 'guide_step'):
        a = to_device(rec[key], dev)
        res[key] = pallas_shade._sample_guide_cuda(*a)
        t[key + '_ms'] = events_ms(
            lambda: pallas_shade._sample_guide_cuda(*a), 20)
        t[key + '_light'] = list(a[1].shape)
    a = to_device(rec['shade_bwd'], dev)
    res['dgb'], res['drad'] = pallas_shade._shade_bwd_cuda(*a)
    again = [pallas_shade._shade_bwd_cuda(*a) for _ in range(2)]
    t['shade_bwd_repeat_differ'] = [
        int((x != y).sum()) for x, y in zip(*again)]
    t['shade_bwd_ms'] = events_ms(
        lambda: pallas_shade._shade_bwd_cuda(*a), 20)
    scatters = []
    for i, call in enumerate(rec['scatter']):
        idx, vals, out_rows = to_device(call, dev)
        b = checks.bound('scatter', (idx, vals, out_rows))
        row = dict(
            rows=vals.shape[0], channels=vals.shape[1], out_rows=out_rows,
            ms=events_ms(lambda: pallas_scatter._scatter_cuda(
                idx, vals, out_rows), 20),
            bound_ms=b['bound_ms'], bound_by=b['bound_by'],
            ok=checks.check_scatter(idx, vals, out_rows, reps=1)['ok'],
            **id_repeats(idx, vals, out_rows))
        scatters.append(row)
    t['scatter'] = scatters
    t['scatter_sum_ms'] = sum(s['ms'] for s in scatters)
    t['scatter_sum_bound_ms'] = sum(s['bound_ms'] for s in scatters)
    gen = generic_args(rec['scatter'], dev)
    t['scatter_generic_ms'] = events_ms(
        lambda: pallas_scatter._scatter_cuda(*gen), 20)
    t['scatter_generic_ok'] = checks.check_scatter(*gen, reps=1)['ok']
    hg = to_device(rec['scatter_hashgrid'], dev)
    b = checks.bound('scatter', hg)
    t['scatter_hashgrid'] = dict(
        rows=hg[1].shape[0], channels=hg[1].shape[1], out_rows=hg[2],
        ms=events_ms(lambda: pallas_scatter._scatter_cuda(*hg), 20),
        generic_ms=events_ms(lambda: pallas_scatter._scatter_cuda(
            *hg, generic=True), 20),
        index_add_ms=checks.library_ms('scatter', hg),
        bound_ms=b['bound_ms'], bound_by=b['bound_by'],
        ok=checks.check_scatter(*hg, reps=1)['ok'],
        generic_ok=checks.check_scatter(*hg, reps=1, generic=True)['ok'],
        **id_repeats(*hg))
    for key in MASK_KEYS:
        a = to_device(rec[key], dev)
        res[key] = pallas_tracer._mask_cuda(*a)
        b = checks.bound('mask', a)
        t[key + '_ms'] = events_ms(lambda: pallas_tracer._mask_cuda(*a), 20)
        t[key + '_bound_ms'] = b['bound_ms']
        t[key + '_bound_by'] = b['bound_by']
        t[key + '_bound_rays_needed'] = b['rays_needed']
        want = pallas_tracer.visit_masks_plain(*a)
        t[key + '_differ_from_plain'] = int((res[key] != want).sum())
        t[key + '_shape_set'] = [list(want.shape), float(want.double().mean())]
    t['occupancy'] = {
        'sample_%dx%d' % tuple(rec[key][3].shape): kernels.occupancy(
            'nvk_sample_info', rec[key][3].shape[0])
        for key in ('sample_frame', 'sample_step_forward')}
    t['occupancy']['shade_bwd'] = kernels.occupancy('nvk_shade_bwd_info')
    t['occupancy']['mask'] = kernels.occupancy('nvk_mask_info')
    # profiler sessions last: later launches of the process run slower
    for key in ('sample_frame', 'sample_validation_stratum0'):
        a = to_device(rec[key], dev)
        t[key + '_device_ms'], t[key + '_launches'] = device_ms(
            lambda: pallas_shade._sample_cuda(*a), 20)
    a = to_device(rec['guide_frame'], dev)
    t['guide_frame_device_ms'], t['guide_frame_launches'] = device_ms(
        lambda: pallas_shade._sample_guide_cuda(*a), 20)
    a = to_device(rec['shade_bwd'], dev)
    t['shade_bwd_device_ms'] = device_ms(
        lambda: pallas_shade._shade_bwd_cuda(*a), 20)[0]
    for call, row in zip(rec['scatter'], scatters):
        idx, vals, out_rows = to_device(call, dev)
        row['device_ms'] = device_ms(lambda: pallas_scatter._scatter_cuda(
            idx, vals, out_rows), 20)[0]
    t['scatter_sum_device_ms'] = sum(s['device_ms'] for s in scatters)
    t['scatter_generic_device_ms'] = device_ms(
        lambda: pallas_scatter._scatter_cuda(*gen), 20)[0]
    hgr = t['scatter_hashgrid']
    hgr['device_ms'] = device_ms(
        lambda: pallas_scatter._scatter_cuda(*hg), 20)[0]
    hgr['generic_device_ms'] = device_ms(
        lambda: pallas_scatter._scatter_cuda(*hg, generic=True), 20)[0]
    for key in MASK_KEYS:
        a = to_device(rec[key], dev)
        t[key + '_device_ms'] = device_ms(
            lambda: pallas_tracer._mask_cuda(*a), 20)[0]
    return t, res


if __name__ == '__main__':
    main(__doc__, run, record)
