#!/usr/bin/env python3
"""Time the BVH walk of the trace and trace + shade kernels on one GPU,
against another checkout of the port and across the walk's design choices.

    python3 nvdiffrecmc_tpu_torch/bench_walk.py [--root DIR] --inputs FILE \
        --out FILE [--sweep]
    python3 nvdiffrecmc_tpu_torch/bench_walk.py --compare FILE FILE

--root DIR imports nvdiffrecmc_tpu_torch and chip_smoke from the checkout
at DIR (default: the one holding this script); its kernels build into
DIR/build.  On the spot mesh (26,474 triangles, leaf 128), by CUDA events:

- bvh.build on the mesh's vertices, as every training step runs it: the
  stream's time by CUDA events (mean of 20 after 3 warm-ups; the build is
  ~60 small launches, so this is mostly the host's launch time) and its
  kernels' device time and launches under torch.profiler (20 builds);
- the trace kernel on the 2^21 bench rays (chip_smoke.tracer_rays), median
  of 7 after one warm-up;
- the trace kernel on a stratum of one 512x512 frame (n_samples 4): its
  light then its BSDF rays, masked pixels at BIG with zero direction, as
  the validation loop sends each stratum (mean of 20);
- the trace + shade kernel on that frame (mean of 5).

The frame is recorded once and kept in --inputs, so that every run (and
checkout) traces the same rays.

The results (bits of both traces, trace + shade's out and visw) go to
--out; --compare counts the entries in which two such files differ.
--sweep repeats the timings for sub-boxes of 4, 8, 16, 32 and 128
triangles (128: one per leaf, the two-level walk of the earlier kernels;
results held equal to the default's on every ray but the few that graze a
box, which are counted against brute force) with the tests per ray
(checks.trace_work; on the stratum's covered rays and the first 2^16 bench
rays), and times two options of the walk's callers: the rays sorted by
direction octant then origin Morton code (the sort timed apart), and the
standalone trace kernel over all 2 n2 P ray slots of the frame (the work
of trace + shade's trace pass).  The build's device time, under
torch.profiler, comes last."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
from nvdiffrecmc_tpu_torch.bench_common import (device_ms,  # noqa: E402
                                                events_ms, main)

BIG = 3e37


def setup(dev, inputs):
    """The mesh, its BVH, the bench rays, one recorded 512x512 frame's
    trace + shade inputs and its stratum-0 rays.  The frame's inputs are
    read from the file `inputs` where it exists, else recorded and written
    there (the render's atomic sums vary in the last bits from run to run,
    so two checkouts are compared on one recording)."""
    import torch
    import chip_smoke
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import (DatasetMesh,
                                                            spot256_scene)
    from nvdiffrecmc_tpu_torch.geometry import DLMesh
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    mesh = spot256_scene(dev)
    FLAGS = chip_smoke.flags(512, 4)
    ds = DatasetMesh(mesh, 3.0, FLAGS, seed=0)
    geometry = DLMesh(ds.ref_mesh, FLAGS)
    if os.path.exists(inputs):
        samp, gb = (t.to(dev) for t in torch.load(inputs))
    else:
        with torch.no_grad(), checks.Recorder() as rec:
            chip_smoke.render_frame(ds, geometry, mesh.material, FLAGS, 0,
                                    dev)
            torch.cuda.synchronize()
        samp, gb = rec.args['trace_shade'][:2]
        torch.save((samp.cpu(), gb.cpu()), inputs)
    covered = gb[18] > 0
    ro_p = torch.where(covered[:, None], gb[0:3].T, BIG)
    dirs = [torch.where(covered[:, None], samp[0, k:k + 3].T, 0.0)
            for k in (0, 3)]
    ro_b, rd_b, _ = chip_smoke.tracer_rays(mesh, 1 << 21, dev)
    return dict(
        v_pos=mesh.v_pos, tri=mesh.t_pos_idx, samp=samp, gb=gb,
        bvh=bvh_mod.build(mesh.v_pos, mesh.t_pos_idx, leaf_size=128),
        bench=(ro_b, rd_b),
        stratum=(torch.cat([ro_p, ro_p]).contiguous(),
                 torch.cat(dirs).contiguous()),
        covered=torch.cat([covered, covered]))


def time_walk(st, bvh):
    """Times and results of both kernels on st's inputs with bvh."""
    from nvdiffrecmc_tpu_torch.ops import pallas_shade, pallas_tracer
    trace = pallas_tracer._trace_cuda
    res = {}
    t = {}
    for key in ('bench', 'stratum'):
        ro, rd = st[key]
        res['occ_' + key] = trace(ro, rd, bvh, 0.0)
        t['trace_%s_ms' % key] = events_ms(
            lambda: trace(ro, rd, bvh, 0.0), 7 if key == 'bench' else 20,
            median=key == 'bench')
    t['shadow_Mrays_per_s'] = st['bench'][0].shape[0] / t['trace_bench_ms'] \
        / 1e3
    res['ts_out'], res['ts_visw'] = pallas_shade._trace_shade_cuda(
        st['samp'], st['gb'], bvh, 0, 0.0)
    t['trace_shade_ms'] = events_ms(lambda: pallas_shade._trace_shade_cuda(
        st['samp'], st['gb'], bvh, 0, 0.0), 5)
    return t, res


def octant_morton_order(ro, rd, lo, hi):
    """Permutation sorting rays by direction octant, then by the Morton
    code of their origin in the box [lo, hi] (disabled rays, at BIG, last
    within their octant)."""
    import torch
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    octant = ((rd[:, 0] < 0).long() | ((rd[:, 1] < 0).long() << 1)
              | ((rd[:, 2] < 0).long() << 2))
    q = torch.clamp((ro - lo) / (hi - lo) * 1023.0, 0, 1023).long()
    return torch.argsort((octant << 30) | bvh_mod._morton3(q))


def exact_hits(ro, rd, v_pos, tri):
    """Any-hit of rays (ro, rd) [n, 3] against every triangle in float64
    (Moller-Trumbore, t > 0, edges included): the geometric answer that
    the float32 tests approximate."""
    import torch
    v = v_pos.double()
    t = tri.long()
    v0 = v[t[:, 0]][None]
    e1, e2 = v[t[:, 1]][None] - v0, v[t[:, 2]][None] - v0
    o, d = ro.double()[:, None], rd.double()[:, None].expand(-1, t.shape[0],
                                                           -1)
    pv = torch.linalg.cross(d, e2.expand_as(d))
    det = (e1 * pv).sum(-1)
    tv = o - v0
    u = (tv * pv).sum(-1) / det
    qv = torch.linalg.cross(tv.expand_as(d), e1.expand_as(d))
    w = (d * qv).sum(-1) / det
    dist = (e2 * qv).sum(-1) / det
    return ((u >= 0) & (w >= 0) & (u + w <= 1) & (dist > 0)).any(-1)


def differs(st, key, got, want, bvh):
    """Entries of result `key` that differ; for a trace's bits, also how
    many of the differing rays each side gets as float32 brute force does
    (every ray against every triangle row, tracer.tri_hits) and as the
    float64 geometric test does (exact_hits; up to 1,000 rays)."""
    from nvdiffrecmc_tpu_torch.ops import tracer
    idx = (got != want).reshape(-1).nonzero()[:, 0]
    out = dict(n=idx.numel())
    if key.startswith('occ_') and 0 < idx.numel() <= 1000:
        ro, rd = st[key[4:]]
        brute = tracer.tri_hits(ro[idx], rd[idx], bvh.tri, 0.0).any(-1)
        exact = exact_hits(ro[idx], rd[idx], st['v_pos'], st['tri'])
        out.update(got_as_brute=int((got[idx] == brute).sum()),
                   want_as_brute=int((want[idx] == brute).sum()),
                   got_as_exact=int((got[idx] == exact).sum()),
                   want_as_exact=int((want[idx] == exact).sum()))
    return out


def sweep(st, base):
    """Sub-box sizes, the ray sort and the split's trace pass."""
    import torch
    from nvdiffrecmc_tpu_torch import checks
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    from nvdiffrecmc_tpu_torch.ops import pallas_tracer
    out = {}
    default = bvh_mod.SUB
    lit = st['covered']
    sub_bench = tuple(x[:1 << 16] for x in st['bench'])
    try:
        for G in (4, 8, 16, 32, 128):
            bvh_mod.SUB = G
            bvh = bvh_mod.build(st['v_pos'], st['tri'], leaf_size=128)
            t, res = time_walk(st, bvh)
            t['differs'] = {k: differs(st, k, v, base[k], bvh)
                            for k, v in res.items()}
            ro, rd = st['stratum']
            for key, rays in (('stratum', (ro[lit], rd[lit])),
                              ('bench', sub_bench)):
                w = checks.trace_work(*rays, bvh)
                t.update({'%s_per_ray_%s' % (k, key): v / rays[0].shape[0]
                          for k, v in w.items()})
            t['build_ms'] = events_ms(lambda: bvh_mod.build(
                st['v_pos'], st['tri'], leaf_size=128), 20, warmup=3)
            out['sub_%d' % G] = t
            print('sweep SUB %d: %s' % (G, json.dumps(t)), flush=True)
    finally:
        bvh_mod.SUB = default

    bvh = st['bvh']
    trace = pallas_tracer._trace_cuda
    lo = bvh.aabb_lo.amin(0)
    hi = bvh.aabb_hi.amax(0)
    for key in ('bench', 'stratum'):
        ro, rd = st[key]
        perm = octant_morton_order(ro, rd, lo, hi)
        ro_s, rd_s = ro[perm].contiguous(), rd[perm].contiguous()
        occ = torch.empty_like(base['occ_' + key])
        occ[perm] = trace(ro_s, rd_s, bvh, 0.0)
        if not torch.equal(occ, base['occ_' + key]):
            raise RuntimeError('the sorted trace differs on ' + key)

        def sorted_trace():
            p = octant_morton_order(ro, rd, lo, hi)
            o = torch.empty_like(occ)
            o[p] = trace(ro[p].contiguous(), rd[p].contiguous(), bvh, 0.0)
            return o
        out['sorted_' + key] = dict(
            trace_ms=events_ms(lambda: trace(ro_s, rd_s, bvh, 0.0), 7),
            with_sort_ms=events_ms(sorted_trace, 7),
            sort_ms=events_ms(lambda: octant_morton_order(ro, rd, lo, hi),
                              7))
        print('sweep sorted %s: %s' % (key, json.dumps(out['sorted_' + key])),
              flush=True)

    samp, gb = st['samp'], st['gb']
    n2, _, P = samp.shape
    covered = gb[18] > 0
    ro_p = torch.where(covered[:, None], gb[0:3].T, BIG)
    ro_all = ro_p.repeat(2 * n2, 1).contiguous()
    rd_all = torch.cat([torch.where(covered[:, None], samp[s, k:k + 3].T, 0.0)
                        for s in range(n2) for k in (0, 3)]).contiguous()
    occ = trace(ro_all, rd_all, bvh, 0.0)
    vis = (1.0 - occ.float()).reshape(n2, 2 * P)
    if not torch.equal(vis, base['ts_visw']):
        raise RuntimeError('the split trace pass differs from visw')
    out['trace_all_slots'] = dict(
        rays=ro_all.shape[0],
        trace_ms=events_ms(lambda: trace(ro_all, rd_all, bvh, 0.0), 3),
        trace_shade_ms=base['times']['trace_shade_ms'])
    print('sweep trace kernel on all ray slots: %s'
          % json.dumps(out['trace_all_slots']), flush=True)
    return out


def run(dev, args):
    from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
    st = setup(dev, args.inputs)
    times, res = time_walk(st, st['bvh'])
    times['build_ms'] = events_ms(lambda: bvh_mod.build(
        st['v_pos'], st['tri'], leaf_size=128), 20, warmup=3)
    print('walk: %s' % json.dumps(times), flush=True)
    res['times'] = dict(times)
    if args.sweep:
        res['sweep'] = sweep(st, res)
    # the profiler session last
    times['build_device_ms'], times['build_launches'] = device_ms(
        lambda: bvh_mod.build(st['v_pos'], st['tri'], leaf_size=128), 20)
    return times, res


if __name__ == '__main__':
    main(__doc__, run, add_args=lambda p: p.add_argument(
        '--sweep', action='store_true'))
