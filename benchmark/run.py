"""The benchmark of nvdiffrecmc_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The cell (BENCHMARK.json's `workloads`) names a configuration
(benchmark/configs/<name>.json) and a traffic mix (benchmark/traffic/
<name>.json); its limits are benchmark/limits/<cell>.json and each
per-layer metric is benchmark/metrics/<metric>.py.

A run builds the cell's state from the seed, drives its first steps
(which compile, build and warm every shape; the reference is held to
them), and measures: with --trace 0 every step that starts within
--seconds, with --trace 1 the traffic's trace_steps under torch.profiler,
then as many again inside the program's own tracing.recording(), whose
spans and counters harness/program.py reads (the first pass's readings
carry none of the recording's own work).
Once the window has closed and the program's state is freed, the plain
reference (benchmark/reference/) follows the same first steps from the
same inputs, and the run is `correct` when each number of
harness/numbers.py that the cell's limits name is within its limit.  The last line of stdout is one
JSON object: correct, attempted, failed, metrics, device, with
--trace 1 breakdown, and last the numbers compared beside their limits
(`checks`), which also end stderr.  Exits 1 without a result where the
cell's cards are missing or jax, jaxlib, flax or nvdiffrecmc_tpu was
loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]   # the harness, the program

import torch  # noqa: E402

from harness import cell, numbers, profile, program, timing  # noqa: E402
from reference import follow  # noqa: E402

FORBIDDEN = frozenset(('jax', 'jaxlib', 'flax', 'nvdiffrecmc_tpu'))
PROGRAM = 'nvdiffrecmc_tpu_torch'


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split('.')[0] in FORBIDDEN)


def cell_metrics(spec, kind):
    """The cell's metrics of BENCHMARK.json's `end_to_end` or
    `per_layer`."""
    name = spec['cell']['name']
    return [m for m in spec['bench'][kind]
            if name in m.get('workloads', [name])]


def window(run, seconds, device):
    """Every step that starts within `seconds`: (step seconds, fetch
    seconds, losses, wall seconds up to the end of the last step)."""
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    steps, fetches, losses = [], [], []
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        il, rl, fetch, total = run.step()
        steps.append(total)
        fetches.append(fetch)
        losses.append(il + rl)
    return steps, fetches, losses, time.perf_counter() - w0


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile as tprofile
    return tprofile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == 'cuda' else []))


def _traced_steps(run, n, device, fetches, losses):
    """n steps, each inside the 'window' span, the fetch ended by a
    sync."""
    for _ in range(n):
        with torch.profiler.record_function(profile.WINDOW):
            t0 = time.perf_counter()
            target = run.fetch()
            if device.type == 'cuda':
                torch.cuda.synchronize(device)
            fetches.append(time.perf_counter() - t0)
            il, rl = run.train_step(target)
            losses.append(il + rl)


def traced_window(run, spans, n, device):
    """n steps under torch.profiler, each inside the 'window' span, the
    fetch ended by a sync."""
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    spans.meshes.clear()
    fetches, losses = [], []
    launches = dict(run.pkg.kernels.LAUNCHES)
    w0 = time.perf_counter()
    with spans.patched(run.pkg.ops.envshade, 'env_shade'), \
            _profiler(device) as prof:
        _traced_steps(run, n, device, fetches, losses)
    spans.port_launches = {k: (v - launches[k]) / n for k, v in
                           run.pkg.kernels.LAUNCHES.items() if v > launches[k]}
    return prof, fetches, losses, time.perf_counter() - w0


def program_window(run, spans, n, device):
    """n more steps as traced_window takes them, inside the program's
    tracing.recording(): (the program's kernels by its spans, its
    counters, losses).  The meshes the steps make are not the first
    pass's, and are not kept."""
    kept = len(spans.meshes)
    losses = []
    with _profiler(device) as prof:
        with run.pkg.tracing.recording() as rec:
            _traced_steps(run, n, device, [], losses)
    del spans.meshes[kept:]
    return (program.read(prof, run.pkg.tracing.SPANS),
            rec.counters, losses)


def per_layer(spec, ctx):
    out = {}
    for m in cell_metrics(spec, 'per_layer'):
        mod = __import__('metrics.' + m['name'], fromlist=['read'])
        v = mod.read(ctx)
        if v is not None:
            out[m['name']] = {'value': v, 'unit': m['unit']}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0],
                                formatter_class=argparse.RawTextHelpFormatter,
                                epilog=__doc__.split('\n\n', 1)[1])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    spec = cell.load_spec(a.workload)
    chips = spec['cell']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('run.py: the cell needs %d CUDA card(s), %d found'
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 1
    device = torch.device('cuda', 0)
    result = run_cell(spec, a.seed, a.seconds, bool(a.trace), device)
    bad = forbidden_modules()
    if bad:
        print('run.py: loaded %s' % ', '.join(bad), file=sys.stderr)
        return 1
    for k, c in result['checks'].items():
        print('%s %r limit %r' % (k, c['value'], c['limit']), file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(spec, seed, seconds, trace, device, overrides=None):
    """One run of the cell on `device` (the card; the CPU tests drive it
    on the CPU at small sizes through overrides): set-up, the first steps,
    the window, then the reference.  Returns the result line's object."""
    traffic = spec['traffic']
    pkg = follow.load(PROGRAM)
    spans = profile.Spans() if trace else None
    run = cell.Run(pkg, spec, seed, device, overrides,
                   wrap=spans.wrap if trace else None)
    n_ref = traffic['reference_steps']
    prog = run.first_steps(n_ref)
    for _ in range(traffic['warmup_steps'] - n_ref):
        run.step()
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(device)
    # The window's pace is the host's dispatch: keep it to one process
    # with one intra-op thread, and out of the collector's scans of what
    # set-up left behind.
    threads = torch.get_num_threads()
    gc.collect()
    gc.freeze()
    torch.set_num_threads(1)
    setup_s = time.perf_counter() - T_START
    batch = run.F['batch']
    try:
        if trace:
            prof, fetches, losses, wall = traced_window(
                run, spans, traffic['trace_steps'], device)
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            spans_read, counters, more = program_window(
                run, spans, traffic['trace_steps'], device)
        else:
            steps, fetches, losses, wall = window(run, seconds, device)
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finally:
        torch.set_num_threads(threads)
        gc.unfreeze()
    notes = {}
    if trace:
        ctx = dict(steps=len(fetches), batch=batch, fetch_s=fetches,
                   trace=profile.read(prof), spans=spans,
                   plain=follow.plain(), notes=notes,
                   program=program.metrics(spans_read, len(more), counters))
        metrics = per_layer(spec, ctx)
        notes['port_launches_per_step'] = spans.port_launches
        notes.update(program.notes(spans_read, len(more)),
                     program_counters=counters)
        losses += more
        t = ctx['trace']
        busy = t['busy_us'] / 1e6
        by_name = {}
        for name, s, e in t['kernels']:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        breakdown = {
            'device_ops': sorted(by_name.items(), key=lambda x: -x[1])[:10],
            'idle_gaps': [[n, s] for n, s in t['idle_gaps']]}
        del prof, ctx, spans
    else:
        values = {
            'setup_s': setup_s,
            'train_images_per_s': len(steps) * batch / wall,
            'step_ms_p95': (statistics.quantiles(steps, n=20)[18] * 1e3
                            if len(steps) >= 2 else steps[0] * 1e3),
            'peak_mem_gib': peak / 2 ** 30,
        }
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in cell_metrics(spec, 'end_to_end')}
        notes['step_s'] = steps
    failed = sum(1 for x in losses if not math.isfinite(x))
    del run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = follow.follow(spec, seed, device, n_ref, overrides)
    notes['reference_s'] = time.perf_counter() - t_ref
    detail = {}
    gaps = numbers.gaps(prog, ref, detail)
    ok, checks = numbers.verdict(gaps, spec['limits'])
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': spec['cell']['chips'], 'memory_peak_bytes': peak}
    if cuda:
        dev['power_limit_w'] = timing.power_limit_w()
    out = {'correct': ok and failed == 0, 'attempted': len(losses),
           'failed': failed, 'metrics': metrics, 'device': dev}
    if trace:
        dev.update(busy_s=busy, window_s=t['window_us'] / 1e6,
                   wall_s=wall)
        out['breakdown'] = breakdown
    out['notes'] = dict(notes, gaps=gaps, compare=detail,
                        losses_program=prog['losses'],
                        losses_reference=ref['losses'])
    out['checks'] = checks
    return out


if __name__ == '__main__':
    sys.exit(main())
