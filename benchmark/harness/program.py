"""The program's own spans in a traced window: the device time of the
kernels launched inside each of them.

The program (nvdiffrecmc_tpu_torch/tracing.py) opens a record_function
range at each of its layer boundaries while `tracing.recording()` is
open, so under torch.profiler its spans lie on the profiler's timeline
beside the kernels.  A kernel belongs to the innermost program span whose
host interval holds the runtime call that launched it: the kernel and its
launch share the profiler's correlation id, and the launch may come from
any thread (autograd launches the backward's kernels from its own worker
thread, outside the tree of the span `train.backward` on the main
thread).  Kernels are what profile.read counts as kernels (no copies,
sets or mirrors of annotations), clipped to the 'window' span.  Without
CUDA the profile holds no kernels, and nothing is read.

`read(prof, names)` -> {by_path {'a/b/c': [us, launches, {kernel: us}]},
kernel_us, outside_us}, where a path lists the program spans around a
launch, outermost first ('' for none); `inside` sums the paths through
one span; `metrics` and `notes` give what the result line carries.
A kernel whose launch the profile does not hold counts as outside."""

import torch

from . import profile


def _launch_times(events, cuda):
    """{correlation id: host time of the CUDA API call (cudaLaunchKernel,
    cuLaunchKernel, ...) that shares it}, on any thread."""
    return {e.id: e.time_range.start for e in events
            if e.device_type != cuda and e.name.startswith('cu')}


def _paths(times, spans):
    """For each host time, the spans that hold it, outermost first (a
    sweep over both sorted by start)."""
    spans = sorted(spans)
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [()] * len(times)
    active, j = [], 0
    for i in order:
        h = times[i]
        while j < len(spans) and spans[j][0] <= h:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] > h]
        out[i] = tuple(s[2] for s in active)
    return out


def read(prof, names):
    """The window's kernels by the program spans (`names`) around their
    launches."""
    events = prof.events()
    win = [e for e in events if e.name == profile.WINDOW]
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    cuda = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != cuda}
    names = frozenset(names)
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type != cuda and e.name in names]
    launch = _launch_times(events, cuda)
    kernels = []
    for e in events:
        if e.device_type != cuda or profile._annotation(e, host_names) or \
                e.name.lower().startswith(('memcpy', 'memset')):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            kernels.append((e.name, t - s, launch.get(e.id)))
    known = [k for k in kernels if k[2] is not None]
    by_path = {}
    for (name, us, _), path in zip(known, _paths([k[2] for k in known],
                                                  spans)):
        acc = by_path.setdefault('/'.join(path), [0.0, 0, {}])
        acc[0] += us
        acc[1] += 1
        acc[2][name] = acc[2].get(name, 0.0) + us
    kernel_us = sum(k[1] for k in kernels)
    inside_us = sum(v[0] for k, v in by_path.items() if k)
    return dict(by_path=by_path, kernel_us=kernel_us,
                outside_us=kernel_us - inside_us)


def inside(r, name):
    """(device us, launches) of the kernels launched inside span `name`,
    at any depth."""
    us = n = 0
    for path, (u, k, _) in r['by_path'].items():
        if name in path.split('/'):
            us, n = us + u, n + k
    return us, n


PHASES = (('forward_ms_per_step', 'train.forward'),
          ('backward_ms_per_step', 'train.backward'),
          ('optimizer_ms_per_step', 'train.optimizer'),
          ('targets_ms_per_step', 'dataset.target'))


# the harness's own host syncs a step: the host read of the two losses
# (the sync after a traced fetch is no synchronizing call the debug mode
# reports)
HARNESS_SYNCS = 2


def metrics(r, steps, counters):
    """The phase metrics (device ms a step inside each phase's span),
    shade_ns_per_ray (device ns inside every render.shade over the
    shadow rays counted) and host_syncs_per_step (the counter over the
    steps, less the harness's own); None where the window holds nothing
    to read."""
    out = {}
    for metric, span in PHASES:
        us, n = inside(r, span)
        out[metric] = us / 1e3 / steps if n else None
    us, n = inside(r, 'render.shade')
    rays = counters.get('shadow_rays', 0)
    out['shade_ns_per_ray'] = us * 1e3 / rays if n and rays else None
    syncs = counters.get('host_syncs')
    out['host_syncs_per_step'] = (None if syncs is None
                                  else syncs / steps - HARNESS_SYNCS)
    return out


def notes(r, steps):
    """Each span path's device ms and launches a step (the spans inside
    it included) and its three costliest kernels launched in it and no
    deeper (ms a step), and the share of the kernels' time in no span."""
    paths = set()
    for path in r['by_path']:
        parts = path.split('/') if path else []
        paths.update('/'.join(parts[:i]) for i in range(1, len(parts) + 1))
    per = {}
    for p in sorted(paths):
        us = n = 0
        for path, (u, k, _) in r['by_path'].items():
            if path == p or path.startswith(p + '/'):
                us, n = us + u, n + k
        own = r['by_path'].get(p, [0, 0, {}])[2]
        per[p] = [us / 1e3 / steps, n / steps,
                  [[k, v / 1e3 / steps] for k, v in
                   sorted(own.items(), key=lambda x: -x[1])[:3]]]
    share = 100.0 * r['outside_us'] / r['kernel_us'] if r['kernel_us'] else 0
    return dict(program_spans=per, outside_program_spans_pct=share)
