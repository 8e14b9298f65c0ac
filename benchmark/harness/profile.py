"""The traced window: the spans the benchmark wraps around the program's
public callables, and what the profiler's trace says of them.

In a --trace 1 run the window runs under torch.profiler (CPU and CUDA
activities), each step inside the span 'window', and `Spans.wrap` puts
each public callable the cell names (getMesh, env_shade, prepare_batch,
train_step) in a record_function span of that name; env_shade is spanned
inside train_step only (the training forward), the target renders of a
DatasetMesh stay inside prepare_batch's span.  `read` reduces the
trace to what the per-layer metrics read: the device's intervals, the
device time of the kernels launched inside each span, the kernels by
name, and the longest idle gaps by the innermost span the host was in."""

import contextlib
import inspect

import torch

SPANS = ('getMesh', 'env_shade', 'prepare_batch', 'train_step')
WINDOW = 'window'


class Spans:
    """The wrappers of one traced window, and what they keep for the
    counters: each env_shade call's public inputs and each getMesh's
    mesh (device tensors, read once the window has closed)."""

    def __init__(self):
        self.env_shade_calls = []
        self.meshes = []
        self.in_step = False
        self.port_launches = {}

    def wrap(self, name, fn):
        if name not in SPANS:
            return fn
        if name == 'env_shade':
            sig = inspect.signature(fn)

            def call(*a, **kw):
                if not self.in_step:     # a target render of the dataset
                    return fn(*a, **kw)
                b = sig.bind(*a, **kw)
                b.apply_defaults()
                args = b.arguments
                mesh = self.meshes[-1] if self.meshes else None
                self.env_shade_calls.append(dict(
                    mask=args['mask'].detach(), ro=args['ro'].detach(),
                    nrm=args['gb_normal'].detach(),
                    light_shape=tuple(args['light_base'].shape[:2]),
                    n_samples_x=int(args['n_samples_x']), mesh=mesh))
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            return call
        if name == 'getMesh':
            def call(*a, **kw):
                with torch.profiler.record_function(name):
                    m, bvh = fn(*a, **kw)
                self.meshes.append(dict(
                    v_pos=m.v_pos.detach(), t_pos_idx=m.t_pos_idx,
                    tri_mask=getattr(m, 'tri_mask', None)))
                return m, bvh
            return call

        def call(*a, **kw):
            self.in_step = name == 'train_step'
            try:
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            finally:
                self.in_step = False
        return call

    @contextlib.contextmanager
    def patched(self, module, attr):
        """module.attr wrapped in its span for the window."""
        orig = getattr(module, attr)
        setattr(module, attr, self.wrap(attr, orig))
        try:
            yield
        finally:
            setattr(module, attr, orig)


def _device_us(e):
    v = getattr(e, 'device_time_total', None)
    return v if v is not None else e.cuda_time_total


def _union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _annotation(e, host_names):
    """Whether a device-side event is the mirror of a host annotation (a
    record_function range: the benchmark's spans, torch.optim's
    `Optimizer.step#Adam.step`) rather than a kernel, copy or set."""
    kind = str(getattr(e, 'activity_type', None) or '').lower()
    return (getattr(e, 'is_user_annotation', False) or 'annotation' in kind
            or e.name in host_names)


def read(prof):
    """{window_us, busy_us, kernels [(name, start, end)], other device
    intervals, span_device_us {name: us}, gaps [(us, span)]} of the
    profile, clipped to the 'window' span.  Device-side mirrors of host
    annotations are left out: they are ranges, not work."""
    events = prof.events()
    win = [e for e in events if e.name == WINDOW]
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    cuda = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != cuda}
    kernels, other = [], []
    spans = {k: 0.0 for k in SPANS}
    host = []
    for e in events:
        if e.device_type == cuda:
            if _annotation(e, host_names):
                continue
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t <= s:
                continue
            low = e.name.lower()
            (other if low.startswith(('memcpy', 'memset')) else
             kernels).append((e.name, s, t))
        elif e.name in spans:
            spans[e.name] += _device_us(e)
            host.append((e.time_range.start, e.time_range.end, e.name))
    intervals = sorted((s, t) for _, s, t in kernels + other)
    gaps, end = [], w0
    for s, t in intervals + [(w1, w1)]:
        if s > end:
            gaps.append((s - end, end))
        end = max(end, t)
    named = []
    for length, at in sorted(gaps, reverse=True)[:10]:
        inner = [h for h in host if h[0] <= at < h[1]]
        inner.sort(key=lambda h: h[1] - h[0])
        named.append((inner[0][2] if inner else 'between spans',
                      length / 1e6))
    return dict(window_us=w1 - w0, busy_us=_union(intervals),
                kernels=kernels, span_device_us=spans, idle_gaps=named)
