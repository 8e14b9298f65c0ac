"""The port's own tracing: named spans at its layer boundaries, counters
of the work it does, and the launch count of each hand-written kernel.

Spans and counters are off unless a recording is open:

    with tracing.recording() as rec:
        ...                      # train steps, renders
    rec.counters                 # {'shadow_rays': n, 'host_syncs': k}

Off, `span(name)` returns one shared no-op context after a single flag
test and `count` returns before touching its tensor.  On, each span is a
`torch.profiler.record_function` range, so under `torch.profiler` it lies
on the profiler's own timeline beside the kernels it launched (the spans
need no exporter of their own), and a counter adds to a tensor on the
device: two launches a count, no host sync until the recording ends.

Spans (SPANS; `render.*` nest under `train.forward` in training and
under `dataset.target` in a target render, `geometry.marching_tets` and
`geometry.bvh` under `geometry.mesh`):
  train.step              train.train_step (args: the iteration)
  train.forward           train.compute_grads: light tables to summed loss
  train.backward          train.compute_grads: the backward pass
  train.optimizer         train.apply_grads: scales, clip, Adam, clamps
  train.loss              the losses and regularizers of a geometry's tick
  light.tables            render.light.update_pdf
  geometry.mesh           DLMesh / DMTetGeometry.getMesh
  geometry.marching_tets  DMTet's marching tets
  geometry.bvh            ops.bvh.build
  render.gbuffer          render.render_gbuffer: rasterize, G-buffer
  render.shade            render.render_mc: env_shade of each layer
  render.finish           render.render_finish: denoise, composite, AA
  dataset.next            BatchIterator.__next__, collate included
  dataset.target          one DatasetMesh.__getitem__ render
  dataset.prepare         train.prepare_batch

Counters:
  shadow_rays  env_shade's covered pixels times n_samples_x^2, in the
               fused path and in the stratum loop
  host_syncs   (with CUDA) the times the host blocked on the card: each
               synchronizing call that torch.cuda.set_sync_debug_mode
               ('warn') reports, counted on the host as it is reported
               (the warnings of autograd's backward at its end); the
               recording sets that mode and restores the one it found.
               A sync inside a `warnings.catch_warnings` that records or
               ignores warnings is not counted.

LAUNCHES is the launch count of each kernel: its wrapper adds one where
it launches the kernel and nowhere else (counted whether or not a
recording is open); `kernels.LAUNCHES` is the same dict."""

import contextlib
import warnings

import torch

SPANS = ('train.step', 'train.forward', 'train.backward', 'train.optimizer',
         'train.loss', 'light.tables', 'geometry.mesh',
         'geometry.marching_tets', 'geometry.bvh', 'render.gbuffer',
         'render.shade', 'render.finish', 'dataset.next', 'dataset.target',
         'dataset.prepare')

LAUNCHES = {'resolve': 0, 'sample_guide': 0, 'sample': 0, 'trace_shade': 0,
            'denoise': 0, 'denoise_grad': 0, 'denoise_one': 0,
            'denoise_one_grad': 0, 'shade_bwd': 0,
            'light_scatter': 0, 'scatter': 0, 'trace': 0, 'mask': 0}

_OFF = contextlib.nullcontext()
_active = None      # the open Recording, or None
_SYNC_WARNING = 'called a synchronizing CUDA operation'


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Recording:
    """What one recording counted: `counters` {name: int}, filled when
    the recording ends."""

    def __init__(self):
        self._sums = {}         # (name, scale) -> float64 sum on the device
        self.counters = {}

    def _add(self, name, x, scale):
        s = x.sum()
        acc = self._sums.get((name, scale))
        if acc is None:
            self._sums[name, scale] = s.double()
        else:
            acc.add_(s)

    def _read(self):
        if self._sums:        # one device, one sync
            sums = torch.stack(list(self._sums.values())).tolist()
            for (name, scale), v in zip(self._sums, sums):
                self.counters[name] = (self.counters.get(name, 0)
                                       + int(v) * scale)


@contextlib.contextmanager
def recording():
    """Spans and counters on within the block; yields the Recording."""
    global _active
    if _active is not None:
        raise RuntimeError('a tracing recording is already open')
    rec = _active = Recording()
    try:
        with _syncs_counted(rec.counters):
            yield rec
    finally:
        _active = None
        rec._read()


@contextlib.contextmanager
def _syncs_counted(counters):
    """counters['host_syncs'] counts the synchronizing calls that CUDA's
    sync debug mode reports within the block; without CUDA, nothing."""
    if not torch.cuda.is_available():
        yield
        return
    counters['host_syncs'] = 0
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            counters['host_syncs'] += 1
        else:
            shown(message, category, filename, lineno, file, line)

    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.filterwarnings('always', message=_SYNC_WARNING)
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode('warn')
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def span(name, args=None):
    """The named range (args: a string the profiler keeps with it) while
    recording, else a shared no-op context."""
    if _active is None:
        return _OFF
    return torch.profiler.record_function(name, args)


def count(name, x, scale=1):
    """Add scale * x.sum() to the counter `name` while recording (x: a
    float32 tensor of 0 and 1 on the device, summed exactly below 2^24
    ones; its sum and one add, no sync)."""
    if _active is not None:
        _active._add(name, x, scale)
