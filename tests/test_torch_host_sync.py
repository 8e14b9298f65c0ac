"""The training step never blocks the host on the card between the fetch
and the loss read.  On the CPU: one step of the benchmark's spot.pass2
cell at a small size (the harness's fetch, prepare_batch and train_step;
batch 2 at 16x16, 2x2 strata) makes no tensor from host data for an
explicit device, and indexes no tensor with a Python list, outside the
two helpers of nvdiffrecmc_tpu_torch/device.py (each such call is a
blocking copy on the card), except in the kernels' plain twins, which
run on the CPU only; the constants those helpers keep hold their values
after a step; `upload` is `torch.as_tensor` on the CPU; the recording's
`host_syncs` counter is absent there, and where CUDA exists it counts
the sync debug mode's warnings and leaves the mode as it found it.  On
the card (marked `gpu`; on a machine with a GPU and no JAX:
`python -m pytest --noconftest -m gpu tests/test_torch_host_sync.py`):
the step under torch.cuda.set_sync_debug_mode('error') raises nothing
until the loss read, gives the losses of a step with the mode off (to
the card's run-to-run spread), and a recording of a step reads
`host_syncs` 0; `upload` takes host data and passes a tensor already
on the card through."""

import contextlib
import inspect
import os
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from nvdiffrecmc_tpu_torch import device as device_mod
from nvdiffrecmc_tpu_torch import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'nvdiffrecmc_tpu_torch')
SMALL = dict(train_res=[16, 16], texture_res=[16, 16], batch=2, n_samples=2,
             probe_res=16)
SEED = 2 ** 31 + 977
# the kernels' plain twins (the CPU's stand-ins for the CUDA kernels)
PLAIN_FUNCTIONS = ('resolve_plain', 'trace_shade_plain')
PLAIN_FILES = (os.path.join(PKG, 'ops', 'tracer.py'),)
SYNC = 'called a synchronizing CUDA operation'


def _run(device):
    """The benchmark's spot.pass2 cell at SMALL on `device`."""
    bench = os.path.join(ROOT, 'benchmark')
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from harness import cell
    from reference import follow
    return cell.Run(follow.load('nvdiffrecmc_tpu_torch'),
                    cell.load_spec('spot.pass2'), SEED, device, SMALL)


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread: the suite's workers share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _step(run):
    """The harness's step up to, not including, its loss read: the
    losses as tensors."""
    target = run.fetch()
    losses = run.pkg.train.train_step(
        run.geometry, run.params, run.optimizers, run.static, target,
        run.it, run.F, run.loss_fn, run.perms, run.gen)
    run.it += 1
    return losses


def _caller():
    """(file, line, function) of the program's frame that called the
    patched function, or None where the call is not the program's own:
    from device.py's helpers, from a plain twin, or from outside the
    package."""
    stack = inspect.stack(context=0)[2:]
    for f in stack:
        if (f.function in PLAIN_FUNCTIONS
                or os.path.abspath(f.filename) in PLAIN_FILES):
            return None
    f = stack[0]
    path = os.path.abspath(f.filename)
    if (not path.startswith(PKG + os.sep)
            or path == os.path.join(PKG, 'device.py')):
        return None
    return os.path.relpath(path, ROOT), f.lineno, f.function


class _Uploads(TorchFunctionMode):
    """Records each program call that indexes a tensor with a Python list
    (PyTorch uploads the list as an index tensor)."""

    def __init__(self, sites):
        super().__init__()
        self.sites = sites

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, list) for i in idx):
                site = _caller()
                if site is not None:
                    self.sites.append(('list index',) + site)
        return func(*args, **(kwargs or {}))


def _recorded(monkeypatch, sites):
    """Patch torch.tensor, torch.as_tensor and Tensor.new_tensor to record
    the program's calls that make a tensor from host data for an explicit
    device (new_tensor: self's)."""
    def wrap(name, fn, explicit):
        def f(*args, **kw):
            data = args[1] if name == 'new_tensor' else (
                args[0] if args else kw.get('data'))
            if explicit(args, kw) and not torch.is_tensor(data):
                site = _caller()
                if site is not None:
                    sites.append((name,) + site)
            return fn(*args, **kw)
        return f
    monkeypatch.setattr(torch, 'tensor', wrap(
        'tensor', torch.tensor, lambda a, k: k.get('device') is not None))
    monkeypatch.setattr(torch, 'as_tensor', wrap(
        'as_tensor', torch.as_tensor,
        lambda a, k: (k.get('device') if len(a) < 3 else a[2]) is not None))
    monkeypatch.setattr(torch.Tensor, 'new_tensor', wrap(
        'new_tensor', torch.Tensor.new_tensor, lambda a, k: True))


@pytest.fixture(scope='module')
def stepped():
    """A spot.pass2 run on the CPU after one step taken under the
    recorders, with the calls they recorded."""
    sites = []
    with _one_thread():
        run = _run('cpu')
        with pytest.MonkeyPatch.context() as mp:
            _recorded(mp, sites)
            with _Uploads(sites):
                il, rl = _step(run)
    return run, sites, (float(il), float(rl))


def test_step_uploads_only_through_device_helpers(stepped):
    run, sites, losses = stepped
    assert all(np.isfinite(losses))
    assert sites == [], '\n'.join('%s at %s:%d in %s' % s for s in sites)


def test_recorders_see_the_pattern(monkeypatch):
    """The recorders catch a blocking copy in the program's code: a
    list index and each of the three constructors, called from a frame
    that claims to be a function of the package."""
    sites = []
    _recorded(monkeypatch, sites)
    x = torch.zeros(3)
    code = compile(
        'torch.tensor([1.0], device=x.device)\n'
        'torch.as_tensor(np.ones(2), device=x.device)\n'
        'x.new_tensor([2.0])\n'
        'x[..., [0, 2]]\n'
        'torch.as_tensor(x, device=x.device)\n',
        os.path.join(PKG, 'render', 'render.py'), 'exec')
    with _Uploads(sites):
        exec(code, {'torch': torch, 'np': np, 'x': x})
    assert [s[0] for s in sites] == ['tensor', 'as_tensor', 'new_tensor',
                                     'list index']


def test_constants_hold_their_values_after_a_step(stepped):
    kept = dict(device_mod._CONSTANTS)
    assert len(kept) >= 5      # antialias's index pairs, ks_sel, the mips
    for (shape, npdtype, raw, dtype, dev), t in kept.items():
        want = torch.as_tensor(
            np.frombuffer(raw, dtype=np.dtype(npdtype)).reshape(shape).copy(),
            dtype=dtype)
        assert t.device == dev and t.dtype == dtype
        assert torch.equal(t, want)
        assert t._version == 0           # never written in place


def test_constant_is_made_once():
    a = device_mod.constant((0., 1., 1.), torch.float32, 'cpu')
    assert device_mod.constant([0., 1., 1.], torch.float32, 'cpu') is a
    assert torch.equal(a, torch.tensor([0., 1., 1.], device='cpu'))
    tab = np.array([[1, -1], [2, 3]], np.int32)
    b = device_mod.constant(tab, torch.int64, torch.device('cpu'))
    assert b.dtype == torch.int64 and b.tolist() == tab.tolist()
    tab[0, 0] = 7                        # the caller's array, not the kept copy
    assert b[0, 0] == 1
    assert device_mod.constant((0., 1., 1.), torch.float64, 'cpu') is not a


@pytest.mark.parametrize('data, dtype', [
    (np.arange(16, dtype=np.float32).reshape(1, 4, 4), None),
    (np.array([[0.5, -1.0, 3.0]]), None),
    ([[1, 2], [3, 4]], torch.int64),
    ((0.1, 0.2, 0.3), torch.float32),
])
def test_upload_is_as_tensor_on_the_cpu(data, dtype):
    got = device_mod.upload(data, 'cpu', dtype)
    want = torch.as_tensor(data, dtype=dtype, device='cpu')
    assert got.dtype == want.dtype and got.device == want.device
    assert torch.equal(got, want)


def test_host_syncs_absent_without_cuda():
    if torch.cuda.is_available():
        pytest.skip('the CPU case: this machine has CUDA')
    with tracing.recording() as rec:
        torch.ones(3).sum().item()
    assert rec.counters.get('host_syncs', 0) == 0


def test_recording_counts_syncs_and_restores_the_mode(monkeypatch):
    """Where CUDA exists (stood in for here): the recording turns the
    sync debug mode to 'warn', counts its warnings, passes other
    warnings on, and leaves the mode it found."""
    mode = {'now': 2}
    seen = []
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'get_sync_debug_mode',
                        lambda: mode['now'])

    def set_mode(m):
        seen.append(m)
        mode['now'] = m
    monkeypatch.setattr(torch.cuda, 'set_sync_debug_mode', set_mode)
    with pytest.warns(UserWarning, match='another warning'):
        with tracing.recording() as rec:
            assert mode['now'] == 'warn'
            for _ in range(3):      # the same line: each counts
                warnings.warn(SYNC + ' (Triggered internally at x.cpp:1.)')
            warnings.warn('another warning')
    assert rec.counters['host_syncs'] == 3
    assert seen == ['warn', 2] and mode['now'] == 2
    with tracing.recording() as rec:
        pass
    assert rec.counters['host_syncs'] == 0 and mode['now'] == 2


@pytest.mark.gpu
def test_step_on_the_card_is_sync_free():
    """One warm step, then a step of a fresh run under the 'error' mode
    against the same step of another with the mode off, then a recorded
    step."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda', 0)
    _run(dev).step()                 # kernels built, constants made
    a, b = _run(dev), _run(dev)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode('error')
    try:
        losses = _step(a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # two runs of one tree agree only to the card's run-to-run spread:
    # ATen's index_add_ (the normals) adds in no fixed order (2e-7 of the
    # losses at spot.pass2's full size)
    torch.testing.assert_close([float(x) for x in losses],
                               list(b.train_step(b.fetch())),
                               rtol=1e-5, atol=0)
    with tracing.recording() as rec:
        losses = _step(a)
    assert rec.counters['host_syncs'] == 0
    assert all(np.isfinite([float(x) for x in losses]))


@pytest.mark.gpu
def test_upload_on_the_card():
    """Host data go up with their values and dtype; a tensor already on
    the card (DatasetNERF's cameras) is passed through."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device('cuda', 0)
    a = np.arange(16, dtype=np.float32).reshape(1, 4, 4)
    for data, dtype in ((a, None), (torch.as_tensor(a), None),
                        ([[1, 2], [3, 4]], torch.int64)):
        got = device_mod.upload(data, dev, dtype)
        want = torch.as_tensor(data, dtype=dtype)
        assert got.device == dev and got.dtype == want.dtype
        assert torch.equal(got.cpu(), want)
    on_card = torch.ones(3, device=dev)
    assert device_mod.upload(on_card, dev) is on_card
