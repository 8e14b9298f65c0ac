"""harness/program.py on hand-made profiles: the program's spans change
nothing profile.read reports, and a kernel belongs to the program span
around its launch, whichever thread made the launch."""

import pytest
import torch

from harness import profile, program

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA
NAMES = ('train.step', 'train.forward', 'train.backward', 'train.optimizer',
         'render.shade', 'dataset.target')


class _Event:
    def __init__(self, name, device, start, end, kind, id=0, thread=1,
                 device_us=0.0):
        self.name, self.device_type, self.activity_type = name, device, kind
        self.time_range = type('R', (), dict(start=start, end=end))()
        self.id, self.thread = id, thread
        self.device_time_total = device_us
        self.is_user_annotation = kind.endswith('user_annotation')


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return list(self._events)


def _span(name, s, e, device_us=0.0):
    return _Event(name, CPU, s, e, 'user_annotation', device_us=device_us)


def _launch(t, id, thread=1):
    return _Event('cudaLaunchKernel', CPU, t, t + 1, 'cuda_runtime', id=id,
                  thread=thread)


def _kernel(name, s, e, id):
    return _Event(name, CUDA, s, e, 'kernel', id=id)


def _base():
    """A window of one step: the benchmark's train_step span; a forward
    kernel launched at 20, a backward kernel launched from autograd's
    thread at 50, an Adam kernel at 85, and one launched at 110 in no
    program span; idle gaps between them."""
    return [
        _span(profile.WINDOW, 0, 300),
        _span('train_step', 5, 120, device_us=19.0),
        _launch(20, 11), _kernel('shade_trace_kernel', 25, 33, 11),
        _launch(50, 12, thread=2), _kernel('shade_bwd_kernel', 52, 57, 12),
        _launch(85, 13), _kernel('multi_tensor_apply_kernel', 86, 90, 13),
        _launch(110, 14), _kernel('vectorized_elementwise_kernel', 112, 114,
                                  14),
    ]


def _program_spans():
    """The program's spans of the same step, on the host, and their
    mirrors on the device's timeline."""
    host = [_span('train.step', 6, 100), _span('train.forward', 10, 40),
            _span('render.shade', 15, 30), _span('train.backward', 40, 80),
            _span('train.optimizer', 80, 99)]
    mirrors = [_Event(e.name, CUDA, e.time_range.start + 1,
                      e.time_range.end + 2, 'gpu_user_annotation')
               for e in host]
    return host + mirrors


def test_program_spans_change_no_existing_reading():
    without = profile.read(_Prof(_base()))
    with_them = profile.read(_Prof(_base() + _program_spans()))
    for key in ('kernels', 'busy_us', 'window_us', 'span_device_us',
                'idle_gaps'):
        assert with_them[key] == without[key], key
    assert without['busy_us'] == 8 + 5 + 4 + 2
    assert [n for n, _ in without['idle_gaps']] == [
        'train_step', 'train_step', 'between spans', 'train_step',
        'train_step']


def test_kernels_belong_to_the_span_around_their_launch():
    r = program.read(_Prof(_base() + _program_spans()), NAMES)
    assert r['by_path'] == {
        'train.step/train.forward/render.shade': [
            8, 1, {'shade_trace_kernel': 8}],
        'train.step/train.backward': [            # launched on thread 2
            5, 1, {'shade_bwd_kernel': 5}],
        'train.step/train.optimizer': [4, 1, {'multi_tensor_apply_kernel': 4}],
        '': [2, 1, {'vectorized_elementwise_kernel': 2}]}
    assert r['kernel_us'] == 19 and r['outside_us'] == 2
    assert program.inside(r, 'train.forward') == (8, 1)
    assert program.inside(r, 'train.step') == (17, 3)
    m = program.metrics(r, 1, {'shadow_rays': 4000, 'host_syncs': 5})
    assert m == {'forward_ms_per_step': 8e-3, 'backward_ms_per_step': 5e-3,
                 'optimizer_ms_per_step': 4e-3, 'targets_ms_per_step': None,
                 'shade_ns_per_ray': pytest.approx(2.0),
                 'host_syncs_per_step': 5 - program.HARNESS_SYNCS}
    n = program.notes(r, 2)
    assert n['program_spans']['train.step'] == [17e-3 / 2, 1.5, []]
    assert n['program_spans']['train.step/train.backward'] == [
        5e-3 / 2, 0.5, [['shade_bwd_kernel', 5e-3 / 2]]]
    assert n['outside_program_spans_pct'] == pytest.approx(100 * 2 / 19)


def test_no_program_spans_reads_nothing():
    r = program.read(_Prof(_base()), NAMES)
    assert list(r['by_path']) == [''] and r['outside_us'] == 19
    assert r['by_path'][''][:2] == [19, 4]
    assert set(program.metrics(r, 1, {}).values()) == {None}
