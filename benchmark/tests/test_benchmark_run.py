"""The run on the CPU at a small size, through the same code as on the
card but for the look for the card: its result line, the comparison with
the reference, the faults it must catch and the control it must fail;
and the reductions of the trace and the roofline count on hand-made
inputs."""

import contextlib
import json
import math
import os

import pytest
import torch

import control
import run
from harness import cell, numbers, profile, roofline
from metrics import glue_ms_per_step
from reference import follow, step

SMALL = dict(train_res=[16, 16], texture_res=[16, 16], batch=2, n_samples=2,
             probe_res=16)
SEED = 2 ** 31 + 977
CPU = torch.device('cpu')


# the DMTet cell the harness still drives (its configuration, traffic and
# limits files stay in benchmark/), out of BENCHMARK.json until its
# reference and control are proven on the card
NERF = dict(
    config={'name': 'nerf_g128', 'file': 'benchmark/configs/nerf_g128.json'},
    cell={'name': 'nerf_g128.pass1', 'config': 'nerf_g128',
          'traffic': 'midrun_pass1', 'chips': 1},
    metric={'name': 'surface_tris', 'unit': 'tris', 'better': 'lower',
            'source': 'program_counter', 'layer': 'geometry',
            'moves': 'train_images_per_s',
            'workloads': ['nerf_g128.pass1']})


def _spec(w='spot.pass2'):
    if w != NERF['cell']['name']:
        return cell.load_spec(w)
    with open(os.path.join(cell.ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    bench['configs'].append(NERF['config'])
    bench['workloads'].append(NERF['cell'])
    bench['per_layer'].append(NERF['metric'])
    return cell.load_spec(w, bench)


def _small(w):
    return dict(SMALL, dmtet_grid=8) if _spec(w)['traffic']['path'] == \
        'dmtet' else SMALL


@pytest.mark.parametrize('w', ['spot.pass2', 'spot.pass1'])
def test_result_line_untraced(w):
    spec = _spec(w)
    out = run.run_cell(spec, SEED, 0.5, False, CPU, _small(w))
    keys = list(out)
    assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics',
                        'device']
    assert 'breakdown' not in out and keys[-1] == 'checks'
    assert set(out['metrics']) == {
        m['name'] for m in run.cell_metrics(spec, 'end_to_end')}
    assert {'setup_s', 'train_images_per_s', 'peak_mem_gib'} <= \
        set(out['metrics'])
    assert out['correct'] and out['attempted'] >= 1 and out['failed'] == 0
    assert set(out['checks']) == set(spec['limits'])
    assert all(c['value'] <= c['limit'] / 5 for c in out['checks'].values())
    json.dumps(out)


# the program's spans and counters, read from the second traced pass
PROGRAM_METRICS = ('forward_ms_per_step', 'backward_ms_per_step',
                   'optimizer_ms_per_step', 'targets_ms_per_step',
                   'shade_ns_per_ray', 'host_syncs_per_step')


@pytest.mark.parametrize('w', ['spot.pass2', 'spot.pass1', 'nerf_g128.pass1'])
def test_result_line_traced(w):
    spec = _spec(w)
    spec['traffic'] = dict(spec['traffic'], trace_steps=1)
    out = run.run_cell(spec, SEED, 0.5, True, CPU, _small(w))
    assert list(out)[:6] == ['correct', 'attempted', 'failed', 'metrics',
                             'device', 'breakdown']
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
    assert {'busy_s', 'window_s'} <= set(out['device'])
    assert out['correct'] and out['attempted'] == 2
    names = {m['name'] for m in run.cell_metrics(spec, 'per_layer')}
    assert set(out['metrics']) <= names
    if 'nerf' in w:
        assert out['metrics']['surface_tris']['value'] > 0
    else:
        # without CUDA the program's spans hold no kernels and there is no
        # sync counter: each reader is wired to its key of ctx['program'],
        # and finds nothing to read here
        names = {m['name'] for m in run.cell_metrics(spec, 'per_layer')
                 if m['source'].startswith('program_')}
        assert names == set(PROGRAM_METRICS)
        assert not names & set(out['metrics'])
        for name in PROGRAM_METRICS:
            mod = __import__('metrics.' + name, fromlist=['read'])
            assert mod.read(dict(program={name: 1.5})) == 1.5
        assert 'shadow_rays' in out['notes']['program_counters']
        assert out['notes']['program_spans'] == {}


@contextlib.contextmanager
def _fault(step):
    from nvdiffrecmc_tpu_torch import train
    keep = train.train_step
    train.train_step = step(train, keep)
    try:
        yield
    finally:
        train.train_step = keep


def _unchanged(train, keep):
    def step(g, p, o, s, target, it, F, *a, **kw):
        return train.micro_grads(g, p, s, target, it, F, *a, **kw)
    return step


def _half(train, keep):
    def step(g, p, o, s, target, *a, **kw):
        return keep(g, p, o, s, train.batch_slice(target, 0, 2), *a, **kw)
    return step


def _no_update(train, keep):
    """Adam takes the step, then the parameters are put back."""
    def step(g, p, *a, **kw):
        before = [(v, v.detach().clone()) for k in ('geo', 'mat', 'light')
                  for _, v in cell._leaves(p[k], k)]
        out = keep(g, p, *a, **kw)
        with torch.no_grad():
            for v, b in before:
                v.copy_(b)
        return out
    return step


def _altered(train, keep):
    def step(*a, **kw):
        il, rl = keep(*a, **kw)
        return il * 1.01, rl
    return step


@pytest.mark.parametrize('w', ['spot.pass2', 'spot.pass1'])
@pytest.mark.parametrize('fault', [_unchanged, _no_update, _half,
                                   _altered])
def test_faults_of_the_timed_path_are_not_correct(fault, w):
    with _fault(fault):
        out = run.run_cell(_spec(w), SEED, 0.2, False, CPU, _small(w))
    assert not out['correct']


@pytest.mark.parametrize('w', ['spot.pass2', 'spot.pass1'])
def test_control_fails_the_limits(w):
    spec = _spec(w)
    got = control.readings(spec, SEED, CPU, faults=True, overrides=_small(w))
    got.pop('control_tf32_detail')
    assert set(got) == {'control_tf32'} | set(
        step.faults(spec['traffic']['path']))
    for name, gaps in got.items():
        ok, _ = numbers.verdict(gaps, spec['limits'])
        assert not ok, (name, gaps)


def test_mlp_fault_doubles_the_first_weights_gradient():
    spec = _spec('spot.pass1')
    small = _small('spot.pass1')
    ref = follow.follow(spec, SEED, CPU, 1, small)
    bad = follow.follow(spec, SEED, CPU, 1, small, fault='double_mlp_grad')
    assert bad['grads']['mat.w0'] == pytest.approx(2 * ref['grads']['mat.w0'],
                                                   rel=1e-6)
    assert bad['grads']['mat.w0'] > 0
    assert {k: v for k, v in bad['grads'].items() if k != 'mat.w0'} == \
        {k: v for k, v in ref['grads'].items() if k != 'mat.w0'}
    detail = {}
    assert numbers.gaps(bad, ref, detail)['grad_gap'] > 0
    assert detail['grad_leaf'] == 'mat.w0'
    with pytest.raises(ValueError):
        follow.follow(_spec(), SEED, CPU, 1, SMALL, fault='double_mlp_grad')


def test_numbers_hand_made():
    ref = dict(losses=[(1.0, -0.5)], grads={'a': 1.0, 'b': 4.0, 'c': 1e-9},
               change={'a': 2.0, 'b': 2.0, 'c': 5.0})
    prog = dict(losses=[(1.03, -0.5)], grads={'a': 1.5, 'b': 4.0, 'c': 0.0},
                change={'a': 2.0, 'b': 3.0, 'c': 0.0})
    detail = {}
    g = numbers.gaps(prog, ref, detail)
    assert g['loss_gap'] == pytest.approx(0.03 / 1.5)
    assert g['loss1_gap'] == g['loss_gap']
    assert g['grad_gap'] == pytest.approx(0.5 / 1.0)   # median 1.0
    assert g['change_gap'] == pytest.approx(1.0 / 2.0)  # c left out
    assert g['change_median_gap'] == pytest.approx(0.25)
    assert detail['grad_leaf'] == 'a' and detail['change_leaf'] == 'b'
    ok, checks = numbers.verdict(g, {'loss_gap': 1, 'grad_gap': 1,
                                     'change_gap': 0.4})
    assert not ok and checks['change_gap']['limit'] == 0.4
    assert set(checks) == {'loss_gap', 'grad_gap', 'change_gap'}
    assert numbers.verdict(g, {'change_median_gap': 0.3})[0]
    assert not numbers.verdict(dict(g, loss_gap=math.nan),
                               dict.fromkeys(numbers.NAMES, 1))[0]


def test_roofline_hand_counted():
    """One triangle at z = 0, two of four pixels covered at z = 5 with
    normals +z: every ray leaves the scene and enters no box, so the walk
    tests the one supernode box a ray.  bytes: 2 x 18 x 4 (the covered
    G-buffer) + 4 (mask) + 2 x 4 x 5 x 4 (light base, pdf, column CDF)
    + 2 x 4 (row CDF) + 36 (the triangle) + 4 x 6 x 4 (outputs) = 448;
    operations: (300 + 200) x 4 strata x 2 covered = 4,000, plus 25 x the
    16 rays' supernode tests (2 x 4 strata x 2 covered) = 4,400."""
    call = dict(mask=torch.tensor([[[1.0, 0.0], [0.0, 1.0]]]),
                ro=torch.tensor([0.0, 0.0, 5.0]).expand(1, 2, 2, 3),
                nrm=torch.tensor([0.0, 0.0, 1.0]).expand(1, 2, 2, 3),
                light_shape=(2, 4), n_samples_x=2,
                v_pos=torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                                    [0.0, 1.0, 0.0]]),
                t_pos_idx=torch.tensor([[0, 1, 2]]), tri_mask=None)
    w = roofline.env_shade_work(follow.plain(), call)
    assert w['covered'] == 2
    assert w['bound_bytes'] == 448
    assert w['walk_slabs'] == 16 and w['walk_tris'] == 0
    assert w['bound_ops'] == 4400
    assert w['bound_by'] == 'bytes'
    assert w['bound_s'] == pytest.approx(448 / roofline.BYTES_PER_S)


def test_trace_reductions():
    assert profile._union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert glue_ms_per_step.base_name(
        'void scatter_add_kernel<4>(float const*, long)') == \
        'scatter_add_kernel'
    assert glue_ms_per_step.base_name(
        'void at::native::vectorized_elementwise_kernel<4>(int)') == \
        'vectorized_elementwise_kernel'
    assert glue_ms_per_step.base_name('shade_trace_kernel') in \
        glue_ms_per_step.PORT_KERNELS


class _Event:
    def __init__(self, name, device, start, end, **kw):
        self.name, self.device_type = name, device
        self.time_range = type('R', (), dict(start=start, end=end))()
        self.device_time_total = 0.0
        self.__dict__.update(kw)


def test_trace_leaves_out_annotations():
    """A traced Adam step: torch.optim's ranges (Optimizer.step#Adam.step,
    zero_grad) come back on the device's timeline as annotations, which
    add no entry to the kernels; a kernel does."""
    p = torch.nn.Parameter(torch.ones(4))
    opt = torch.optim.Adam([p])
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(profile.WINDOW):
            (p * p).sum().backward()
            opt.step()
            opt.zero_grad()
    host = list(prof.events())
    ranges = {e.name for e in host if e.name.startswith('Optimizer.')}
    assert ranges
    cuda = torch.autograd.DeviceType.CUDA
    w = [e for e in host if e.name == profile.WINDOW][0].time_range
    mirrors = [_Event(n, cuda, w.start + 1, w.end - 1) for n in ranges]
    mirrors.append(_Event('some range', cuda, w.start, w.end,
                          is_user_annotation=True))
    kernel = _Event('void adam_kernel<float>(float*)', cuda, w.start + 2,
                    w.start + 3)
    fake = type('P', (), dict(events=lambda self: host + mirrors + [kernel]))
    got = profile.read(fake())
    assert [k[0] for k in got['kernels']] == [kernel.name]
    assert got['busy_us'] == 1

