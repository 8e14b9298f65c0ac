"""The port's tracing (nvdiffrecmc_tpu_torch/tracing.py) on the CPU: a
small pass-2 step (a textured sphere of 128 triangles as reference and
base mesh, targets rendered by DatasetMesh, batch 2 at 16x16, 2x2 strata)
under torch.profiler shows the spans of tracing.SPANS nested as the
module says; with tracing off it shows none of them, creates no range
and runs no counter op; the losses, gradients and updated parameters are
the same bits either way; shadow_rays counts covered pixels times the
strata in the fused path and in the stratum loop; kernels.LAUNCHES is
the registry the kernel wrappers add to."""

import glob
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from nvdiffrecmc_tpu_torch import config, kernels, tracing, train
from nvdiffrecmc_tpu_torch.dataset import BatchIterator, DatasetMesh
from nvdiffrecmc_tpu_torch.geometry import DLMesh
from nvdiffrecmc_tpu_torch.ops import bvh as bvh_mod
from nvdiffrecmc_tpu_torch.ops import envshade
from nvdiffrecmc_tpu_torch.render import light as light_mod
from nvdiffrecmc_tpu_torch.render import mesh as mesh_mod
from nvdiffrecmc_tpu_torch.render import texture as texture_mod

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'nvdiffrecmc_tpu_torch')
SMALL = dict(train_res=[16, 16], texture_res=[8, 8], batch=2, n_samples=2,
             iter=100, lock_pos=True, denoiser='bilateral')

# each span's nearest program span above it (None: outermost)
PARENTS = {
    'train.step': {None}, 'dataset.next': {None}, 'dataset.prepare': {None},
    'dataset.target': {'dataset.next'},
    'train.forward': {'train.step'}, 'train.backward': {'train.step'},
    'train.optimizer': {'train.step'},
    'light.tables': {'train.forward'}, 'geometry.mesh': {'train.forward'},
    'geometry.bvh': {'geometry.mesh'}, 'train.loss': {'train.forward'},
    'render.gbuffer': {'train.forward', 'dataset.target'},
    'render.shade': {'train.forward', 'dataset.target'},
    'render.finish': {'train.forward', 'dataset.target'},
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sphere(levels=2):
    """An octahedron subdivided `levels` times onto the unit sphere, with
    spherical texture coordinates: (vertices, faces, uvs) in numpy."""
    v = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
    f = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
         (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    v = [np.array(p, np.float64) for p in v]
    for _ in range(levels):
        mid, nf = {}, []

        def m(a, b):
            k = (min(a, b), max(a, b))
            if k not in mid:
                p = v[a] + v[b]
                v.append(p / np.linalg.norm(p))
                mid[k] = len(v) - 1
            return mid[k]
        for a, b, c in f:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            nf += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
        f = nf
    v = np.array(v, np.float32)
    uv = np.stack([np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(v[:, 1], -1, 1)) / np.pi], -1)
    return v, np.array(f, np.int32), uv.astype(np.float32)


def _state():
    """A fresh, seeded pass-2 training state: everything a step needs."""
    F = config.make_flags(**SMALL)
    v, f, uv = _sphere()
    rng = np.random.RandomState(3)
    kd = torch.as_tensor(rng.uniform(0.2, 0.8, (1, 8, 8, 3)).astype(
        np.float32))
    ks = torch.tensor([0.0, 0.5, 0.0]).expand(1, 8, 8, 3).contiguous()
    material = {'bsdf': 'pbr', 'kd': texture_mod.Texture2D(data=kd),
                'ks': texture_mod.Texture2D(data=ks)}
    f = torch.as_tensor(f)
    mesh = mesh_mod.Mesh(v_pos=torch.as_tensor(v), t_pos_idx=f,
                         v_tex=torch.as_tensor(uv), t_tex_idx=f,
                         material=material)
    dataset = DatasetMesh(mesh, 3.0, F, seed=5)
    geometry = DLMesh(dataset.ref_mesh, F)
    mat, static = train.initial_guess_material(None, False, F, device='cpu')
    light = light_mod.create_trainable_env_rnd(16, seed=2, device='cpu')
    F = dict(F, lock_pos=True, lock_light=False)
    params = train.make_params(geometry, mat, light)
    gen = torch.Generator()
    gen.manual_seed(11)
    return dict(F=F, geometry=geometry, static=static, params=params,
                optimizers=train.make_optimizers(params, F),
                loss_fn=train.createLoss(F),
                perms=envshade.make_perms(F['n_samples'], device='cpu'),
                batches=BatchIterator(dataset, F['batch'], seed=7), gen=gen)


def _step(s, it=50):
    """The body of optimize_mesh: the next batch, prepare_batch, a step."""
    target = train.prepare_batch(next(s['batches']), s['F']['train_res'],
                                 'random', s['gen'], s['F'])
    target = {k: target[k] for k in ('img', 'mvp', 'campos', 'background')}
    return train.train_step(s['geometry'], s['params'], s['optimizers'],
                            s['static'], target, it, s['F'], s['loss_fn'],
                            s['perms'], s['gen'])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name in tracing.SPANS]


def _parent(e, spans):
    """The innermost program span on e's thread that encloses e."""
    around = [p for p in spans if p is not e and p.thread == e.thread
              and p.time_range.start <= e.time_range.start
              and e.time_range.end <= p.time_range.end]
    if not around:
        return None
    return min(around, key=lambda p: p.time_range.end - p.time_range.start)


def test_step_spans_nest():
    s = _state()
    with tracing.recording() as rec:
        spans = _profiled(lambda: _step(s))
    names = {e.name for e in spans}
    assert names == set(PARENTS)
    for e in spans:
        p = _parent(e, spans)
        assert (p and p.name) in PARENTS[e.name], (e.name, p and p.name)
    steps = [e for e in spans if e.name == 'train.step']
    assert len(steps) == 1
    # a batch of 2: two target renders, then the training forward's
    count = {n: sum(e.name == n for e in spans) for n in names}
    assert count['dataset.target'] == 2 and count['render.shade'] == 3
    assert rec.counters['shadow_rays'] > 0


def test_off_makes_no_range_and_no_counter_op(monkeypatch):
    s = _state()
    _step(s)

    def refuse(*a, **kw):
        raise AssertionError('a range was made with tracing off')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    spans = _profiled(lambda: _step(s))
    assert spans == []

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))
    mask = torch.ones(4)
    with Ops() as ops:
        tracing.count('shadow_rays', mask, 4)
    assert ops.ops == []
    with tracing.recording() as rec:
        pass
    assert rec.counters == {}


def _grads(s):
    return [None if p.grad is None else p.grad.clone()
            for p in train._leaves(s['params'])]


def test_tracing_changes_no_bit():
    off, on = _state(), _state()
    got_off = [_step(off, it) for it in (50, 51)]
    with tracing.recording():
        got_on = [_step(on, it) for it in (50, 51)]
    for (a, b), (c, d) in zip(got_off, got_on):
        assert torch.equal(a, c) and torch.equal(b, d)
    for x, y in zip(_grads(off), _grads(on)):
        assert (x is None and y is None) or torch.equal(x, y)
    for x, y in zip(train._leaves(off['params']), train._leaves(on['params'])):
        assert torch.equal(x, y)


def _shade_inputs(n):
    """A 1x4x4 G-buffer (5 or more of 16 pixels uncovered) near a sphere,
    its light tables and BVH."""
    g = torch.Generator()
    g.manual_seed(n)
    B, H, W = 1, 4, 4
    mask = (torch.rand((B, H, W), generator=g) > 0.3).float() * 7.0
    mask.view(-1)[:5] = 0.0
    pos = torch.rand((B, H, W, 3), generator=g) * 0.2 + torch.tensor(
        [0.0, 0.0, 1.5])
    nrm = torch.nn.functional.normalize(
        torch.rand((B, H, W, 3), generator=g) - 0.5 + torch.tensor(
            [0.0, 0.0, 1.0]), dim=-1)
    view = torch.tensor([0.0, 0.0, 4.0]).expand(B, H, W, 3)
    kd = torch.rand((B, H, W, 3), generator=g)
    ks = torch.rand((B, H, W, 3), generator=g) * torch.tensor([0, 1.0, 1.0])
    base = light_mod.create_trainable_env_rnd(8, seed=n, device='cpu')
    t = light_mod.update_pdf(base)
    v, f, _ = _sphere(1)
    bvh = bvh_mod.build(torch.as_tensor(v), torch.as_tensor(f))
    return (mask, pos + nrm * 1e-3, pos, nrm, view, kd, ks, base, t.pdf,
            t.rows, t.cols, bvh, envshade.make_perms(n, device='cpu'))


@pytest.mark.parametrize('n', [2, 17], ids=['fused', 'loop'])
def test_shadow_rays_counted(monkeypatch, n):
    called = []
    fused = envshade.pallas_shade.env_shade_fused
    monkeypatch.setattr(envshade.pallas_shade, 'env_shade_fused',
                        lambda *a, **kw: called.append(1) or fused(*a, **kw))
    args = _shade_inputs(n)
    with tracing.recording() as rec:
        envshade.env_shade(*args, 9, 1.0, n_samples_x=n)
        envshade.env_shade(*args, 10, 1.0, n_samples_x=n)
    assert bool(called) == (n * n <= 256)
    covered = int((args[0] > 0).sum())
    assert 0 < covered <= 11
    assert rec.counters == {'shadow_rays': 2 * covered * n * n}


def test_launches_are_one_registry():
    assert kernels.LAUNCHES is tracing.LAUNCHES
    assert kernels.reset_launches is tracing.reset_launches
    kernels.LAUNCHES['scatter'] += 3
    tracing.reset_launches()
    assert set(kernels.LAUNCHES.values()) == {0}
    # every wrapper adds to kernels.LAUNCHES under a key of the registry
    keys = set()
    for path in glob.glob(os.path.join(PKG, '**', '*.py'), recursive=True):
        with open(path) as fh:
            src = fh.read()
        keys |= set(re.findall(r"kernels\.LAUNCHES\['(\w+)'\] \+= 1", src))
    assert keys and keys <= set(tracing.LAUNCHES)
