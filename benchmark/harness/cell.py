"""One cell's training loop, driven through a package's public functions.

`Run` builds the state of one cell (configuration + traffic mix) from the
seed and steps it as the body of train.optimize_mesh does: the next batch
of the dataset, train.prepare_batch (random backgrounds), train.train_step,
then the host read of the two losses, the step's one sync.  It is given
the package to drive: the program (nvdiffrecmc_tpu_torch).  The plain
reference (reference/step.py) builds its own state from the same inputs
of harness.inputs, made from the seed, and draws its data order,
cameras, backgrounds and Monte-Carlo samples from the same seeds.

The traffic mix selects a path and its targets from a fixed set: the
path 'dlmesh' (pass 2 on a mesh, the reference mesh as its base) on the
targets 'mesh_render' (the reference mesh rendered by the package's
DatasetMesh at random views), the path 'dmtet' (pass 1: DMTet and the
hash-grid material) on 'mesh_render' or on 'images' (a NeRF folder,
DatasetNERF)."""

import json
import os
import time
import warnings

import torch

from . import inputs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, 'benchmark')
PATHS = (('dlmesh', 'mesh_render'), ('dmtet', 'mesh_render'),
         ('dmtet', 'images'))
CAM_RADIUS = 3.0    # train.RADIUS: DatasetMesh's camera distance
SEED_MASK = 0xFFFFFFFF


def _load(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_spec(workload, bench=None):
    """The cell's entry of BENCHMARK.json with its configuration, traffic
    mix and limits, each read from its own file by name."""
    if bench is None:
        with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
            bench = json.load(f)
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError('no workload %r in BENCHMARK.json (%s)'
                       % (workload, ', '.join(sorted(cells))))
    cell = cells[workload]
    conf = {c['name']: c for c in bench['configs']}[cell['config']]
    return dict(cell=cell, bench=bench,
                config=_load(os.path.relpath(os.path.join(ROOT, conf['file']),
                                             BENCH_DIR)),
                traffic=_load('traffic', cell['traffic'] + '.json'),
                limits=_load('limits', workload + '.json'))


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _leaves(group, prefix):
    if torch.is_tensor(group):
        return [(prefix, group)]
    if isinstance(group, dict):
        return [x for k in sorted(group) for x in _leaves(group[k],
                                                          prefix + '.' + k)]
    return [x for i, v in enumerate(group)
            for x in _leaves(v, '%s.%d' % (prefix, i))]


class Run:
    """The cell's state and its step.  pkg: the package to drive (the
    program or the reference's copy); overrides: flags that replace the
    configuration's (the CPU tests' small sizes); wrap(name, fn) -> fn:
    how the traced run wraps the public callables it spans (None: as
    they are)."""

    def __init__(self, pkg, spec, seed, device, overrides=None, wrap=None):
        self.pkg, self.spec, self.device = pkg, spec, torch.device(device)
        self.wrap = wrap or (lambda name, fn: fn)
        conf, traffic = spec['config'], spec['traffic']
        if (traffic['path'], traffic['targets']) not in PATHS:
            raise ValueError('traffic %s: unknown path or targets'
                             % spec['cell']['traffic'])
        flags = dict(conf['flags'], data_root=ROOT, **(overrides or {}))
        self.FLAGS = pkg.config.make_flags(**flags)
        F = self.FLAGS
        dev = self.device
        gin = inputs.generator(seed, dev)
        light = inputs.light(F, gin, dev)
        train = pkg.train
        self.dataset = self._dataset(seed)
        if traffic['path'] == 'dlmesh':
            self.geometry = pkg.geometry.DLMesh(self.dataset.ref_mesh, F)
            mat, self.static = train.initial_guess_material(
                None, False, F, device=dev)
            mat = self._replace(mat, inputs.textures(F, gin, dev))
            pass_idx, warmup = traffic['pass_idx'], traffic['warmup_iter']
            optimize_geometry = not F['lock_pos']
            optimize_light = not F['lock_light']
        else:
            self.geometry = pkg.geometry.DMTetGeometry(
                F['dmtet_grid'], F['mesh_scale'], F, max_tris=F['max_tris'],
                device=dev)
            mat, self.static = train.initial_guess_material(
                self.geometry, True, F, device=dev)
            self.static['no_perturbed_nrm'] = True
            mat = self._replace(mat, inputs.hashgrid_mlp(gin, dev))
            self.geometry.init_params = self._replace(
                self.geometry.init_params, inputs.sphere_sdf(
                    self.geometry.verts,
                    traffic['sdf_radius_of_scale'] * F['mesh_scale']))
            pass_idx, warmup = 0, 0
            optimize_geometry, optimize_light = True, F['learn_lighting']
        self.F = dict(F, lock_pos=not optimize_geometry,
                      lock_light=not optimize_light)
        self.params = train.make_params(self.geometry, mat, light)
        self.optimizers = train.make_optimizers(self.params, self.F,
                                                pass_idx, warmup)
        self.it = int(F['iter'] * traffic['start_iter_frac'])
        with warnings.catch_warnings():     # LambdaLR before any opt.step
            warnings.simplefilter('ignore')
            for _, sched in self.optimizers.values():
                for _ in range(self.it):
                    sched.step()
        self.loss_fn = train.createLoss(self.F)
        self.perms = pkg.ops.envshade.make_perms(F['n_samples'], device=dev)
        self.batches = pkg.dataset.BatchIterator(
            self.dataset, F['batch'], shuffle=True, seed=seed & SEED_MASK)
        self.gen = inputs.generator(seed + 1, dev)
        self.geometry.getMesh = self.wrap('getMesh', self.geometry.getMesh)

    def _replace(self, have, new):
        """The package's initial guess with each tensor replaced by the
        seeded input of the same name and shape."""
        out = dict(have)
        for k, v in new.items():
            if tuple(have[k].shape) != tuple(v.shape):
                raise ValueError('input %s: %s, the package has %s'
                                 % (k, tuple(v.shape), tuple(have[k].shape)))
            out[k] = v
        return out

    def _dataset(self, seed):
        F, pkg, dev = self.FLAGS, self.pkg, self.device
        if self.spec['traffic']['targets'] == 'mesh_render':
            mesh = pkg.dataset.dataset_mesh.spot256_scene(dev)
            return pkg.dataset.DatasetMesh(mesh, CAM_RADIUS, F,
                                           seed=seed & SEED_MASK)
        return pkg.dataset.DatasetNERF(
            os.path.join(ROOT, self.spec['config']['scene'],
                         'transforms_train.json'),
            F, examples=(F['iter'] + 1) * F['batch'], device=dev)

    def fetch(self):
        """The next batch over random backgrounds, as optimize_mesh takes
        it."""
        train = self.pkg.train
        target = self.wrap('prepare_batch', lambda: train.prepare_batch(
            next(self.batches), self.F['train_res'], 'random', self.gen,
            self.F))()
        return {k: target[k] for k in ('img', 'mvp', 'campos', 'background')}

    def train_step(self, target):
        """train.train_step at the current iteration, then the host read
        of both losses."""
        train = self.pkg.train
        il, rl = self.wrap('train_step', train.train_step)(
            self.geometry, self.params, self.optimizers, self.static, target,
            self.it, self.F, self.loss_fn, self.perms, self.gen)
        self.it += 1
        return float(il), float(rl)

    def step(self):
        """(img_loss, reg_loss, seconds in fetch, seconds in all)."""
        t0 = time.perf_counter()
        target = self.fetch()
        t1 = time.perf_counter()
        il, rl = self.train_step(target)
        return il, rl, t1 - t0, time.perf_counter() - t0

    def leaves(self):
        """(name, tensor) of every parameter leaf."""
        return [x for g in ('geo', 'mat') for x in _leaves(self.params[g], g)
                ] + [('light', self.params['light'])]

    def first_steps(self, n):
        """Run n steps and read what the reference is held to: each step's
        (img_loss, reg_loss), the norm of each leaf's first gradient as its
        optimizer took it (from Adam's first moment after step 1,
        (1 - beta1) g; 0 where step 1 left no moment), and the norm of each
        leaf's change over the n steps.  Leaves of a locked group have no
        optimizer step and are left out."""
        locks = {'geo': 'lock_pos', 'light': 'lock_light'}
        owner = {id(p): opt for g, (opt, _) in self.optimizers.items()
                 if not self.F.get(locks.get(g), False)
                 for pg in opt.param_groups for p in pg['params']}
        start = {k: v.detach().clone() for k, v in self.leaves()}
        losses, grads = [], {}
        for i in range(n):
            il, rl, _, _ = self.step()
            losses.append((il, rl))
            if i > 0:
                continue
            for k, v in self.leaves():
                opt = owner.get(id(v))
                if opt is None:
                    continue
                m = opt.state[v].get('exp_avg')
                beta1 = opt.param_groups[0]['betas'][0]
                grads[k] = 0.0 if m is None else float(
                    torch.linalg.vector_norm(m.double()) / (1.0 - beta1))
        change = {k: float(torch.linalg.vector_norm(
            (v.detach() - start[k]).double()))
            for k, v in self.leaves() if k in grads}
        _sync(self.device)
        return dict(losses=losses, grads=grads, change=change)
