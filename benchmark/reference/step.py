"""The reference's training step, written from upstream nvdiffrecmc's
semantics (train.py's optimize_mesh, geometry/dlmesh.py and
geometry/dmtet.py's tick, render/regularizer.py, ops/loss.py) as the
configuration states them, and independent of the program's code: the
batch over its random background, the losses and regularizers, the
gradient's conventions, Adam and its schedule, the projections after the
step; the mesh from geometry.py, the neural material from neural.py.

From the frozen plain copy (port_plain/, the plain twins of the
program's kernels and the renderer around them) it takes the renderer
(render.render_mesh: rasterization, G-buffer, texture sampling, env_shade,
denoiser, composite, antialias), the BVH, the light's sampling tables,
the datasets with their batch order and the configuration's defaults.

The inputs come from harness/inputs.py and the random draws from the
same seeds as the program's, so that the two are held to each other:
the light, then the textures or the hash grid, MLP and SDF from the seed;
the data order from the seed; the backgrounds, jitter and Monte-Carlo
draws from the seed + 1, in the program's order."""

import torch

from harness import cell, inputs
from . import geometry, neural

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
LIGHT_GRAD_SCALE = 64.0          # upstream's light gradient scale
TABLE_GRAD_SCALE = 128.0 / 8.0   # tcnn's loss scale over its encoder's
LIGHT_MIN = 0.01
FAULTS = ('half_batch', 'double_grad', 'double_mlp_grad')


def faults(path):
    """The FAULTS a step on `path` can have: 'double_mlp_grad' (the
    MLP's first weight) needs the neural material of 'dmtet'."""
    return FAULTS if path == 'dmtet' else FAULTS[:2]


def _srgb(x):
    return torch.where(x <= 0.0031308, x * 12.92,
                       torch.pow(torch.clamp(x, min=0.0031308), 1 / 2.4)
                       * 1.055 - 0.055)


def _log_srgb(x):
    return _srgb(torch.log(torch.clamp(x, 0.0, 65535.0) + 1.0))


def _luma(x):
    return x[..., 0:3].mean(-1, keepdim=True).expand(*x.shape[:-1], 3)


def _value(x):
    return x[..., 0:3].amax(-1, keepdim=True).expand(*x.shape[:-1], 3)


def image_loss(buffers, ref, loss):
    """The alpha's squared error and the tonemapped L1 ('logl1') of the
    color, both over the reference's coverage."""
    if loss != 'logl1':
        raise ValueError('the reference knows the loss logl1 only, not %r'
                         % loss)
    shaded, a = buffers['shaded'], ref[..., 3:]
    return (torch.mean((shaded[..., 3:] - a) ** 2)
            + torch.mean(torch.abs(_log_srgb(shaded[..., 0:3] * a)
                                   - _log_srgb(ref[..., 0:3] * a))))


def shading_loss(buffers, ref, F):
    eps = 0.001
    dl = _luma(buffers['diffuse_light'])
    sl = _luma(buffers['specular_light'])
    a = ref[..., 3:]
    img = _srgb(torch.log(torch.clamp((dl + sl) * a, 0.0, 65535.0) + 1))
    tgt = _srgb(torch.log(torch.clamp(_value(ref) * a, 0.0, 65535.0) + 1))
    err = torch.abs(img - tgt) * dl / torch.clamp(dl + sl, min=eps)
    return (torch.mean(err) * F['lambda_diffuse']
            + torch.mean(sl) / torch.clamp(torch.mean(dl), min=eps)
            * F['lambda_specular'])


def smoothness_loss(buffers, F):
    kd, ks, nrm = (buffers['kd_grad'], buffers['ks_grad'],
                   buffers['normal_grad'])
    return (torch.mean(kd[..., 0:3].mean(-1) * kd[..., -1]) * F['lambda_kd']
            + torch.mean(ks[..., :-1] * ks[..., -1:]) * F['lambda_ks']
            + torch.mean(nrm[..., :-1] * nrm[..., -1:]) * F['lambda_nrm'])


def chroma_loss(buffers, ref, F):
    eps = 0.001
    kd = buffers['kd']
    c_ref = ref[..., 0:3] / torch.clamp(_value(ref), min=eps)
    c_opt = kd[..., 0:3] / torch.clamp(_value(kd), min=eps)
    return (torch.mean(torch.abs((c_opt - c_ref) * ref[..., 3:]))
            * F['lambda_chroma'])


def laplace_loss(v, faces):
    """The uniform Laplacian's mean square: each vertex's mean offset to
    its neighbours over its faces."""
    t = faces.long()
    term = torch.zeros_like(v)
    norm = torch.zeros_like(v[:, :1])
    for i in range(3):
        a, b, c = v[t[:, i]], v[t[:, (i + 1) % 3]], v[t[:, (i + 2) % 3]]
        term = term.index_add(0, t[:, i], (b - a) + (c - a))
        norm = norm.index_add(0, t[:, i], torch.full_like(a[:, :1], 2.0))
    return torch.mean((term / torch.clamp(norm, min=1.0)) ** 2)


def base_rates(F, pass_idx):
    """{group: base learning rate}: a list holds one entry per pass, an
    entry is one rate or [geometry, material(, light)]; the light's is
    three times the material's unless given."""
    lr = F['learning_rate']
    if isinstance(lr, (list, tuple)):
        lr = lr[pass_idx]
    if isinstance(lr, (list, tuple)):
        return {'geo': lr[0], 'mat': lr[1],
                'light': lr[2] if len(lr) > 2 else lr[1] * 3.0}
    return {'geo': lr, 'mat': lr, 'light': lr * 3.0}


def schedule(count, rate, warmup):
    """The rate's factor at step count: a linear warm-up, then a decay by
    ten every 1 / rate steps."""
    if count < warmup:
        return min(max(count / max(warmup, 1), 0.0), 1.0)
    return 10.0 ** (-max(count - warmup, 0) * rate)


class Adam:
    """Adam with bias correction over a list of leaves."""

    def __init__(self, leaves, lr):
        self.leaves, self.lr, self.t = leaves, lr, 0
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def step(self, factor):
        self.t += 1
        b1, b2 = BETAS
        lr = self.lr * factor
        for p, m, v in zip(self.leaves, self.m, self.v):
            if p.grad is None:
                continue
            g = p.grad
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))


def _leaf(x):
    return x.detach().clone().requires_grad_()


def _slice(target, i, n):
    B = target['img'].shape[0]
    m = B // n
    return {k: v[i * m:(i + 1) * m] for k, v in target.items()}


class Reference:
    """One cell's state from the seed and its steps.  plain: the frozen
    package; overrides: flags over the configuration's (the CPU tests'
    small sizes); fault: None, or one of faults(path) planted in the
    step.  The dataset follows the traffic's targets, the geometry and
    material its path."""

    def __init__(self, plain, spec, seed, device, overrides=None,
                 fault=None):
        traffic = spec['traffic']
        self.path = traffic['path']
        if fault not in (None,) + faults(self.path):
            raise ValueError('fault %r on path %s' % (fault, self.path))
        self.plain, self.fault = plain, fault
        self.device = dev = torch.device(device)
        F = plain.config.make_flags(**dict(
            spec['config']['flags'], data_root=cell.ROOT,
            **(overrides or {})))
        self.F = F
        gin = inputs.generator(seed, dev)
        light = inputs.light(F, gin, dev)
        order_seed = seed & cell.SEED_MASK
        mn = {k: torch.tensor(F[k], dtype=torch.float32, device=dev)
              for k in ('kd_min', 'kd_max', 'ks_min', 'ks_max', 'nrm_min',
                        'nrm_max')}
        if traffic['targets'] == 'mesh_render':
            scene = plain.dataset.dataset_mesh.spot256_scene(dev)
            self.dataset = plain.dataset.DatasetMesh(
                scene, cell.CAM_RADIUS, F, seed=order_seed)
        else:
            self.dataset = plain.dataset.DatasetNERF(
                '%s/%s/transforms_train.json' % (cell.ROOT,
                                                 spec['config']['scene']),
                F, examples=(F['iter'] + 1) * F['batch'], device=dev)
        if self.path == 'dlmesh':
            self.base = self.dataset.ref_mesh
            tex = inputs.textures(F, gin, dev)
            geo = {'v_pos': _leaf(self.base.v_pos)}
            mat = {k: _leaf(tex[k]) for k in ('kd', 'ks', 'normal')}
            self.bounds = {'kd': (mn['kd_min'][:3], mn['kd_max'][:3]),
                           'ks': (mn['ks_min'], mn['ks_max']),
                           'normal': (mn['nrm_min'], mn['nrm_max'])}
            pass_idx, warmup = traffic['pass_idx'], traffic['warmup_iter']
            self.locked = {'geo': F['lock_pos'], 'light': F['lock_light']}
        else:
            self.grid, self.tets = geometry.kuhn_grid(
                F['dmtet_grid'], F['mesh_scale'], dev)
            self.edges = geometry.unique_edges(self.tets,
                                               self.grid.shape[0])
            nn = inputs.hashgrid_mlp(gin, dev)
            sdf = inputs.sphere_sdf(self.grid, traffic['sdf_radius_of_scale']
                                    * F['mesh_scale'])
            geo = {k: _leaf(sdf[k]) for k in ('sdf', 'deform')}
            mat = {k: _leaf(v) for k, v in nn.items()}
            self.box = (self.grid.amin(0), self.grid.amax(0))
            self.kd_ks_bounds = (torch.cat([mn['kd_min'][:3], mn['ks_min']]),
                                 torch.cat([mn['kd_max'][:3], mn['ks_max']]))
            pass_idx, warmup = 0, 0
            self.locked = {'geo': False, 'light': not F['learn_lighting']}
        self.params = {'geo': geo, 'mat': mat, 'light': _leaf(light)}
        lr = base_rates(F, pass_idx)
        self.opts = {g: Adam(self._group(g), lr[g]) for g in lr}
        self.warmup = warmup
        self.it = int(F['iter'] * traffic['start_iter_frac'])
        self.perms = plain.ops.envshade.make_perms(F['n_samples'],
                                                   device=dev)
        self.batches = plain.dataset.BatchIterator(
            self.dataset, F['batch'], shuffle=True, seed=order_seed)
        self.gen = inputs.generator(seed + 1, dev)

    def _group(self, g):
        p = self.params[g]
        return [p] if torch.is_tensor(p) else [p[k] for k in sorted(p)]

    def leaves(self):
        """(name, leaf) of every parameter, named as the harness names
        them."""
        return ([('geo.' + k, v) for k, v in sorted(self.params['geo'].items())]
                + [('mat.' + k, v)
                   for k, v in sorted(self.params['mat'].items())]
                + [('light', self.params['light'])])

    def _mesh(self):
        F, p = self.F, self.params
        if self.path == 'dlmesh':
            tex = self.plain.render.texture.Texture2D
            material = {'bsdf': F['bsdf'],
                        'no_perturbed_nrm': F['no_perturbed_nrm']}
            material.update((k, tex(data=v)) for k, v in p['mat'].items())
            b = self.base
            return geometry.with_normals_and_tangents(
                p['geo']['v_pos'], b.t_pos_idx, b.v_tex, b.t_tex_idx,
                material)
        material = {'bsdf': F['bsdf'], 'no_perturbed_nrm': True,
                    'kd_ks': neural.material(p['mat'], *self.box,
                                             *self.kd_ks_bounds)}
        res = F['dmtet_grid']
        pos = self.grid + 2.0 / (res * 2) * torch.tanh(p['geo']['deform'])
        verts, faces, uvs, uv_idx = geometry.marching_tets(
            pos, p['geo']['sdf'], self.tets)
        return geometry.with_normals_and_tangents(
            verts, faces.int(), uvs, uv_idx.int(), material)

    def _ramps(self):
        """(shadow scale, denoiser sigma, SDF regularizer weight) at this
        iteration: pass 1 ramps the shadows in and the SDF weight down."""
        F = self.F
        t_iter = self.it / F['iter']
        if self.path == 'dlmesh':
            shadow = 1.0
        else:
            shadow = min(self.it / F['shadow_ramp_iters'], 1.0)
        sigma = (max(2.0 * shadow, 1e-4) if F['denoiser'] == 'bilateral'
                 else None)
        sr = F['sdf_regularizer']
        return shadow, sigma, sr - (sr - 0.01) * min(1.0, 4.0 * t_iter)

    def _slice_losses(self, target):
        """(img_loss, reg_loss) of one slice of the batch."""
        F, plain = self.F, self.plain
        mesh = self._mesh()
        bvh = plain.ops.bvh.build(mesh.v_pos.detach(), mesh.t_pos_idx)
        tables = plain.render.light.update_pdf(self.params['light'])
        lgt = {'base': self.params['light'], 'pdf': tables.pdf,
               'rows': tables.rows, 'cols': tables.cols}
        shadow, sigma, sdf_weight = self._ramps()
        buffers = plain.render.render.render_mesh(
            F, mesh, target['mvp'], target['campos'], lgt,
            tuple(F['train_res']), bvh, self.perms, self.gen, spp=F['spp'],
            num_layers=F['layers'], msaa=True,
            background=target['background'], denoiser_sigma=sigma,
            shadow_scale=shadow, rnd_seed=int(self.it))
        ref = target['img']
        img_loss = image_loss(buffers, ref, F['loss'])
        reg = (shading_loss(buffers, ref, F) + smoothness_loss(buffers, F)
               + chroma_loss(buffers, ref, F))
        if self.path == 'dmtet':
            reg = geometry.sdf_sign_loss(self.params['geo']['sdf'],
                                         self.edges) * sdf_weight + reg
        else:
            if 'perturbed_nrm_grad' in buffers:
                reg = reg + (torch.mean(buffers['perturbed_nrm_grad'])
                             * F['lambda_nrm2'])
            fade = F['laplace_scale'] * (1 - self.it / F['iter'])
            v = self.params['geo']['v_pos']
            if F['laplace'] == 'absolute':
                reg = reg + laplace_loss(v, self.base.t_pos_idx) * fade
            elif F['laplace'] == 'relative':
                reg = reg + laplace_loss(v - self.base.v_pos,
                                         self.base.t_pos_idx) * fade
        return img_loss, reg

    def _batch(self):
        """The next batch over a random background."""
        b = next(self.batches)
        img = b['img']
        res = list(self.F['train_res'])
        if list(img.shape[1:3]) != res:     # photos at another size
            img = self.plain.ops.vecmath.scale_img_nhwc(img, res)
        B, H, W = img.shape[:3]
        bg = torch.rand((B, H, W, 3), generator=self.gen, device=img.device)
        a = img[..., 3:4]
        return {'img': torch.cat((bg * (1 - a) + img[..., 0:3] * a, a), -1),
                'mvp': torch.as_tensor(b['mvp'], device=img.device),
                'campos': torch.as_tensor(b['campos'], device=img.device),
                'background': bg}

    def step(self):
        """One optimizer step: the batch's slices (micro_batch) each
        rendered and back-propagated, their gradients and losses
        averaged; then the conventions, Adam and the projections.
        Returns (img_loss, reg_loss)."""
        F = self.F
        target = self._batch()
        if self.fault == 'half_batch':
            target = _slice(target, 0, 2)
        micro = int(F['micro_batch'] or 0)
        n = F['batch'] // micro if 0 < micro < F['batch'] else 1
        leaves = [v for _, v in self.leaves()]
        for v in leaves:
            v.grad = None
        il = rl = 0.0
        for i in range(n):
            a, b = self._slice_losses(_slice(target, i, n))
            (a + b).backward()
            il, rl = il + a.detach(), rl + b.detach()
        with torch.no_grad():
            for v in leaves:
                if v.grad is not None and n > 1:
                    v.grad.div_(n)
            if self.fault == 'double_grad':
                self._group('mat')[0].grad.mul_(2.0)
            elif self.fault == 'double_mlp_grad':
                self.params['mat']['w0'].grad.mul_(2.0)
            self._conventions()
            for g, opt in self.opts.items():
                if not self.locked.get(g, False):
                    opt.step(schedule(self.it, F['lr_decay_rate'],
                                      self.warmup))
            self._project()
        self.it += 1
        return float(il / n), float(rl / n)

    def _conventions(self):
        """The light's gradient times 64 where the light learns, the hash
        table's times 128 / 8, the global-norm clip of geometry and
        material where clip_max_norm is set."""
        F, p = self.F, self.params
        if F['learn_lighting'] and not self.locked['light']:
            p['light'].grad.mul_(LIGHT_GRAD_SCALE)
        if 'table' in p['mat']:
            p['mat']['table'].grad.mul_(TABLE_GRAD_SCALE)
        if F['clip_max_norm'] > 0.0:
            grads = [v.grad for v in self._group('geo') + self._group('mat')
                     if v.grad is not None]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(F['clip_max_norm']
                                / torch.clamp(norm, min=1e-12), max=1.0)
            for g in grads:
                g.mul_(scale)

    def _project(self):
        """Textures into their bounds, the normal map to unit length, the
        light above its floor."""
        p = self.params
        if self.path == 'dlmesh':
            for k, (lo, hi) in self.bounds.items():
                t = p['mat'][k]
                t.copy_(torch.maximum(torch.minimum(t, hi), lo))
            n = p['mat']['normal']
            n.copy_(n / torch.sqrt(torch.clamp((n * n).sum(-1, keepdim=True),
                                               min=1e-20)))
        p['light'].clamp_(min=LIGHT_MIN)

    def first_steps(self, n):
        """n steps and what the program's are held to (as
        harness.cell.Run.first_steps reads them): each step's losses, the
        norm of each learning leaf's first gradient as Adam took it, and
        the norm of each one's change over the n steps."""
        learning = {id(v) for g in self.opts if not self.locked.get(g, False)
                    for v in self._group(g)}
        start = {k: v.detach().clone() for k, v in self.leaves()}
        losses, grads = [], {}
        for i in range(n):
            losses.append(self.step())
            if i == 0:
                grads = {k: 0.0 if v.grad is None else float(
                    torch.linalg.vector_norm(v.grad.double()))
                    for k, v in self.leaves() if id(v) in learning}
        change = {k: float(torch.linalg.vector_norm(
            (v.detach() - start[k]).double()))
            for k, v in self.leaves() if k in grads}
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        return dict(losses=losses, grads=grads, change=change)
