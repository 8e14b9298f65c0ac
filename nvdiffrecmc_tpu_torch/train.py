"""The trainer of the port (counterpart of the repository's train.py):
losses, batch preparation, the trainable material (2D textures, or the
hash-grid neural material of pass 1), three Adam optimizers with the JAX
package's learning-rate schedule, the gradient conventions, the post-step
projections, the validation render at the reference protocol, the
training loop with its probes and checkpoints, the bake at the pass
boundary, and the program.

Parameters are a dict {'geo', 'mat', 'light'} of leaf tensors: 'geo' is
{'v_pos'} (DLMesh) or {'sdf', 'deform'} (DMTetGeometry); 'mat' is {'kd',
'ks', 'normal'} (each a tensor, or with custom_mip a list of its mip
levels, every level a leaf) or, for the neural material, {'table', 'w0',
'w1', ...} (the flat hash-grid table and the MLP's weights).
`train_step` renders one batch (or, with micro_batch, each of its slices
in turn) through the geometry's `tick`, runs `backward()`, and updates
them in place.
`validate` renders the validation views with `render_eval` and writes
their PSNR.  `main` runs the JAX program on a reference mesh or a NeRF /
LLFF folder of images: pass 1 (DMTet) when the config sets no base_mesh, then the pass boundary (extract,
prune, unwrap, bake) and pass 2 on the baked mesh; or pass 2 alone on a
given base mesh.

Usage: python3 -m nvdiffrecmc_tpu_torch.train --config <json> [flags]
(on the CUDA card; main(argv, device='cpu') runs it on the CPU)."""

import dataclasses
import json
import os
import pickle
import statistics
import time

import numpy as np
import torch

from . import config, kernels, tracing
from .dataset import BatchIterator, DatasetLLFF, DatasetMesh, DatasetNERF
from .dataset.dataset_mesh import load_env_or_procedural
from .device import resolve, upload
from .geometry import DLMesh, DMTetGeometry
from .geometry.dmtet import ramps
from .ops import bvh as bvh_mod
from .ops import envshade, hashgrid
from .ops import loss as loss_ops
from .ops import vecmath
from .render import light as light_mod
from .render import mesh as mesh_mod
from .render import obj as obj_mod
from .render import render as render_mod
from .render import texture as texture_mod
from .uv_unwrap import uv_unwrap as _uv_unwrap_np

RADIUS = 3.0

_LOSSES = {
    'smape': ('smape', 'none'),
    'mse': ('mse', 'none'),
    'logl1': ('l1', 'log_srgb'),
    'logl2': ('mse', 'log_srgb'),
    'relativel2': ('relmse', 'none'),
    'n2n': ('n2n', 'none'),
}


def createLoss(FLAGS):
    lo, tm = _LOSSES[FLAGS['loss']]
    return lambda img, ref: loss_ops.image_loss(img, ref, loss=lo,
                                                tonemapper=tm)


def prepare_batch(target, train_res, bg_type, generator, FLAGS):
    """Mix the target's RGBA image over a background ('checker', 'black',
    'white', 'reference' or 'random', the last drawn from generator) and
    carry its camera over as tensors on the image's device."""
    with tracing.span('dataset.prepare'):
        img = target['img']
        dev = img.device
        if train_res[0] != img.shape[1] or train_res[1] != img.shape[2]:
            img = vecmath.scale_img_nhwc(img, train_res)
        B, H, W = img.shape[0:3]
        if bg_type == 'checker':
            background = torch.as_tensor(vecmath.checkerboard((H, W), 8),
                                         device=dev)[None].repeat(B, 1, 1, 1)
        elif bg_type == 'black':
            background = torch.zeros((B, H, W, 3), device=dev)
        elif bg_type == 'white':
            background = torch.ones((B, H, W, 3), device=dev)
        elif bg_type == 'reference':
            background = img[..., 0:3]
        elif bg_type == 'random':
            background = torch.rand((B, H, W, 3), generator=generator,
                                    device=dev)
        else:
            raise AssertionError('Unknown background type %s' % bg_type)
        alpha = img[..., 3:4]
        out = dict(target)
        out['img'] = torch.cat(
            (background * (1 - alpha) + img[..., 0:3] * alpha, alpha),
            dim=-1)
        out['background'] = background
        out['resolution'] = tuple(train_res)
        out['mvp'] = upload(target['mvp'], dev)
        out['campos'] = upload(target['campos'], dev)
        return out


def initial_guess_material(geometry, mlp, FLAGS, init_mat=None,
                           device=None, seed=0):
    """(mat_params, mat_static), as the JAX package guesses them.  mlp:
    the neural material of pass 1 over geometry's AABB, the default
    HashEncodingConfig, a 32-wide MLP of 2 hidden layers and 6 channels
    (kd, ks) bounded by kd_min / kd_max and ks_min / ks_max, drawn from a
    generator seeded seed.  Else trainable kd, ks and normal textures at
    FLAGS['texture_res'] and their bounds: from init_mat's textures
    (resized to texture_res) when given, else constant kd and ks drawn
    from numpy's RandomState(seed); the normal map from init_mat, else
    flat.  With FLAGS['custom_mip'] the textures made by
    texture.create_trainable (the normal map always, kd and ks where
    init_mat gives them) are explicit mip lists, as in the JAX package."""
    device = resolve(device)

    def f32(k):
        return torch.tensor(FLAGS[k], dtype=torch.float32, device=device)
    kd_min, kd_max, ks_min, ks_max = (f32('kd_min'), f32('kd_max'),
                                      f32('ks_min'), f32('ks_max'))
    if mlp:
        cfg = hashgrid.HashEncodingConfig()
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        p = hashgrid.init_mlp_texture(cfg, channels=6, generator=gen,
                                      device=device)
        static = {
            'kind': 'mlp', 'cfg': cfg, 'aabb': geometry.getAABB(),
            'min_max': (torch.cat((kd_min[0:3], ks_min)),
                        torch.cat((kd_max[0:3], ks_max))),
            'bsdf': FLAGS['bsdf'],
            'no_perturbed_nrm': bool(FLAGS['no_perturbed_nrm']),
        }
        return mlp_params(p), static
    res = tuple(FLAGS['texture_res'])

    def trainable(init):
        return texture_mod.create_trainable(
            init, res, not FLAGS['custom_mip'], device=device).data
    if init_mat is None:
        rng = np.random.RandomState(seed)
        num_ch = 4 if FLAGS['layers'] > 1 else 3
        kd_data = (torch.ones(res + (num_ch,), device=device)
                   * (kd_max - kd_min)[0:num_ch] + kd_min[0:num_ch])[None]
        ks = np.concatenate((
            rng.uniform(0.0, 0.01, size=res + (1,)),
            rng.uniform(float(ks_min[1]), float(ks_max[1]), size=res + (1,)),
            rng.uniform(float(ks_min[2]), float(ks_max[2]), size=res + (1,))),
            axis=2)
        ks_data = torch.as_tensor(ks.astype(np.float32), device=device)[None]
    else:
        kd_data = trainable(init_mat['kd'])
        ks_data = trainable(init_mat['ks'])
    if init_mat is None or 'normal' not in init_mat:
        nrm_data = trainable(np.array([0, 0, 1], np.float32))
    else:
        nrm_data = trainable(init_mat['normal'])
    params = {'kd': kd_data, 'ks': ks_data, 'normal': nrm_data}
    static = {
        'kind': 'tex',
        'min_max': {'kd': (kd_min, kd_max), 'ks': (ks_min, ks_max),
                    'normal': (f32('nrm_min'), f32('nrm_max'))},
        'bsdf': FLAGS['bsdf'],
        'no_perturbed_nrm': bool(FLAGS['no_perturbed_nrm']),
    }
    return params, static


def mlp_params(p):
    """hashgrid.MLPTexture3DParams -> the 'mat' dict {'table', 'w0', ...}."""
    out = {'table': p.table}
    out.update(('w%d' % i, w) for i, w in enumerate(p.weights))
    return out


def mlp_texture(mat_params):
    """The 'mat' dict of the neural material -> MLPTexture3DParams."""
    n = sum(1 for k in mat_params if k.startswith('w'))
    return hashgrid.MLPTexture3DParams(
        table=mat_params['table'],
        weights=tuple(mat_params['w%d' % i] for i in range(n)))


def make_material(mat_params, mat_static):
    """The material dict the shader reads, over the trainable tensors."""
    mat = {'bsdf': mat_static['bsdf'],
           'no_perturbed_nrm': mat_static['no_perturbed_nrm']}
    if mat_static.get('kind') == 'mlp':
        p = mlp_texture(mat_params)
        cfg, aabb, mm = (mat_static['cfg'], mat_static['aabb'],
                         mat_static['min_max'])
        mat['kd_ks'] = lambda pos: hashgrid.sample_mlp_texture(
            p, cfg, aabb, mm, pos)
        return mat
    for k in ('kd', 'ks', 'normal'):
        if k in mat_params:
            mat[k] = texture_mod.Texture2D(
                data=mat_params[k], min_max=mat_static['min_max'][k])
    return mat


@torch.no_grad()
def clamp_material(mat_params, mat_static):
    """Post-step projections, in place: each texture (every mip level of a
    custom chain) onto its bounds, the normal map back to unit length
    (none for the neural material)."""
    if mat_static.get('kind') == 'mlp':
        return mat_params
    for k in ('kd', 'ks', 'normal'):
        if k in mat_params:
            tex = texture_mod.Texture2D(data=mat_params[k],
                                        min_max=mat_static['min_max'][k])
            tex = tex.clamp().normalize() if k == 'normal' else tex.clamp()
            for dst, src in zip(_group(mat_params[k]), _group(tex.data)):
                dst.copy_(src)
    return mat_params


def make_params(geometry, mat_params, light_base):
    """Leaf tensors (requires_grad) for the three parameter groups (a mip
    list stays a list of leaves), copied so that an in-place update never
    reaches the geometry's initial guess."""
    def leaf(x):
        if isinstance(x, list):
            return [leaf(m) for m in x]
        return x.detach().clone().requires_grad_()
    return {'geo': {k: leaf(v) for k, v in geometry.parameters().items()},
            'mat': {k: leaf(v) for k, v in mat_params.items()},
            'light': leaf(light_base)}


def _group(p):
    """The leaf tensors of a tensor, a list of them or a dict of either."""
    if torch.is_tensor(p):
        return [p]
    vals = p.values() if isinstance(p, dict) else p
    return [t for v in vals for t in _group(v)]


def _map(fn, p):
    """p (a tensor, a list of them or a dict of either) with fn applied to
    every tensor."""
    if torch.is_tensor(p):
        return fn(p)
    if isinstance(p, dict):
        return {k: _map(fn, v) for k, v in p.items()}
    return [_map(fn, v) for v in p]


def lr_schedule(count, lr_decay_rate, warmup_iter=0):
    """The JAX package's schedule: a linear warm-up over warmup_iter
    steps, then 10^(-(count - warmup_iter) * lr_decay_rate)."""
    if count < warmup_iter:
        return min(max(count / max(warmup_iter, 1), 0.0), 1.0)
    return 10.0 ** (-max(count - warmup_iter, 0) * lr_decay_rate)


def make_optimizers(params, FLAGS, pass_idx=0, warmup_iter=0):
    """{'geo', 'mat', 'light'} -> (Adam, LambdaLR): b1 0.9, b2 0.999, eps
    1e-8; base rates as the JAX package derives them from
    FLAGS['learning_rate']: a list holds one entry per pass, and an entry
    is a number or [pos, mat(, light)] (the light's is 3x the material's
    by default); the schedule factor at step count 0, 1, ... as optax
    applies it."""
    lr = FLAGS['learning_rate']
    lr = lr[pass_idx] if isinstance(lr, (list, tuple)) else lr
    if isinstance(lr, (list, tuple)):
        lr_pos, lr_mat = lr[0], lr[1]
        lr_lgt = lr[2] if len(lr) > 2 else lr[1] * 3.0
    else:
        lr_pos = lr_mat = lr
        lr_lgt = lr * 3.0
    rate = FLAGS['lr_decay_rate']
    out = {}
    for name, base in (('geo', lr_pos), ('mat', lr_mat), ('light', lr_lgt)):
        opt = torch.optim.Adam(_group(params[name]), lr=base,
                               betas=(0.9, 0.999), eps=1e-8)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda c: lr_schedule(c, rate, warmup_iter))
        out[name] = (opt, sched)
    return out


def denoiser_sigma(it, FLAGS):
    """Pass 1's denoiser sigma at iteration it, max(2 shadow ramp, 1e-4),
    in float32 as the JAX package computes it."""
    return float(np.maximum(np.float32(2.0) * np.float32(ramps(it, FLAGS)[0]),
                            np.float32(1e-4)))


def _leaves(params):
    return _group(params['geo']) + _group(params['mat']) + [params['light']]


def clear_grads(params):
    """Drop the .grad of every parameter leaf."""
    for p in _leaves(params):
        p.grad = None


def compute_grads(geometry, params, mat_static, target, it, FLAGS, loss_fn,
                  perms, generator, uniforms=None, offsets=None):
    """Render target's view with the current parameters and backpropagate
    img_loss + reg_loss into their .grad, added to what .grad holds (see
    clear_grads).  Returns (img_loss, reg_loss), detached."""
    with tracing.span('train.forward'):
        tables = light_mod.update_pdf(params['light'])
        lgt = {'base': params['light'], 'pdf': tables.pdf,
               'rows': tables.rows, 'cols': tables.cols}
        sigma = None
        if FLAGS['denoiser'] == 'bilateral':
            # pass 1 ramps the denoiser with the shadows (dmtet.py:220-221)
            sigma = (denoiser_sigma(it, FLAGS)
                     if isinstance(geometry, DMTetGeometry) else 2.0)
        target_full = dict(target, resolution=tuple(FLAGS['train_res']),
                           spp=FLAGS['spp'])
        material = make_material(params['mat'], mat_static)
        img_loss, reg_loss = geometry.tick(
            params['geo'], material, lgt, target_full, loss_fn, it, FLAGS,
            sigma, perms, generator, rnd_seed=int(it), uniforms=uniforms,
            offsets=offsets)
        loss = img_loss + reg_loss
    with tracing.span('train.backward'):
        loss.backward()
    return img_loss.detach(), reg_loss.detach()


@torch.no_grad()
def apply_grads(params, optimizers, mat_static, FLAGS):
    """The JAX package's apply_grads on the .grad of params: the light
    gradient times 64 when the light is optimized, the hash-grid table's
    times 128 / 8 (the reference's loss scale and encoder-parameter scale),
    the global-norm clip of geometry and material when clip_max_norm > 0,
    one Adam step per optimized group (lock_pos and lock_light each hold a
    group: its parameters, Adam state and schedule stay as they are), the
    projections (the light's applies locked or not, as in JAX)."""
    with tracing.span('train.optimizer'):
        locked = {'geo': FLAGS['lock_pos'], 'light': FLAGS['lock_light']}
        if FLAGS['learn_lighting'] and not locked['light']:
            params['light'].grad.mul_(64.0)
        if mat_static.get('kind') == 'mlp':
            params['mat']['table'].grad.mul_(128.0 / 8.0)
        if FLAGS['clip_max_norm'] > 0.0:
            grads = [p.grad for p in
                     _group(params['geo']) + _group(params['mat'])
                     if p.grad is not None]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(FLAGS['clip_max_norm']
                                / torch.clamp(norm, min=1e-12), max=1.0)
            for g in grads:
                g.mul_(scale)
        for name, (opt, sched) in optimizers.items():
            if not locked.get(name, False):
                opt.step()
                sched.step()
        clamp_material(params['mat'], mat_static)
        params['light'].clamp_(min=0.01)


def batch_slice(target, i, n):
    """Slice i of n of target: every tensor whose first axis is the
    batch's cut to that slice's images, anything else as it is."""
    B = target['img'].shape[0]
    m = B // n
    return {k: (v[i * m:(i + 1) * m]
                if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == B
                else v) for k, v in target.items()}


def micro_grads(geometry, params, mat_static, target, it, FLAGS, loss_fn,
                perms, generator, uniforms=None, offsets=None):
    """The JAX package's step gradient: .grad cleared, then compute_grads
    on each of config.micro_slices(FLAGS) slices of the batch in turn
    (each slice builds its own mesh and draws its uniforms from
    generator), the gradients summed in .grad and divided by the slice
    count, the losses averaged.  uniforms and offsets: None, or one entry
    per slice.  Returns (img_loss, reg_loss)."""
    n = config.micro_slices(FLAGS)
    clear_grads(params)
    il = rl = 0.0
    for i in range(n):
        a, b = compute_grads(
            geometry, params, mat_static, batch_slice(target, i, n), it,
            FLAGS, loss_fn, perms, generator,
            uniforms=None if uniforms is None else uniforms[i],
            offsets=None if offsets is None else offsets[i])
        il, rl = il + a, rl + b
    if n > 1:
        with torch.no_grad():
            for p in _leaves(params):
                if p.grad is not None:
                    p.grad.div_(n)
    return il / n, rl / n


def train_step(geometry, params, optimizers, mat_static, target, it, FLAGS,
               loss_fn, perms, generator, **kw):
    """One optimizer step: micro_grads (kw: uniforms, offsets, one entry
    per slice), then apply_grads.  Returns (img_loss, reg_loss)."""
    with tracing.span('train.step', str(it)):
        losses = micro_grads(geometry, params, mat_static, target, it,
                             FLAGS, loss_fn, perms, generator, **kw)
        apply_grads(params, optimizers, mat_static, FLAGS)
    return losses


# ---------------------------------------------------------------------------
# The pass boundary: extract the DMTet mesh, unwrap it, bake the neural
# material into textures (reference train.py:108-152)
# ---------------------------------------------------------------------------

def _component_labels(faces, n_verts):
    """Each face's connected component [T] (faces sharing a vertex are
    connected): the smallest vertex id of the component, by label
    propagation over the faces."""
    f = np.asarray(faces, np.int64)
    label = np.arange(n_verts, dtype=np.int64)
    while True:
        low = label[f].min(axis=1)
        new = label.copy()
        for i in range(3):
            np.minimum.at(new, f[:, i], low)
        new = new[new]                      # pointer jumping
        if np.array_equal(new, label):
            return label[f[:, 0]]
        label = new


def prune_small_components(f, ft, min_frac):
    """Drop the connected components with fewer than min_frac of the
    faces (min_frac 0: keep all).  When every component is that small,
    the largest is kept (the first of equal ones), where the JAX package
    drops them all.  Returns (f, ft, faces dropped)."""
    if min_frac <= 0 or len(f) == 0:
        return f, ft, 0
    labels = _component_labels(f, int(f.max()) + 1)
    uniq, counts = np.unique(labels, return_counts=True)
    small = counts < min_frac * len(f)
    if small.all():
        small[np.argmax(counts)] = False
    if not small.any():
        return f, ft, 0
    keep = ~np.isin(labels, uniq[small])
    return f[keep], ft[keep], int((~keep).sum())


@torch.no_grad()
def extract_static_mesh(geometry, params, FLAGS, times=None):
    """The DMTet mesh on the host without its padding slots and small
    components (FLAGS['prune_components']), its vertices and texture
    coordinates compacted to those the faces use; a Mesh on the
    geometry's device.  Marching tets runs again in buffers sized to the
    surface (getMesh's whole), so every triangle is extracted where
    training's fixed slots truncate (the JAX package bakes the truncated
    buffers); the compaction keeps order, so a surface that fits the slots
    gives the same mesh.  times: a dict that receives the seconds of
    'prune'."""
    m, _ = geometry.getMesh(params, material=None, build_bvh=False,
                            whole=True)
    dev = m.v_pos.device
    v = m.v_pos.cpu().numpy()
    f = m.t_pos_idx.cpu().numpy()
    vt = m.v_tex.cpu().numpy()
    ft = m.t_tex_idx.cpu().numpy()
    keep = m.tri_mask.cpu().numpy() > 0
    f, ft = f[keep], ft[keep]
    frac = float(FLAGS.get('prune_components', 0.0))
    t0 = time.perf_counter()
    f, ft, n_pruned = prune_small_components(f, ft, frac)
    if times is not None:
        times['prune'] = time.perf_counter() - t0
    if n_pruned:
        print('prune_small_components: dropped %d floater triangles '
              '(< %.2f%% of %d faces per component)'
              % (n_pruned, 100 * frac, len(f) + n_pruned))
    used = np.unique(f)
    remap = np.full(v.shape[0], -1, np.int64)
    remap[used] = np.arange(used.shape[0])
    v, f = v[used], remap[f]
    used_t = np.unique(ft)
    remap_t = np.full(vt.shape[0], -1, np.int64)
    remap_t[used_t] = np.arange(used_t.shape[0])
    vt, ft = vt[used_t], remap_t[ft]

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a.astype(dtype)),
                               device=dev)
    return mesh_mod.Mesh(v_pos=t(v, np.float32), t_pos_idx=t(f, np.int32),
                         v_tex=t(vt, np.float32),
                         t_tex_idx=t(ft, np.int32))


def uv_unwrap(v_pos, t_pos_idx):
    """The bake's UV atlas (uv_unwrap.uv_unwrap, the chart-grown
    unwrapper): (v_tex [Vn, 2], t_tex_idx [T, 3] int32) on v_pos's
    device."""
    uvs, tidx = _uv_unwrap_np(v_pos.detach().cpu().numpy(),
                              t_pos_idx.cpu().numpy())
    return (torch.as_tensor(uvs, device=v_pos.device),
            torch.as_tensor(tidx, device=v_pos.device))


def bake_alpha(shape, device):
    """The alpha channel that transparency appends to the baked kd:
    uniform in [0, 1) of shape, drawn from a torch.Generator seeded 0 on
    device (the JAX package draws jax.random.uniform(PRNGKey(0)), a stream
    the port cannot draw; a test feeds JAX's array through this function
    instead)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return torch.rand(shape, generator=gen, device=device)


@torch.no_grad()
def bake_textures(geometry, params, mat_params, mat_static, FLAGS,
                  times=None):
    """The pass boundary: extract_static_mesh, uv_unwrap, then the neural
    material rendered in UV space at FLAGS['texture_res'] (render_uv) with
    its seams dilated over 7x7.  Returns (the base mesh, {'kd', 'ks',
    'normal'} [1, H, W, 3] textures, the normal map flat); with
    FLAGS['transparency'] kd is [1, H, W, 4], its alpha bake_alpha's.
    times: a dict that receives the seconds of 'extract' (prune apart),
    'prune', 'unwrap' and 'bake', and the texels the mesh covers,
    'covered'."""
    times = {} if times is None else times
    dev = mat_params['table'].device

    def lap(name, t0):
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        times[name] = time.perf_counter() - t0
        return time.perf_counter()
    t0 = time.perf_counter()
    base = extract_static_mesh(geometry, params, FLAGS, times)
    t0 = lap('extract', t0)
    times['extract'] -= times['prune']
    v_tex, t_tex_idx = uv_unwrap(base.v_pos, base.t_pos_idx)
    base = dataclasses.replace(base, v_tex=v_tex, t_tex_idx=t_tex_idx)
    t0 = lap('unwrap', t0)
    mat = make_material(mat_params, mat_static)
    mask, kd, ks = render_mod.render_uv(base, FLAGS['texture_res'],
                                        mat['kd_ks'])

    def dilate_tex(x):
        avg = (torch.sum(x * mask, dim=(0, 1, 2))
               / torch.clamp(torch.sum(mask, dim=(0, 1, 2)), min=1e-6))
        return vecmath.dilate(x, avg[None, None, None, :], mask, 7)
    kd, ks = dilate_tex(kd), dilate_tex(ks)
    if FLAGS['transparency']:
        kd = torch.cat((kd, bake_alpha(kd[..., 0:1].shape, dev)), dim=-1)
    normal = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(
        kd[..., 0:3].shape).contiguous()
    times['covered'] = int(mask.sum())
    lap('bake', t0)
    return base, {'kd': kd, 'ks': ks, 'normal': normal}


# ---------------------------------------------------------------------------
# Validation (reference train.py:205-307)
# ---------------------------------------------------------------------------

@torch.no_grad()
def render_eval(geometry, geo_params, mat_params, mat_static, light_base,
                target, FLAGS, n_samples=32, uniforms=None, bsdf=None):
    """The reference's validation render: n_samples x n_samples strata in
    one call (the JAX package's split into K renders of 4x4 strata is a TPU
    watchdog tactic), spp FLAGS['spp'], no MSAA, no denoiser, shadow scale
    1, MC seed 1000.  uniforms: optional per-layer lists for env_shade.
    bsdf overrides the material's: a G-buffer one ('kd', 'ks', 'normal',
    'tangent') renders one pass with no MC estimate.  Returns the render
    buffers."""
    res = tuple(target.get('resolution', FLAGS['train_res']))
    bsdf = mat_static['bsdf'] if bsdf is None else bsdf
    F = dict(FLAGS, n_samples=n_samples)
    spp = FLAGS['spp']
    dev = light_base.device
    n2 = n_samples * n_samples
    perms = (None if n2 & (n2 - 1) == 0
             else envshade.make_perms(n_samples, device=dev))
    material = make_material(mat_params, mat_static)
    opt_mesh, bvh = geometry.getMesh(geo_params, material)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    v_pos_clip, layers = render_mod.render_gbuffer(
        F, opt_mesh, target['mvp'], target['campos'], res, spp,
        FLAGS['layers'], False, bsdf, gen)
    tables = light_mod.update_pdf(light_base)
    lgt = {'base': light_base, 'pdf': tables.pdf, 'rows': tables.rows,
           'cols': tables.cols}
    mc = render_mod.render_mc(F, layers, lgt, bvh, bsdf, 1.0, 1000, perms,
                              uniforms)
    return render_mod.render_finish(F, opt_mesh, v_pos_clip, layers, mc, res,
                                    spp, False, target['background'], bsdf,
                                    None)


@torch.no_grad()
def validate_itr(target, ref_mesh, geometry, geo_params, mat_params,
                 mat_static, light_base, FLAGS, n_samples=32):
    """One validation view: (the [H, W', 3] image of the render beside the
    target and the display layers of FLAGS['display'], the dict of sRGB
    images: 'ref', 'opt', and 'light_image' and each G-buffer bsdf's
    display layer)."""
    buffers = render_eval(geometry, geo_params, mat_params, mat_static,
                          light_base, target, FLAGS, n_samples)
    result_dict = {
        'ref': vecmath.rgb_to_srgb(target['img'][0, ..., 0:3]),
        'opt': vecmath.rgb_to_srgb(buffers['shaded'][0, ..., 0:3]),
    }
    images = [result_dict['opt'], result_dict['ref']]
    for layer in FLAGS.get('display') or []:
        if 'latlong' in layer and layer['latlong']:
            img = light_mod.generate_image(light_base, FLAGS['display_res'])
            img = vecmath.rgb_to_srgb(img / (1 + img))
            result_dict['light_image'] = img
            images.append(img)
        elif 'bsdf' in layer:
            img = render_eval(geometry, geo_params, mat_params, mat_static,
                              light_base, target, FLAGS, n_samples,
                              bsdf=layer['bsdf'])['shaded'][0, ..., 0:3]
            if layer['bsdf'] == 'kd':
                img = vecmath.rgb_to_srgb(img)
            result_dict[layer['bsdf']] = img
            images.append(img)
        elif 'normals' in layer and not FLAGS['no_perturbed_nrm'] \
                and 'perturbed_nrm' in buffers:
            images.append((buffers['perturbed_nrm'][0, ..., 0:3] + 1.0) * 0.5)
        elif 'diffuse_light' in layer and 'diffuse_light' in buffers:
            images.append(vecmath.rgb_to_srgb(
                buffers['diffuse_light'][..., 0:3])[0])
        elif 'specular_light' in layer and 'specular_light' in buffers:
            images.append(vecmath.rgb_to_srgb(
                buffers['specular_light'][..., 0:3])[0])
    return torch.cat(images, dim=1), result_dict


@torch.no_grad()
def validate(geometry, geo_params, mat_params, mat_static, light_base,
             dataset_validate, out_dir, FLAGS, max_frames=None):
    """Render every view of dataset_validate (at most max_frames) at its
    native resolution; write metrics.txt (per-view MSE and PSNR of the
    clipped sRGB images, then their averages) and val_%06d_{ref,opt}.png
    into out_dir.  Returns the average PSNR."""
    os.makedirs(out_dir, exist_ok=True)
    mse_values, psnr_values = [], []
    n = len(dataset_validate) if max_frames is None \
        else min(max_frames, len(dataset_validate))
    gen = torch.Generator(device=light_base.device)
    gen.manual_seed(7)
    with open(os.path.join(out_dir, 'metrics.txt'), 'w') as fout:
        fout.write('ID, MSE, PSNR\n')
        print("Running validation")
        for it in range(n):
            batch = dataset_validate.collate([dataset_validate[it]])
            native_res = tuple(batch['img'].shape[1:3])
            target = prepare_batch(batch, native_res, FLAGS['background'],
                                   gen, FLAGS)
            result_image, rd = validate_itr(
                target, dataset_validate.getMesh(), geometry, geo_params,
                mat_params, mat_static, light_base, FLAGS)
            opt = np.clip(rd['opt'].cpu().numpy(), 0, 1)
            ref = np.clip(rd['ref'].cpu().numpy(), 0, 1)
            mse = float(np.mean((opt - ref) ** 2))
            psnr = float(vecmath.mse_to_psnr(mse))
            mse_values.append(mse)
            psnr_values.append(psnr)
            fout.write("%d, %1.8f, %1.8f \n" % (it, mse, psnr))
            for k in rd:
                texture_mod.save_image(
                    os.path.join(out_dir, 'val_%06d_%s.png' % (it, k)), rd[k])
        avg_mse = float(np.mean(mse_values))
        avg_psnr = float(np.mean(psnr_values))
        fout.write("AVERAGES: %1.4f, %2.3f\n" % (avg_mse, avg_psnr))
        print("MSE,      PSNR")
        print("%1.8f, %2.3f" % (avg_mse, avg_psnr))
    return avg_psnr


# ---------------------------------------------------------------------------
# The optimization loop (reference train.py:313-494)
# ---------------------------------------------------------------------------

def optimize_mesh(geometry, mat_params, mat_static, light_base, dataset_train,
                  dataset_validate, FLAGS, warmup_iter=0, log_interval=10,
                  pass_idx=0, pass_name='', optimize_light=True,
                  optimize_geometry=True):
    """The JAX package's optimize_mesh: FLAGS['iter'] steps over batches of
    dataset_train (over random backgrounds; the backgrounds and the jitter
    from one generator seeded 42 + pass_idx), a probe of one validation
    view every save_interval / display_interval steps, a log line every
    log_interval steps, a checkpoint every checkpoint_interval steps, and
    resume from <out_dir>/checkpoint_<pass_name>.pkl when FLAGS['resume'].
    Returns the trained parameters."""
    device = light_base.device
    F = dict(FLAGS, lock_pos=not optimize_geometry,
             lock_light=not optimize_light)
    params = make_params(geometry, mat_params, light_base)
    optimizers = make_optimizers(params, F, pass_idx, warmup_iter)
    loss_fn = createLoss(F)
    perms = envshade.make_perms(F['n_samples'], device=device)
    it_batches = BatchIterator(dataset_train, F['batch'], shuffle=True)
    generator = torch.Generator(device=device)
    generator.manual_seed(42 + pass_idx)
    state = dict(params=params, optimizers=optimizers, generator=generator,
                 batches=it_batches, dataset=dataset_train)

    ckpt_path = os.path.join(F['out_dir'], 'checkpoint_%s.pkl' % pass_name)
    start_it = 0
    if F['resume'] and os.path.exists(ckpt_path):
        start_it = load_checkpoint(ckpt_path, **state) + 1
        print('Resumed %s from iteration %d' % (ckpt_path, start_it))

    img_loss_vec, reg_loss_vec, iter_dur_vec = [], [], []
    step_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    img_cnt = 0
    v_it = BatchIterator(dataset_validate, 1, shuffle=False)
    ckpt_interval = F['checkpoint_interval']
    for it in range(start_it, F['iter']):
        target = prepare_batch(next(it_batches), F['train_res'], 'random',
                               generator, F)
        target = {k: target[k] for k in ('img', 'mvp', 'campos', 'background')}

        display_now = F['display_interval'] and \
            (it % F['display_interval'] == 0)
        save_image_now = F['save_interval'] and (it % F['save_interval'] == 0)
        if save_image_now or display_now:
            t0 = time.perf_counter()
            vt = prepare_batch(next(v_it), F['train_res'], F['background'],
                               generator, F)
            result_image, rd = validate_itr(
                vt, dataset_validate.getMesh(), geometry, params['geo'],
                params['mat'], mat_static, params['light'], F)
            p_mse = float(np.mean(
                (np.clip(rd['opt'].cpu().numpy(), 0, 1)
                 - np.clip(rd['ref'].cpu().numpy(), 0, 1)) ** 2))
            print('[probe] iter=%d val-view PSNR %.2f dB'
                  % (it, float(vecmath.mse_to_psnr(p_mse))), flush=True)
            if display_now:    # no window: the JAX fallback without glfw
                texture_mod.save_image(
                    os.path.join(F['out_dir'], 'display.png'), result_image)
            if save_image_now:
                texture_mod.save_image(os.path.join(
                    F['out_dir'], 'img_%s_%06d.png' % (pass_name, img_cnt)),
                    result_image)
                img_cnt += 1
            print('[probe] iter=%d took %.3f s'
                  % (it, time.perf_counter() - t0), flush=True)

        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        img_loss, reg_loss = train_step(geometry, params, optimizers,
                                        mat_static, target, it, F, loss_fn,
                                        perms, generator)
        img_loss_f, reg_loss_f = float(img_loss), float(reg_loss)
        iter_dur_vec.append(time.perf_counter() - t0)
        for k, v in kernels.LAUNCHES.items():
            step_launches[k] += v - before[k]
        img_loss_vec.append(img_loss_f)
        reg_loss_vec.append(reg_loss_f)
        if len(iter_dur_vec) == 1 and device.type == 'cuda':
            print('peak device memory after the first step: %.3f GiB'
                  % (torch.cuda.max_memory_allocated(device) / 2 ** 30),
                  flush=True)

        if ckpt_interval and it > 0 and it % ckpt_interval == 0:
            save_checkpoint(ckpt_path, it, **state)

        if log_interval and (it % log_interval == 0):
            rem = (F['iter'] - it) * np.mean(iter_dur_vec[-log_interval:])
            print("iter=%5d, img_loss=%.6f, reg_loss=%.6f, time=%.1f ms, "
                  "rem=%s" % (it, np.mean(img_loss_vec[-log_interval:]),
                              np.mean(reg_loss_vec[-log_interval:]),
                              np.mean(iter_dur_vec[-log_interval:]) * 1000,
                              vecmath.time_to_text(rem)), flush=True)
            # the fixed buffers of marching tets drop triangles past
            # max_tris: say so at each log line
            if hasattr(geometry, 'tri_count'):
                n_tris, cap = geometry.tri_count(params['geo'])
                if n_tris > cap:
                    print('WARNING: marching tets OVERFLOW: %d surface '
                          'triangles > %d slots — geometry is being '
                          'truncated; raise dmtet max_tris' % (n_tris, cap),
                          flush=True)

    n = len(iter_dur_vec)
    if n:
        print('%s: %d steps from iteration %d, median %.3f ms per step of '
              '%d micro-steps at %d layers; kernel launches per step %s'
              % (pass_name, n, start_it,
                 statistics.median(iter_dur_vec) * 1000,
                 config.micro_slices(F), F['layers'],
                 json.dumps({k: v / n for k, v in step_launches.items()})),
              flush=True)
    return params


# ---------------------------------------------------------------------------
# Checkpointing
# ---------------------------------------------------------------------------

def save_checkpoint(path, it, params, optimizers, generator, batches,
                    dataset):
    """Write the training state after iteration it to path atomically (a
    .tmp file, fsync, rename): the parameters, each group's Adam and
    schedule state, the generator's state, the batch iterator's state and
    the training dataset's (its camera RNG and frame count)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    state = {
        'iteration': int(it),
        'params': _map(lambda v: v.detach().cpu(), params),
        'optimizers': {k: {'adam': opt.state_dict(),
                           'schedule': sched.state_dict()}
                       for k, (opt, sched) in optimizers.items()},
        'generator': generator.get_state(),
        'batches': batches.state_dict(),
        'dataset': dataset.state_dict(),
    }
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@torch.no_grad()
def load_checkpoint(path, params, optimizers, generator, batches, dataset):
    """Restore save_checkpoint's state into the live objects: parameters
    copied into the existing leaf tensors (the optimizers keep their
    references), then the optimizers', generator's, iterator's and
    dataset's states.  Returns the saved iteration.  Raises, naming path,
    when the file cannot be read."""
    try:
        state = torch.load(path, map_location='cpu', weights_only=True)
    except (OSError, EOFError, RuntimeError, pickle.UnpicklingError) as e:
        raise RuntimeError('checkpoint %s is unreadable: %s' % (path, e)) \
            from e
    for p, v in zip(_group(params), _group(state['params']), strict=True):
        p.copy_(v)
    for k, (opt, sched) in optimizers.items():
        opt.load_state_dict(state['optimizers'][k]['adam'])
        sched.load_state_dict(state['optimizers'][k]['schedule'])
    generator.set_state(state['generator'])
    batches.load_state_dict(state['batches'])
    dataset.load_state_dict(state['dataset'])
    return state['iteration']


# ---------------------------------------------------------------------------
# The program (reference train.py:497-700)
# ---------------------------------------------------------------------------

def _timed_validate(geometry, params, mat_static, dataset_validate, FLAGS,
                    name, max_frames):
    t0 = time.perf_counter()
    validate(geometry, params['geo'], params['mat'], mat_static,
             params['light'], dataset_validate,
             os.path.join(FLAGS['out_dir'], name), FLAGS,
             max_frames=max_frames)
    print('%s: %.3f s' % ('validation' if name == 'validate' else name,
                          time.perf_counter() - t0), flush=True)


def dmtet_pass(FLAGS, light_base, dataset_train, dataset_validate, device):
    """Pass 1 and the pass boundary: DMTetGeometry (dmtet_grid,
    mesh_scale, max_tris) with the neural material trained by
    optimize_mesh (light trained when learn_lighting), validated on 8
    views into dmtet_validate/ when FLAGS['validate'], then baked
    (bake_textures) and written with its probe into dmtet_mesh/.  Returns
    (the base mesh with its trainable textures' material, mat_params,
    mat_static, the trained light)."""
    geometry = DMTetGeometry(FLAGS['dmtet_grid'], FLAGS['mesh_scale'], FLAGS,
                             max_tris=FLAGS['max_tris'], device=device)
    mat_params, mat_static = initial_guess_material(geometry, True, FLAGS,
                                                    device=device)
    mat_static['no_perturbed_nrm'] = True
    params = optimize_mesh(geometry, mat_params, mat_static, light_base,
                           dataset_train, dataset_validate, FLAGS,
                           pass_idx=0, pass_name='dmtet_pass1',
                           optimize_light=FLAGS['learn_lighting'])
    n_tris, cap = geometry.tri_count(params['geo'])
    print('dmtet_pass1: %d surface triangles of %d slots%s'
          % (n_tris, cap, ', OVERFLOW' if n_tris > cap else ''), flush=True)
    if FLAGS['validate']:
        _timed_validate(geometry, params, mat_static, dataset_validate,
                        FLAGS, 'dmtet_validate', 8)

    times = {}
    base_mesh, baked = bake_textures(geometry, params['geo'], params['mat'],
                                     mat_static, FLAGS, times)
    T = base_mesh.t_pos_idx.shape[0]
    print('pass boundary: %d triangles, %d vertices; extract %.3f s, '
          'prune %.3f s, unwrap %.3f s, bake %.3f s; %d of %d texels '
          'covered; pass 2 BVH leaf size %d'
          % (T, base_mesh.v_pos.shape[0], times['extract'], times['prune'],
             times['unwrap'], times['bake'], times['covered'],
             baked['kd'].shape[1] * baked['kd'].shape[2],
             bvh_mod.leaf_size_for(T)), flush=True)
    light_base = params['light'].detach()
    mat_params, mat_static = initial_guess_material(
        None, False, FLAGS, device=device,
        init_mat={k: texture_mod.Texture2D(data=v) for k, v in baked.items()})
    mat_static['no_perturbed_nrm'] = False
    base_mesh.material = make_material(mat_params, mat_static)
    folder = os.path.join(FLAGS['out_dir'], 'dmtet_mesh')
    os.makedirs(folder, exist_ok=True)
    obj_mod.write_obj(folder + '/', base_mesh)
    if FLAGS['learn_lighting']:
        light_mod.save_env_map(os.path.join(folder, 'probe.hdr'), light_base)
    return base_mesh, mat_params, mat_static, light_base


def make_datasets(FLAGS, device):
    """(training, validation) datasets of FLAGS['ref_mesh'], as the JAX
    main() picks them: an .obj rendered by DatasetMesh; a folder with
    poses_bounds.npy (DatasetLLFF) or transforms_train.json (DatasetNERF,
    validated on transforms_test.json), whose training set is
    (iter + 1) * batch examples long.  Anything else raises
    AssertionError."""
    path = config.resolve_path(FLAGS, FLAGS['ref_mesh'])
    if os.path.splitext(path)[1] == '.obj':
        ref_mesh = mesh_mod.load_mesh(
            path, config.resolve_path(FLAGS, FLAGS['mtl_override']),
            device=device)
        return (DatasetMesh(ref_mesh, RADIUS, FLAGS, validate=False),
                DatasetMesh(ref_mesh, RADIUS, FLAGS, validate=True, seed=1))
    if not os.path.isdir(path):
        raise AssertionError('Invalid dataset format %s' % path)
    examples = (FLAGS['iter'] + 1) * FLAGS['batch']
    if os.path.isfile(os.path.join(path, 'poses_bounds.npy')):
        return (DatasetLLFF(path, FLAGS, examples=examples, device=device),
                DatasetLLFF(path, FLAGS, device=device))
    if os.path.isfile(os.path.join(path, 'transforms_train.json')):
        return (DatasetNERF(os.path.join(path, 'transforms_train.json'),
                            FLAGS, examples=examples, device=device),
                DatasetNERF(os.path.join(path, 'transforms_test.json'),
                            FLAGS, device=device))
    raise AssertionError('Invalid dataset format')


def main(argv=None, device=None):
    """Parse the flags (config.parse_flags), build the datasets of
    FLAGS['ref_mesh'] (make_datasets: a mesh rendered by DatasetMesh, or a
    NeRF or LLFF folder of images) and the light (trainable, or
    FLAGS['envlight']).  Without base_mesh: pass 1 and the
    pass boundary (dmtet_pass), then pass 2 on the baked mesh (warm-up 100
    steps; with FLAGS['transparency'], pass 2, its validation and the
    export at 8 depth-peeled layers, the baked kd with an alpha); with
    it: pass 2 on the base mesh and its material.  Pass 2
    trains the material, the light unless lock_light and the vertices
    unless lock_pos (optimize_mesh), validates 16 views when
    FLAGS['validate'], and exports mesh.obj, mesh.mtl, its textures and
    probe.hdr into <out_dir>/mesh/.  device: None means the CUDA card.
    Returns the trained parameters."""
    FLAGS = config.parse_flags(argv)
    device = resolve(device)
    print("Config / Flags:")
    print("---------")
    for key in sorted(FLAGS):
        print(key, FLAGS[key])
    print("---------")
    os.makedirs(FLAGS['out_dir'], exist_ok=True)

    dataset_train, dataset_validate = make_datasets(FLAGS, device)

    if FLAGS['learn_lighting']:
        light_base = light_mod.create_trainable_env_rnd(
            FLAGS['probe_res'], scale=0.0, bias=0.5, device=device)
    else:
        light_base = load_env_or_procedural(
            config.resolve_path(FLAGS, FLAGS['envlight']),
            FLAGS['env_scale'], device=device)

    if FLAGS['base_mesh'] is None:
        base_mesh, mat_params, mat_static, light_base = dmtet_pass(
            FLAGS, light_base, dataset_train, dataset_validate, device)
        pass_idx, warmup_iter = 1, 100
        if FLAGS['transparency']:     # pass 2 peels 8 layers
            FLAGS['layers'] = 8
    else:
        base_mesh = mesh_mod.load_mesh(
            config.resolve_path(FLAGS, FLAGS['base_mesh']), device=device)
        mat_params, mat_static = initial_guess_material(
            None, False, FLAGS, init_mat=base_mesh.material, device=device)
        pass_idx, warmup_iter = 0, 0
    geometry = DLMesh(base_mesh, FLAGS)
    params = optimize_mesh(geometry, mat_params, mat_static, light_base,
                           dataset_train, dataset_validate, FLAGS,
                           pass_idx=pass_idx, pass_name='mesh_pass',
                           warmup_iter=warmup_iter,
                           optimize_light=not FLAGS['lock_light'],
                           optimize_geometry=not FLAGS['lock_pos'])

    if FLAGS['validate']:
        _timed_validate(geometry, params, mat_static, dataset_validate,
                        FLAGS, 'validate', 16)

    t0 = time.perf_counter()
    with torch.no_grad():
        final_mesh, _ = geometry.getMesh(
            params['geo'], make_material(params['mat'], mat_static),
            build_bvh=False)
        os.makedirs(os.path.join(FLAGS['out_dir'], 'mesh'), exist_ok=True)
        obj_mod.write_obj(os.path.join(FLAGS['out_dir'], 'mesh/'), final_mesh)
        light_mod.save_env_map(
            os.path.join(FLAGS['out_dir'], 'mesh/probe.hdr'), params['light'])
    print('export: %.3f s' % (time.perf_counter() - t0), flush=True)
    if device.type == 'cuda':
        print('peak device memory: %.3f GiB'
              % (torch.cuda.max_memory_allocated(device) / 2 ** 30))
    print('kernel launches: %s' % json.dumps(kernels.LAUNCHES), flush=True)
    return params


if __name__ == '__main__':
    main()
