"""The pass-2 training step of the port (counterpart of the repository's
train.py): losses, batch preparation, the trainable material, three Adam
optimizers with the JAX package's learning-rate schedule, the gradient
conventions and the post-step projections.  There is no command line yet.

Parameters are a dict {'geo': {'v_pos'}, 'mat': {'kd', 'ks', 'normal'},
'light'} of leaf tensors; `train_step` renders one view through
`DLMesh.tick`, runs `backward()`, and updates them in place."""

import numpy as np
import torch

from .ops import loss as loss_ops
from .ops import vecmath
from .render import light as light_mod
from .render import texture as texture_mod

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
    out['img'] = torch.cat((background * (1 - alpha) + img[..., 0:3] * alpha,
                            alpha), dim=-1)
    out['background'] = background
    out['resolution'] = tuple(train_res)
    out['mvp'] = torch.as_tensor(np.asarray(target['mvp']), device=dev)
    out['campos'] = torch.as_tensor(np.asarray(target['campos']), device=dev)
    return out


def initial_guess_material(geometry, mlp, FLAGS, device=None):
    """(mat_params, mat_static): trainable kd, ks and normal textures at
    FLAGS['texture_res'] and their bounds, as the JAX package's guess with
    no initial material: constant kd, ks drawn from numpy's
    RandomState(0), a flat normal map."""
    if mlp:
        raise NotImplementedError('neural (kd_ks) materials are not ported')

    def f32(k):
        return torch.tensor(FLAGS[k], dtype=torch.float32, device=device)
    kd_min, kd_max, ks_min, ks_max = (f32('kd_min'), f32('kd_max'),
                                      f32('ks_min'), f32('ks_max'))
    rng = np.random.RandomState(0)
    res = tuple(FLAGS['texture_res'])
    num_ch = 4 if FLAGS['layers'] > 1 else 3
    kd_data = (torch.ones(res + (num_ch,), device=device)
               * (kd_max - kd_min)[0:num_ch] + kd_min[0:num_ch])[None]
    ks = np.concatenate((
        rng.uniform(0.0, 0.01, size=res + (1,)),
        rng.uniform(float(ks_min[1]), float(ks_max[1]), size=res + (1,)),
        rng.uniform(float(ks_min[2]), float(ks_max[2]), size=res + (1,))),
        axis=2)
    ks_data = torch.as_tensor(ks.astype(np.float32), device=device)[None]
    nrm_data = texture_mod.create_trainable(
        np.array([0, 0, 1], np.float32), res, device=device).data
    params = {'kd': kd_data, 'ks': ks_data, 'normal': nrm_data}
    static = {
        'kind': 'tex',
        'min_max': {'kd': (kd_min, kd_max), 'ks': (ks_min, ks_max),
                    'normal': (f32('nrm_min'), f32('nrm_max'))},
        'bsdf': FLAGS['bsdf'],
        'no_perturbed_nrm': bool(FLAGS['no_perturbed_nrm']),
    }
    return params, static


def make_material(mat_params, mat_static):
    """The material dict the shader reads, over the trainable tensors."""
    mat = {'bsdf': mat_static['bsdf'],
           'no_perturbed_nrm': mat_static['no_perturbed_nrm']}
    for k in ('kd', 'ks', 'normal'):
        if k in mat_params:
            mat[k] = texture_mod.Texture2D(
                data=mat_params[k], min_max=mat_static['min_max'][k])
    return mat


@torch.no_grad()
def clamp_material(mat_params, mat_static):
    """Post-step projections, in place: each texture onto its bounds, the
    normal map back to unit length."""
    for k in ('kd', 'ks', 'normal'):
        if k in mat_params:
            tex = texture_mod.Texture2D(data=mat_params[k],
                                        min_max=mat_static['min_max'][k])
            tex = tex.clamp().normalize() if k == 'normal' else tex.clamp()
            mat_params[k].copy_(tex.data)
    return mat_params


def make_params(geometry, mat_params, light_base):
    """Leaf tensors (requires_grad) for the three parameter groups, copied
    so that an in-place update never reaches the geometry's initial guess."""
    def leaf(x):
        return x.detach().clone().requires_grad_()
    return {'geo': {k: leaf(v) for k, v in geometry.parameters().items()},
            'mat': {k: leaf(v) for k, v in mat_params.items()},
            'light': leaf(light_base)}


def _group(p):
    return [p] if torch.is_tensor(p) else list(p.values())


def lr_schedule(count, lr_decay_rate):
    """The JAX package's pass-2 schedule (no warm-up):
    10^(-count * lr_decay_rate)."""
    return 10.0 ** (-count * lr_decay_rate)


def make_optimizers(params, FLAGS):
    """{'geo', 'mat', 'light'} -> (Adam, LambdaLR): b1 0.9, b2 0.999, eps
    1e-8; base rates as the JAX package derives them from
    FLAGS['learning_rate'], a number or [pos, mat(, light)] (the light's
    is 3x the material's by default); the schedule factor at step count
    0, 1, ... as optax applies it."""
    lr = FLAGS['learning_rate']
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
            opt, lambda c: lr_schedule(c, rate))
        out[name] = (opt, sched)
    return out


def compute_grads(geometry, params, mat_static, target, it, FLAGS, loss_fn,
                  perms, generator, uniforms=None, offsets=None):
    """Render target's view with the current parameters and backpropagate
    img_loss + reg_loss into their .grad.  Returns (img_loss, reg_loss),
    detached."""
    for p in _group(params['geo']) + _group(params['mat']) + [params['light']]:
        p.grad = None
    tables = light_mod.update_pdf(params['light'])
    lgt = {'base': params['light'], 'pdf': tables.pdf, 'rows': tables.rows,
           'cols': tables.cols}
    sigma = 2.0 if FLAGS['denoiser'] == 'bilateral' else None
    target_full = dict(target, resolution=tuple(FLAGS['train_res']),
                       spp=FLAGS['spp'])
    material = make_material(params['mat'], mat_static)
    img_loss, reg_loss = geometry.tick(
        params['geo'], material, lgt, target_full, loss_fn, it, FLAGS, sigma,
        perms, generator, rnd_seed=int(it), uniforms=uniforms,
        offsets=offsets)
    (img_loss + reg_loss).backward()
    return img_loss.detach(), reg_loss.detach()


@torch.no_grad()
def apply_grads(params, optimizers, mat_static, FLAGS):
    """The JAX package's apply_grads on the .grad of params: the light
    gradient times 64, the global-norm clip of geometry and material when
    clip_max_norm > 0, one Adam step per group, the projections."""
    if FLAGS['learn_lighting']:
        params['light'].grad.mul_(64.0)
    if FLAGS['clip_max_norm'] > 0.0:
        grads = [p.grad for p in _group(params['geo']) + _group(params['mat'])
                 if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(FLAGS['clip_max_norm']
                            / torch.clamp(norm, min=1e-12), max=1.0)
        for g in grads:
            g.mul_(scale)
    for opt, sched in optimizers.values():
        opt.step()
        sched.step()
    clamp_material(params['mat'], mat_static)
    params['light'].clamp_(min=0.01)


def train_step(geometry, params, optimizers, mat_static, target, it, FLAGS,
               loss_fn, perms, generator, **kw):
    """One optimizer step: compute_grads (kw: uniforms, offsets), then
    apply_grads.  Returns (img_loss, reg_loss)."""
    losses = compute_grads(geometry, params, mat_static, target, it, FLAGS,
                           loss_fn, perms, generator, **kw)
    apply_grads(params, optimizers, mat_static, FLAGS)
    return losses
