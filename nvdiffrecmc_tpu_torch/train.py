"""The pass-2 training step and validation of the port (counterpart of the
repository's train.py): losses, batch preparation, the trainable material,
three Adam optimizers with the JAX package's learning-rate schedule, the
gradient conventions, the post-step projections, and the validation render
at the reference protocol.  There is no command line yet.

Parameters are a dict {'geo': {'v_pos'}, 'mat': {'kd', 'ks', 'normal'},
'light'} of leaf tensors; `train_step` renders one view through
`DLMesh.tick`, runs `backward()`, and updates them in place.  `validate`
renders the validation views with `render_eval` and writes their PSNR."""

import os

import numpy as np
import torch

from .device import resolve
from .ops import envshade
from .ops import loss as loss_ops
from .ops import vecmath
from .render import light as light_mod
from .render import render as render_mod
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
    device = resolve(device)

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
    gradient times 64 when the light is optimized, the global-norm clip of
    geometry and material when clip_max_norm > 0, one Adam step per
    optimized group (lock_pos and lock_light each hold a group: its
    parameters, Adam state and schedule stay as they are), the
    projections (the light's applies locked or not, as in JAX)."""
    locked = {'geo': FLAGS['lock_pos'], 'light': FLAGS['lock_light']}
    if FLAGS['learn_lighting'] and not locked['light']:
        params['light'].grad.mul_(64.0)
    if FLAGS['clip_max_norm'] > 0.0:
        grads = [p.grad for p in _group(params['geo']) + _group(params['mat'])
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


def train_step(geometry, params, optimizers, mat_static, target, it, FLAGS,
               loss_fn, perms, generator, **kw):
    """One optimizer step: compute_grads (kw: uniforms, offsets), then
    apply_grads.  Returns (img_loss, reg_loss)."""
    losses = compute_grads(geometry, params, mat_static, target, it, FLAGS,
                           loss_fn, perms, generator, **kw)
    apply_grads(params, optimizers, mat_static, FLAGS)
    return losses


# ---------------------------------------------------------------------------
# Validation (reference train.py:205-307)
# ---------------------------------------------------------------------------

@torch.no_grad()
def render_eval(geometry, geo_params, mat_params, mat_static, light_base,
                target, FLAGS, n_samples=32, uniforms=None):
    """The reference's validation render: n_samples x n_samples strata in
    one call (the JAX package's split into K renders of 4x4 strata is a TPU
    watchdog tactic), spp FLAGS['spp'], no MSAA, no denoiser, shadow scale
    1, MC seed 1000.  uniforms: optional per-layer lists for env_shade.
    Returns the render buffers."""
    res = tuple(target.get('resolution', FLAGS['train_res']))
    bsdf = mat_static['bsdf']
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
    """One validation view: (the [H, 2W, 3] sRGB image of the render beside
    the target, {'ref', 'opt'} sRGB images)."""
    buffers = render_eval(geometry, geo_params, mat_params, mat_static,
                          light_base, target, FLAGS, n_samples)
    result_dict = {
        'ref': vecmath.rgb_to_srgb(target['img'][0, ..., 0:3]),
        'opt': vecmath.rgb_to_srgb(buffers['shaded'][0, ..., 0:3]),
    }
    result_image = torch.cat([result_dict['opt'], result_dict['ref']], dim=1)
    return result_image, result_dict


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
