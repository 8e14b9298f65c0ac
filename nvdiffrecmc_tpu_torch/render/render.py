"""Render pipeline, forward: rasterize -> G-buffer -> Monte-Carlo shade ->
denoise -> composite (counterpart of nvdiffrecmc_tpu/render/render.py).

`lgt` is a dict with 'base' [Hl,Wl,3] and the sampling tables 'pdf'
[Hl,Wl], 'rows' [Hl], 'cols' [Hl,Wl] (light.update_pdf).  Randomness comes
from a torch.Generator (`generator`, on the mesh's device) for the jitter
taps, or from explicit `offsets`, and from `rnd_seed` (or explicit
`uniforms`) for the MC shading.  Differentiable in the mesh's vertices,
its material's textures and the light's base."""

import torch

from ..ops import envshade
from ..ops import mesh_ops
from ..ops import rasterizer as ras
from ..ops import xfm
from ..ops.antialias import antialias
from ..ops.normal import prepare_shading_normal
from ..ops.texture import bilinear_sample
from ..ops.vecmath import (abs_pos0, avg_pool_nhwc, pixel_grid,
                           safe_normalize, scale_img_nhwc)
from ..ops import texture as tex_ops


def shade_pre(FLAGS, rast, gb_depth, gb_pos, gb_geometric_normal, gb_normal,
              gb_tangent, gb_texc, gb_texc_deriv, view_pos, material, bsdf,
              generator, offset=None):
    """Seed-independent half of the pixel shader: texture taps, jitter
    smoothness terms, shading normal.  offset: the [B,H,W,2] jitter of the
    smoothness taps, or None to draw it from `generator`.  Returns the
    `pre` dict."""
    B, H, W = gb_depth.shape[:3]
    dev = gb_pos.device
    if offset is None:
        offset = torch.randn((B, H, W, 2), generator=generator,
                             device=dev) * 0.005
    jitter = pixel_grid(W, H, device=dev)[None] + offset
    mask = (rast[..., -1:] > 0).float()

    def _jitter_taps(buffers):
        taps = bilinear_sample(torch.cat(buffers, dim=-1), jitter,
                               boundary_mode='clamp')
        outs, off = [], 0
        for b in buffers:
            outs.append(taps[..., off:off + b.shape[-1]])
            off += b.shape[-1]
        return outs

    if 'kd_ks' in material:
        raise NotImplementedError('neural (kd_ks) materials are not ported')
    perturbed_nrm = None
    tex_keys = ['kd', 'ks'] + (['normal'] if 'normal' in material else [])
    mips_per = [material[k].buildMips() for k in tex_keys]
    shapes = {tuple(tuple(m.shape[1:3]) for m in mips) for mips in mips_per}
    if len(shapes) == 1:
        outs = tex_ops.texture_sample_multi(mips_per, gb_texc, gb_texc_deriv)
        kd = outs[0]
        ks = outs[1][..., 0:3]
        if 'normal' in material:
            perturbed_nrm = outs[2]
    else:
        kd = material['kd'].sample(gb_texc, gb_texc_deriv)
        ks = material['ks'].sample(gb_texc, gb_texc_deriv)[..., 0:3]
        if 'normal' in material:
            perturbed_nrm = material['normal'].sample(gb_texc, gb_texc_deriv)
    if material.get('no_perturbed_nrm', False):
        perturbed_nrm = None

    tap_bufs = [mask, gb_normal, kd, ks]
    if perturbed_nrm is not None:
        tap_bufs.append(perturbed_nrm)
    taps = iter(_jitter_taps(tap_bufs))
    mask_tap = next(taps)
    grad_weight = mask * mask_tap
    nrm_jitter = next(taps)
    kd_jitter = next(taps)
    ks_jitter = next(taps)
    ks_sel = torch.tensor([0., 1., 1.], device=dev)
    kd_grad = abs_pos0(kd_jitter[..., 0:3] - kd[..., 0:3]) * grad_weight
    ks_grad = abs_pos0(ks_jitter - ks) * ks_sel * grad_weight

    alpha = kd[..., 3:4] if kd.shape[-1] == 4 else torch.ones_like(kd[..., 0:1])
    kd = kd[..., 0:3]
    nrm_grad = abs_pos0(nrm_jitter - gb_normal) * grad_weight

    perturbed_nrm_grad = None
    if perturbed_nrm is not None:
        pn_jitter = next(taps)
        perturbed_nrm_grad = 1.0 - safe_normalize(
            safe_normalize(pn_jitter) + safe_normalize(perturbed_nrm))[..., 2:3]
        perturbed_nrm_grad = perturbed_nrm_grad.repeat(1, 1, 1, 3) * grad_weight

    gb_normal_shaded = prepare_shading_normal(
        gb_pos, view_pos, perturbed_nrm, gb_normal, gb_tangent,
        gb_geometric_normal, two_sided_shading=True, opengl=True)

    return {
        'rast_id': rast[..., -1],
        'gb_depth': gb_depth,
        'gb_pos': gb_pos,
        'gb_geometric_normal': gb_geometric_normal,
        'gb_normal': gb_normal,
        'gb_tangent': gb_tangent,
        'gb_normal_shaded': gb_normal_shaded,
        'view_pos': view_pos,
        'kd': kd, 'ks': ks, 'alpha': alpha,
        'kd_grad': kd_grad, 'ks_grad': ks_grad, 'nrm_grad': nrm_grad,
        'perturbed_nrm': perturbed_nrm,
        'perturbed_nrm_grad': perturbed_nrm_grad,
    }


def shade_mc(FLAGS, pre, lgt, bvh, bsdf, shadow_scale, rnd_seed, perms,
             uniforms=None):
    """Seed-dependent MC env shading on a prepared G-buffer.  Returns
    (diffuse_accum, specular_accum), or (None, None) for non-MC modes."""
    if bsdf not in ('pbr', 'diffuse', 'white'):
        return None, None
    if FLAGS.get('decorrelated', False):
        raise NotImplementedError('decorrelated shading is not ported')
    kd, ks = pre['kd'], pre['ks']
    gb_pos = pre['gb_pos']
    gb_normal_shaded = pre['gb_normal_shaded']
    kd_shade = torch.ones_like(kd) if bsdf == 'white' else kd
    ro = gb_pos + gb_normal_shaded * 0.001
    ibsdf = ['pbr', 'diffuse', 'white'].index(bsdf)
    view_pos_b = pre['view_pos'].expand(gb_pos.shape)
    return envshade.env_shade(
        pre['rast_id'], ro, gb_pos, gb_normal_shaded, view_pos_b, kd_shade,
        ks, lgt['base'], lgt['pdf'], lgt['rows'], lgt['cols'], bvh, perms,
        rnd_seed, shadow_scale, BSDF=ibsdf, n_samples_x=FLAGS['n_samples'],
        uniforms=uniforms)


def shade_post(FLAGS, pre, diffuse_accum, specular_accum, bsdf,
               denoiser_sigma):
    """Combine the MC estimate with the G-buffer into the buffer dict,
    each [B,H,W,4] with alpha in the last channel."""
    kd, ks, alpha = pre['kd'], pre['ks'], pre['alpha']
    gb_depth = pre['gb_depth']
    gb_normal_shaded = pre['gb_normal_shaded']
    if bsdf in ('pbr', 'diffuse', 'white'):
        kd_shade = torch.ones_like(kd) if bsdf == 'white' else kd
        if denoiser_sigma is not None:
            if not FLAGS.get('denoiser_demodulate', True):
                raise NotImplementedError(
                    'denoising the modulated color is not ported')
            from ..ops.pallas_denoise import bilateral_denoiser_pair
            diffuse_accum, specular_accum = bilateral_denoiser_pair(
                diffuse_accum, specular_accum, gb_normal_shaded, gb_depth,
                denoiser_sigma)
        if bsdf in ('white', 'diffuse'):
            shaded_col = diffuse_accum * kd_shade
        else:
            kd = kd * (1.0 - ks[..., 2:3])
            shaded_col = diffuse_accum * kd + specular_accum
    elif bsdf == 'normal':
        shaded_col = (gb_normal_shaded + 1.0) * 0.5
    elif bsdf == 'tangent':
        shaded_col = (pre['gb_tangent'] + 1.0) * 0.5
    elif bsdf == 'kd':
        shaded_col = kd
    elif bsdf == 'ks':
        shaded_col = ks
    else:
        raise AssertionError("Invalid BSDF '%s'" % bsdf)

    buffers = {
        'shaded': torch.cat((shaded_col, alpha), dim=-1),
        'z_grad': torch.cat((gb_depth, torch.zeros_like(alpha), alpha), -1),
        'normal': torch.cat((gb_normal_shaded, alpha), -1),
        'geometric_normal': torch.cat((pre['gb_geometric_normal'], alpha), -1),
        'kd': torch.cat((kd, alpha), -1),
        'ks': torch.cat((ks, alpha), -1),
        'kd_grad': torch.cat((pre['kd_grad'], alpha), -1),
        'ks_grad': torch.cat((pre['ks_grad'], alpha), -1),
        'normal_grad': torch.cat((pre['nrm_grad'], alpha), -1),
    }
    if diffuse_accum is not None:
        buffers['diffuse_light'] = torch.cat((diffuse_accum, alpha), -1)
        buffers['specular_light'] = torch.cat((specular_accum, alpha), -1)
    if pre['perturbed_nrm'] is not None:
        buffers['perturbed_nrm'] = torch.cat((pre['perturbed_nrm'], alpha), -1)
        buffers['perturbed_nrm_grad'] = torch.cat(
            (pre['perturbed_nrm_grad'], alpha), -1)
    return buffers


def gbuffer_layer(v_pos_clip, rast, rast_deriv, mesh, resolution, spp, msaa):
    """Interpolate one depth layer's G-buffer.  Returns (rast_out_s,
    gb_depth, gb_pos, gb_geometric_normal, gb_normal, gb_tangent, gb_texc,
    gb_texc_deriv)."""
    if spp > 1 and msaa:
        rast_out_s = scale_img_nhwc(rast, resolution, mag='nearest',
                                    min='nearest')
        rast_out_deriv_s = scale_img_nhwc(rast_deriv, resolution,
                                          mag='nearest', min='nearest') * spp
    else:
        rast_out_s = rast
        rast_out_deriv_s = rast_deriv

    face_normals = mesh_ops.face_normals(mesh.v_pos, mesh.t_pos_idx)
    gb_geometric_normal = ras.interpolate_face(face_normals, rast_out_s)

    clip_pos, clip_pos_deriv = ras.interpolate(
        v_pos_clip.detach(), rast_out_s, mesh.t_pos_idx,
        rast_db=rast_out_deriv_s)
    if mesh.t_nrm_idx is mesh.t_pos_idx and mesh.t_tng_idx is mesh.t_pos_idx:
        attr_cat = torch.cat([mesh.v_pos, mesh.v_nrm, mesh.v_tng], dim=-1)
        out, _ = ras.interpolate(attr_cat, rast_out_s, mesh.t_pos_idx)
        gb_pos, gb_normal, gb_tangent = out[..., 0:3], out[..., 3:6], out[..., 6:9]
    else:
        gb_pos, _ = ras.interpolate(mesh.v_pos, rast_out_s, mesh.t_pos_idx)
        gb_normal, _ = ras.interpolate(mesh.v_nrm, rast_out_s, mesh.t_nrm_idx)
        gb_tangent, _ = ras.interpolate(mesh.v_tng, rast_out_s,
                                        mesh.t_tng_idx)

    gb_texc, gb_texc_deriv = ras.interpolate(
        mesh.v_tex, rast_out_s, mesh.t_tex_idx, rast_db=rast_out_deriv_s)

    # depth and its screen derivative carry no gradient
    clip_pos, clip_pos_deriv = clip_pos.detach(), clip_pos_deriv.detach()
    eps = 1e-5
    dz = torch.abs(clip_pos_deriv[..., 2:3]) + torch.abs(clip_pos_deriv[..., 6:7])
    dw = torch.abs(clip_pos_deriv[..., 3:4]) + torch.abs(clip_pos_deriv[..., 7:8])
    z0 = (torch.clamp(clip_pos[..., 2:3], min=eps)
          / torch.clamp(clip_pos[..., 3:4], min=eps))
    z1 = (torch.clamp(clip_pos[..., 2:3] + dz, min=eps)
          / torch.clamp(clip_pos[..., 3:4] + dw, min=eps))
    gb_depth = torch.cat((z0, torch.abs(z1 - z0)), dim=-1)
    return (rast_out_s, gb_depth, gb_pos, gb_geometric_normal, gb_normal,
            gb_tangent, gb_texc, gb_texc_deriv)


def render_gbuffer(FLAGS, mesh, mtx_in, view_pos, resolution, spp,
                   num_layers, msaa, bsdf, generator, offsets=None):
    """Stage 1: clip transform, depth-peeled rasterization, per-layer
    G-buffer and shade_pre (layer i jitters by offsets[i] when given).
    Returns (v_pos_clip, [(pre, rast), ...])."""
    full_res = [resolution[0] * spp, resolution[1] * spp]
    view_pos = view_pos[:, None, None, :]
    v_pos_clip = xfm.xfm_points(mesh.v_pos, mtx_in)
    layers = []
    prev_rast = None
    for i in range(num_layers):
        rast, rast_db = ras.rasterize(v_pos_clip, mesh.t_pos_idx, full_res,
                                      prev_rast=prev_rast)
        prev_rast = rast
        (rast_out_s, gb_depth, gb_pos, gb_geometric_normal, gb_normal,
         gb_tangent, gb_texc, gb_texc_deriv) = gbuffer_layer(
            v_pos_clip, rast, rast_db, mesh, resolution, spp, msaa)
        pre = shade_pre(FLAGS, rast_out_s, gb_depth, gb_pos,
                        gb_geometric_normal, gb_normal, gb_tangent, gb_texc,
                        gb_texc_deriv, view_pos, mesh.material, bsdf,
                        generator, None if offsets is None else offsets[i])
        layers.append((pre, rast))
    return v_pos_clip, layers


def render_mc(FLAGS, layers, lgt, bvh, bsdf, shadow_scale, rnd_seed, perms,
              uniforms=None):
    """Stage 2: MC env shading per depth layer (layer i uses rnd_seed + i,
    or uniforms[i] when given)."""
    return [shade_mc(FLAGS, pre, lgt, bvh, bsdf, shadow_scale, rnd_seed + i,
                     perms, None if uniforms is None else uniforms[i])
            for i, (pre, _) in enumerate(layers)]


def render_finish(FLAGS, mesh, v_pos_clip, layers, mc, resolution, spp,
                  msaa, background, bsdf, denoiser_sigma):
    """Stage 3: shade_post per layer, MSAA upscale, front-to-back
    composite with per-layer antialiasing, spp pooling."""
    full_res = [resolution[0] * spp, resolution[1] * spp]
    buf_layers = []
    for (pre, rast), (da, sa) in zip(layers, mc):
        buffers = shade_post(FLAGS, pre, da, sa, bsdf, denoiser_sigma)
        if spp > 1 and msaa:
            buffers = {k: scale_img_nhwc(v, full_res, mag='nearest',
                                         min='nearest')
                       for k, v in buffers.items()}
        buf_layers.append((buffers, rast))
    return _composite(FLAGS, mesh, v_pos_clip, buf_layers, full_res, spp,
                      background)


def render_mesh(FLAGS, mesh, mtx_in, view_pos, lgt, resolution, bvh, perms,
                generator, spp=1, num_layers=1, msaa=False, background=None,
                bsdf=None, denoiser_sigma=None, shadow_scale=1.0, rnd_seed=0,
                uniforms=None, offsets=None):
    """Depth-peeled render.  mtx_in [B,4,4]; view_pos [B,3]; uniforms and
    offsets: optional per-layer lists (see render_mc, render_gbuffer).
    Returns a dict of [B,H*spp,W*spp,4] buffers composited front to back."""
    bsdf = mesh.material['bsdf'] if bsdf is None else bsdf
    v_pos_clip, layers = render_gbuffer(FLAGS, mesh, mtx_in, view_pos,
                                        resolution, spp, num_layers, msaa,
                                        bsdf, generator, offsets)
    mc = render_mc(FLAGS, layers, lgt, bvh, bsdf, shadow_scale, rnd_seed,
                   perms, uniforms)
    return render_finish(FLAGS, mesh, v_pos_clip, layers, mc, resolution,
                         spp, msaa, background, bsdf, denoiser_sigma)


def _composite(FLAGS, mesh, v_pos_clip, layers, full_res, spp, background):
    if background is not None:
        if spp > 1:
            background = scale_img_nhwc(background, full_res, mag='nearest',
                                        min='nearest')
        background = torch.cat(
            (background, torch.zeros_like(background[..., 0:1])), dim=-1)
    else:
        B = layers[0][1].shape[0]
        background = torch.zeros((B, full_res[0], full_res[1], 4),
                                 device=v_pos_clip.device)

    # composite every buffer, then antialias all of them with one
    # channel-stacked call per layer (the blend weights are shared)
    key_list = list(layers[0][0].keys())
    chans = {k: layers[0][0][k].shape[-1] for k in key_list}
    accums = {k: (background if k == 'shaded'
                  else torch.zeros_like(layers[0][0][k])) for k in key_list}
    for buffers, rast in reversed(layers):
        for k in key_list:
            alpha = (rast[..., -1:] > 0).float() * buffers[k][..., -1:]
            src = torch.cat((buffers[k][..., :-1],
                             torch.ones_like(buffers[k][..., -1:])), -1)
            accums[k] = accums[k] * (1.0 - alpha) + src * alpha
        stacked = torch.cat([accums[k] for k in key_list], dim=-1)
        stacked = antialias(stacked, rast, v_pos_clip, mesh.t_pos_idx)
        off = 0
        for k in key_list:
            accums[k] = stacked[..., off:off + chans[k]]
            off += chans[k]
    return {k: (avg_pool_nhwc(accums[k], spp) if spp > 1 else accums[k])
            for k in key_list}
