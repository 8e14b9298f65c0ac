"""The port's export and its helpers against the JAX package's: write_obj
+ save_mtl (the same mesh.obj and mesh.mtl bytes, the same PNG pixels),
the Radiance .hdr writer and reader (each reads the other's file within
one RGBE quantum of the pixel's largest channel, as
tests/test_io_datasets.py bounds JAX's own round trip), generate_image
(within 1e-6), save_env_map, time_to_text, initial_guess_material from a
base mesh's material (within 1e-6), and one train.main run on the CPU at a
small size with one probe and two display layers, whose mesh/ reads back
through the port's loaders."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import train as j_train
from nvdiffrecmc_tpu.config import apply_schedule_scaling
from nvdiffrecmc_tpu.ops import vecmath as j_vecmath
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import obj as j_obj
from nvdiffrecmc_tpu.render import texture as j_texture
from nvdiffrecmc_tpu_torch import config, convert, train
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vecmath
from nvdiffrecmc_tpu_torch.render import light as t_light
from nvdiffrecmc_tpu_torch.render import obj as t_obj
from nvdiffrecmc_tpu_torch.render import texture as t_texture
from test_torch_program import program_argv


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _material(rng, res=(12, 20)):
    """kd, ks and a normal map of seeded values (JAX Texture2Ds)."""
    shape = (1,) + res + (3,)
    nrm = rng.uniform(-1.0, 1.0, shape)
    nrm[..., 2] = np.abs(nrm[..., 2]) + 0.1
    return {'bsdf': 'pbr',
            'kd': j_texture.Texture2D(data=jnp.asarray(
                rng.uniform(0.0, 1.0, shape).astype(np.float32))),
            'ks': j_texture.Texture2D(data=jnp.asarray(
                rng.uniform(0.0, 1.0, shape).astype(np.float32))),
            'normal': j_texture.Texture2D(data=jnp.asarray(
                nrm.astype(np.float32)))}


@pytest.mark.parametrize('masked', [False, True])
def test_write_obj_matches_jax(tmp_path, masked):
    """The octasphere (normals, texcoords) under a seeded material, and
    with a tri_mask that drops every third triangle: mesh.obj and mesh.mtl
    byte for byte, texture_{kd,ks,n}.png equal after decoding; the port's
    OBJ reads back with the kept triangles and the same vertices."""
    m = ge._make_scene(res=16, n_samples=2)[0]
    T = m.t_pos_idx.shape[0]
    mask = (np.arange(T) % 3 != 0).astype(np.float32)
    m.material = _material(np.random.RandomState(2))
    if masked:
        m.tri_mask = jnp.asarray(mask)
    tm = convert.mesh(m, device='cpu')
    tm.material = {'bsdf': 'pbr'}
    for k in ('kd', 'ks', 'normal'):
        tm.material[k] = convert.texture(m.material[k], device='cpu')
    if masked:
        tm.tri_mask = torch.as_tensor(mask)
    jd, td = str(tmp_path / 'jax'), str(tmp_path / 'port')
    os.makedirs(jd)
    os.makedirs(td)
    j_obj.write_obj(jd, m)
    t_obj.write_obj(td, tm)
    for fn in ('mesh.obj', 'mesh.mtl'):
        with open(os.path.join(jd, fn), 'rb') as a, \
                open(os.path.join(td, fn), 'rb') as b:
            assert a.read() == b.read(), fn
    for fn in ('texture_kd.png', 'texture_ks.png', 'texture_n.png'):
        want = j_texture.load_image(os.path.join(jd, fn))
        got = t_texture.load_image(os.path.join(td, fn))
        np.testing.assert_array_equal(got, want, err_msg=fn)
    back = t_obj.load_obj(os.path.join(td, 'mesh.obj'), device='cpu')
    assert back.t_pos_idx.shape[0] == (int(mask.sum()) if masked else T)
    np.testing.assert_array_equal(back.v_pos.numpy(), np.asarray(m.v_pos))
    np.testing.assert_allclose(back.v_tex.numpy(), np.asarray(m.v_tex),
                               atol=1e-6)


def _hdr_images():
    rng = np.random.RandomState(0)
    smooth = (rng.rand(32, 64, 3).astype(np.float32) ** 2) * 100 + 0.01
    runs = np.repeat(smooth[:, ::16], 16, axis=1)    # runs of 16 pixels
    runs[3] = 0.0                                    # a black scanline
    runs[5, :, 0] = 1e-38                            # below the exponent
    narrow = smooth[:, :6]                           # flat scanlines
    return {'smooth': smooth, 'runs': runs, 'narrow': narrow}


@pytest.mark.parametrize('name', ['smooth', 'runs', 'narrow'])
def test_hdr_matches_jax_within_a_quantum(tmp_path, name):
    img = _hdr_images()[name]
    quantum = img.max(axis=-1, keepdims=True) / 128.0
    fn = str(tmp_path / 't.hdr')
    t_light._write_hdr(fn, img)
    back = j_light._read_hdr(fn)
    assert np.all(np.abs(back - img) <= quantum + 1e-5)
    np.testing.assert_array_equal(t_light._read_hdr(fn), back)
    j_light._write_hdr(fn, img)
    back = t_light._read_hdr(fn)
    assert np.all(np.abs(back - img) <= quantum + 1e-5)


def test_generate_image_and_env_map_match_jax(tmp_path):
    """generate_image within 1e-6 of JAX's at a size that is neither the
    probe's nor a multiple of it; save_env_map of both packages read back
    at 512 x 1024 within one quantum of each other."""
    base = np.random.RandomState(5).uniform(
        0.01, 4.0, (16, 32, 3)).astype(np.float32)
    want = np.asarray(j_light.generate_image(jnp.asarray(base), [24, 40]))
    got = t_light.generate_image(torch.as_tensor(base), [24, 40]).numpy()
    assert got.shape == (24, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    jf, tf = str(tmp_path / 'j.hdr'), str(tmp_path / 't.hdr')
    j_light.save_env_map(jf, jnp.asarray(base))
    t_light.save_env_map(tf, torch.as_tensor(base))
    a, b = j_light._read_hdr(jf), t_light._read_hdr(tf)
    assert b.shape == (512, 1024, 3)
    quantum = a.max(axis=-1, keepdims=True) / 64.0
    assert np.all(np.abs(a - b) <= quantum)


def test_time_to_text_matches_jax():
    for x in (0.0, 0.5, 59.99, 60.0, 61.5, 3599.0, 3600.0, 3601.0, 90000.0):
        assert t_vecmath.time_to_text(x) == j_vecmath.time_to_text(x)


def test_initial_guess_material_from_init_mat_matches_jax():
    """Textures of a base mesh's material, constant (1 x 1) and 8 x 8,
    resized to a 16 x 16 texture_res; the flat normal map where the
    material has none."""
    rng = np.random.RandomState(6)
    init = {'kd': rng.uniform(0.0, 1.0, (1, 8, 8, 3)),
            'ks': np.array([[[[0.0, 0.5, 0.0]]]])}
    FLAGS = j_train.parse_flags([])
    FLAGS.update(texture_res=[16, 16])
    apply_schedule_scaling(FLAGS)
    jp, _ = j_train.initial_guess_material(
        None, False, FLAGS, init_mat={k: j_texture.Texture2D(
            data=jnp.asarray(v.astype(np.float32))) for k, v in init.items()})
    tp, static = train.initial_guess_material(
        None, False, config.make_flags(texture_res=[16, 16]),
        init_mat={k: t_texture.Texture2D(data=torch.as_tensor(
            v.astype(np.float32))) for k, v in init.items()}, device='cpu')
    for k in ('kd', 'ks', 'normal'):
        assert tuple(tp[k].shape) == (1, 16, 16, 3), k
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert static['kind'] == 'tex'


def test_main_exports_a_mesh_that_reads_back(tmp_path, capsys):
    """2 iterations with a probe at iteration 0 and the latlong and kd
    display layers: one [16, 4 x 16, 3] probe image and a display.png;
    mesh/ holds the OBJ, MTL, three PNGs and probe.hdr; the OBJ reads back
    with the octasphere's 512 triangles and the trained vertices, the
    probe at 512 x 1024; the exported kd moved off the base mesh's gray."""
    argv = program_argv(str(tmp_path), 'run', '-i', '2', '-si', '2', '-di',
                        '2')
    with open(argv[1]) as f:
        cfg = f.read().replace('[{"latlong": true}]',
                               '[{"latlong": true}, {"bsdf": "kd"}]')
    with open(argv[1], 'w') as f:
        f.write(cfg)
    params = train.main(argv, device='cpu')
    out = capsys.readouterr().out
    assert '[probe] iter=0 val-view PSNR' in out
    assert 'mesh_pass: 2 steps from iteration 0' in out
    run = os.path.join(str(tmp_path), 'run')
    probe = t_texture.load_image(os.path.join(run, 'img_mesh_pass_000000.png'))
    assert probe.shape == (16, 64, 3)
    assert os.path.exists(os.path.join(run, 'display.png'))
    mesh_dir = os.path.join(run, 'mesh')
    assert sorted(os.listdir(mesh_dir)) == [
        'mesh.mtl', 'mesh.obj', 'probe.hdr', 'texture_kd.png',
        'texture_ks.png', 'texture_n.png']
    back = t_obj.load_obj(os.path.join(mesh_dir, 'mesh.obj'), device='cpu')
    assert back.t_pos_idx.shape[0] == 512
    np.testing.assert_allclose(back.v_pos.numpy(),
                               params['geo']['v_pos'].detach().numpy(),
                               rtol=0, atol=1e-5)
    assert t_light._read_hdr(os.path.join(mesh_dir, 'probe.hdr')).shape \
        == (512, 1024, 3)
    kd = t_texture.load_image(os.path.join(mesh_dir, 'texture_kd.png'))
    gray = t_texture.load_image(os.path.join(str(tmp_path), 'base',
                                             'texture_kd.png'))
    assert np.abs(kd - gray).mean() > 1.0 / 255.0
