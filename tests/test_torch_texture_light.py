"""Port parity, textures and light: texture_sample_multi and update_pdf
(atol 1e-5), load_env on the repo's probe.hdr and the OBJ geometry of
spot256 (exact), and the port's PNG decoder against imageio (exact)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import texture as j_tex
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu_torch.dataset import dataset_mesh as t_dataset
from nvdiffrecmc_tpu_torch.ops import texture as t_tex
from nvdiffrecmc_tpu_torch.render import light as t_light
from nvdiffrecmc_tpu_torch.render import obj as t_obj
from nvdiffrecmc_tpu_torch.render import texture as t_texture

SPOT = t_dataset.SPOT256_DIR


@pytest.mark.parametrize('boundary', ['wrap', 'clamp'])
def test_texture_sample_multi_matches_jax(boundary):
    rng = np.random.RandomState(0)
    kd = rng.rand(1, 32, 32, 3).astype(np.float32)
    ks = rng.rand(1, 32, 32, 3).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (1, 20, 24, 2)).astype(np.float32)
    # footprints from magnification to far minification (every mip level)
    da = (rng.randn(1, 20, 24, 4) * np.exp(rng.uniform(-8, 1, (1, 20, 24, 1)))
          ).astype(np.float32)
    jm = [j_tex.build_mip_chain(jnp.asarray(x)) for x in (kd, ks)]
    tm = [t_tex.build_mip_chain(torch.as_tensor(x)) for x in (kd, ks)]
    want = j_tex.texture_sample_multi(jm, jnp.asarray(uv), jnp.asarray(da),
                                      boundary_mode=boundary)
    got = t_tex.texture_sample_multi(tm, torch.as_tensor(uv),
                                     torch.as_tensor(da),
                                     boundary_mode=boundary)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    wb = j_tex.bilinear_sample(jnp.asarray(kd), jnp.asarray(uv), boundary)
    gb = t_tex.bilinear_sample(torch.as_tensor(kd), torch.as_tensor(uv),
                               boundary)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), atol=1e-5, rtol=0)


def test_update_pdf_matches_jax():
    rng = np.random.RandomState(1)
    base = (rng.rand(64, 128, 3) ** 4 * 20).astype(np.float32)
    want = j_light.update_pdf(jnp.asarray(base))
    got = t_light.update_pdf(torch.as_tensor(base))
    for k in ('pdf', 'rows', 'cols'):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5,
                                   rtol=0)


def test_load_env_matches_jax_exactly():
    fn = os.path.join(SPOT, 'probe.hdr')
    want = np.asarray(j_light.load_env(fn))
    got = t_light.load_env(fn, device='cpu').numpy()
    assert got.shape == (512, 1024, 3)
    np.testing.assert_array_equal(got, want)


def test_png_decoder_matches_imageio():
    imageio = pytest.importorskip('imageio.v2')
    fn = os.path.join(SPOT, 'texture_kd.png')
    with open(fn, 'rb') as f:
        got = t_texture.decode_png(f.read())
    want = np.asarray(imageio.imread(fn))
    assert got.shape == want.shape == (512, 512, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('filt', [0, 1, 2, 3, 4])
def test_png_filters_roundtrip(filt):
    """Every filter type, encoded here by the PNG rules, decodes to the
    image it came from (gray+alpha, 2 bytes per pixel)."""
    import struct
    import zlib
    rng = np.random.RandomState(filt)
    img = rng.randint(0, 256, (9, 7, 2)).astype(np.uint8)
    H, W, C = img.shape
    raw = b''
    prior = np.zeros(W * C, np.int64)
    for y in range(H):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(C, np.int64), cur[:-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), prior[:-C]])
        if filt == 0:
            pred = np.zeros_like(cur)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prior
        elif filt == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        raw += bytes([filt]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(t, body):
        return struct.pack('>I', len(body)) + t + body + b'\0\0\0\0'
    png = (b'\x89PNG\r\n\x1a\n'
           + chunk(b'IHDR', struct.pack('>IIBBBBB', W, H, 8, 4, 0, 0, 0))
           + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))
    np.testing.assert_array_equal(t_texture.decode_png(png), img)


def test_obj_geometry_matches_jax_parser():
    """The spot256 OBJ (its mtl names maps that are not in the repo, so the
    JAX loader cannot run on it): geometry of the port's parser against
    the JAX loader on the same file with the mtllib line removed."""
    import tempfile
    from nvdiffrecmc_tpu.render import obj as j_obj
    with open(os.path.join(SPOT, 'mesh.obj')) as f:
        lines = [ln for ln in f if not ln.startswith('mtllib')]
    with tempfile.TemporaryDirectory() as d:
        fn = os.path.join(d, 'mesh.obj')
        with open(fn, 'w') as f:
            f.writelines(lines)
        want = j_obj.load_obj(fn)
        got = t_obj.load_obj(fn, device='cpu')
    assert got.t_pos_idx.shape == (26474, 3)
    for k in ('v_pos', 't_pos_idx', 'v_tex', 't_tex_idx', 'v_nrm',
              't_nrm_idx'):
        w, g = getattr(want, k), getattr(got, k)
        assert (w is None) == (g is None), k
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.material['kd'].data.numpy(),
                                  np.asarray(want.material['kd'].data))
