"""Port parity, rasterizer and antialias: rasterize with 2 depth-peel
layers, interpolate (with derivatives), interpolate_face and antialias on
the __graft_entry__._make_scene octasphere at 64x64.  Triangle ids must
agree on >= 99.9% of pixels; values atol 1e-4 where they agree (the JAX
resolve evaluates its fields with a matmul, the port elementwise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from nvdiffrecmc_tpu.ops import antialias as j_aa
from nvdiffrecmc_tpu.ops import rasterizer as j_ras
from nvdiffrecmc_tpu.ops import xfm as j_xfm
from nvdiffrecmc_tpu_torch.ops import antialias as t_aa
from nvdiffrecmc_tpu_torch.ops import rasterizer as t_ras

RES = 64
ATOL = 1e-4


@pytest.fixture(scope='module')
def scene():
    m, _, _, mvp, _ = ge._make_scene(res=RES, n_samples=1, sub=3)
    # an off-axis camera so the two peel layers and silhouettes are generic
    rot = np.asarray(mvp) @ np.array(
        [[1, 0, 0, 0], [0, 0.8, -0.6, 0], [0, 0.6, 0.8, 0], [0, 0, 0, 1]],
        np.float32)
    v_clip = np.array(j_xfm.xfm_points(m.v_pos, jnp.asarray(rot)))
    return v_clip, np.array(m.t_pos_idx), np.array(m.v_pos)


@pytest.fixture(scope='module')
def layers(scene):
    v_clip, tri, _ = scene
    out = {}
    for name, ras, conv in (('jax', j_ras, jnp.asarray),
                            ('torch', t_ras, torch.as_tensor)):
        peeled, prev = [], None
        for _ in range(2):
            rast, db = ras.rasterize(conv(v_clip), conv(tri), (RES, RES),
                                     prev_rast=prev)
            prev = rast
            peeled.append((np.array(rast), np.array(db)))
        out[name] = peeled
    return out


@pytest.mark.parametrize('layer', [0, 1])
def test_rasterize_peel_layers_match_jax(layers, layer):
    (rj, dj), (rt, dt) = layers['jax'][layer], layers['torch'][layer]
    agree = rj[..., 3] == rt[..., 3]
    assert agree.mean() >= 0.999, agree.mean()
    assert (rj[..., 3] > 0).mean() > 0.05          # non-trivial coverage
    np.testing.assert_allclose(rt[agree], rj[agree], atol=ATOL, rtol=0)
    np.testing.assert_allclose(dt[agree], dj[agree], atol=ATOL, rtol=0)


def test_interpolate_and_antialias_match_jax(scene, layers):
    v_clip, tri, v_pos = scene
    rast, db = layers['jax'][0]
    rng = np.random.RandomState(0)
    attr = rng.rand(v_pos.shape[0], 5).astype(np.float32)
    face = rng.rand(tri.shape[0], 3).astype(np.float32)
    color = rng.rand(1, RES, RES, 4).astype(np.float32)
    j = (jnp.asarray, j_ras, j_aa)
    t = (torch.as_tensor, t_ras, t_aa)
    outs = []
    for conv, ras, aa in (j, t):
        o, o_da = ras.interpolate(conv(attr), conv(rast), conv(tri),
                                  rast_db=conv(db))
        f = ras.interpolate_face(conv(face), conv(rast))
        c = aa.antialias(conv(color), conv(rast), conv(v_clip), conv(tri))
        outs.append([np.asarray(x) for x in (o, o_da, f, c)])
    for w, g in zip(*outs):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
