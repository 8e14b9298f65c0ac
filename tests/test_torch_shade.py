"""Port parity, Monte-Carlo shading: the sampling kernel's plain version
against sample_all_jnp (bf16-exact light tables, the same uniforms; atol
1e-5, and for the MIS pdfs 1e-4 relative widened only by their stated
condition terms at small roughness and near the poles), the tracer against the
brute-force any-hit twin (>= 99.9% of bits), and the shade forward
against env_shade_fused_jnp with the same make_uniforms array (atol 1e-4
on >= 99.5% of pixels: a grazing shadow ray may flip between the JAX
matmul and the port's elementwise Plücker sums)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import bvh as j_bvh
from nvdiffrecmc_tpu.ops import pallas_shade as j_ps
from nvdiffrecmc_tpu.ops import tracer as j_tracer
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu_torch.ops import bvh as t_bvh
from nvdiffrecmc_tpu_torch.ops import pallas_shade as t_ps
from nvdiffrecmc_tpu_torch.ops import tracer as t_tracer

HL, WL = 32, 64


def t(x):
    return torch.as_tensor(np.array(x))


def bf16_tables(seed):
    """A probe whose pdf/cdf tables are exact in bfloat16 (the JAX twin's
    table gathers round to bf16; the port reads float32)."""
    rng = np.random.RandomState(seed)
    base = jnp.asarray((rng.randint(1, 9, (HL, WL, 3)) / 8.0).astype(
        np.float32))
    tb = j_light.update_pdf(base)

    def rnd(x):
        return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)
    return base, rnd(tb.pdf), rnd(tb.rows), rnd(tb.cols)


@pytest.mark.parametrize('n_samples_x', [2, 3])
def test_sample_all_matches_jax(n_samples_x):
    P = 512
    n2 = n_samples_x * n_samples_x
    rng = np.random.RandomState(1)
    nrm = rng.randn(3, P).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=0, keepdims=True)
    wo = rng.randn(3, P).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=0, keepdims=True)
    flip = (np.sum(nrm * wo, 0) < 0) & (rng.rand(P) < 0.9)
    wo = np.where(flip[None], -wo, wo)
    alpha = rng.uniform(0.08, 0.7, (1, P)).astype(np.float32) ** 2
    p_diffuse = rng.uniform(0.0, 1.0, (1, P)).astype(np.float32)
    p_diffuse[0, :16] = 0.0              # degenerate-lobe branch
    gb8 = jnp.asarray(np.concatenate([nrm, wo, alpha, p_diffuse], 0))
    perms = jnp.asarray(np.array(
        [np.random.RandomState(i).permutation(n2) for i in range(64)],
        np.int32))
    u8 = j_ps.make_uniforms(jax.random.PRNGKey(2), n2, P, n_samples_x, perms)
    base, pdf, rows, cols = bf16_tables(0)
    want = j_ps.sample_all_jnp(u8, gb8, rows, cols, pdf, base, n_samples_x)
    got = t_ps.sample_all(t(u8), t(gb8), t(rows), t(cols),
                          t_ps.sample_guide(t(rows), t(cols)), t(pdf),
                          t(base), n_samples_x).numpy()
    want = np.asarray(want)
    # Directions, radiance and texel ids: atol 1e-5 on >= 99.9% of the
    # entries and 1e-3 on all.  At small alpha the GGX sample amplifies
    # last-ulp differences of rsqrt/sin/cos between XLA and PyTorch (a few
    # direction components in 1e4 differ by up to 9e-5).
    keep = [r for r in range(16) if r not in (t_ps.S_LPDF, t_ps.S_BPDF)]
    err = np.abs(got[:, keep] - want[:, keep])
    assert (err <= 1e-5).mean() >= 0.999, (err > 1e-5).sum()
    assert err.max() <= 1e-3, err.max()
    # MIS pdf sums, each held to 1e-4 relative plus two condition terms:
    # - the GGX D term's denominator 1 - c^2 (1 - a^2) turns an ulp of the
    #   half-vector cosine (1.2e-7) into 4 ulp / alpha^2 relative (measured
    #   8.8e-3 at alpha 0.0065, 7e-4 at alpha 0.02-0.05);
    # - the lat-long pdf's 1 / sin(theta) turns an ulp of the direction
    #   into ~1e-6 / sin(theta) near a pole (measured 3e-3 at sin 4e-4).
    pdfs = [t_ps.S_LPDF, t_ps.S_BPDF]
    sin_theta = np.sqrt(np.clip(1.0 - want[:, [1, 4]] ** 2, 1e-14, 1.0))
    rtol = 1e-4 + 5e-7 / alpha[None] ** 2 + 3e-6 / sin_theta
    err = np.abs(got[:, pdfs] - want[:, pdfs])
    ratio = err / (1e-5 + rtol * np.abs(want[:, pdfs]))
    assert ratio.max() <= 1.0, ratio.max()


def sphere_soup(n_tri=400, seed=0):
    """Random small triangles on the unit sphere, plus two degenerate
    ones (which must never hit)."""
    rng = np.random.RandomState(seed)
    c = rng.randn(n_tri, 3)
    c /= np.linalg.norm(c, axis=-1, keepdims=True)
    a = np.cross(c, [0, 0, 1.0])
    a /= np.linalg.norm(a, axis=-1, keepdims=True) + 1e-9
    b = np.cross(c, a)
    vs = [c + 0.15 * (rng.randn(n_tri, 1) * a + rng.randn(n_tri, 1) * b)
          for _ in range(3)]
    verts = np.concatenate(vs, 0).astype(np.float32)
    tris = np.arange(3 * n_tri, dtype=np.int32).reshape(3, n_tri).T
    tris = np.concatenate([tris, [[0, 0, 1], [5, 5, 5]]]).astype(np.int32)
    return verts, tris


def test_any_hit_matches_bruteforce():
    v, tri = sphere_soup()
    rng = np.random.RandomState(1)
    R = 4096
    ro = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd[:8] = 0.0                                   # disabled rays
    rd[8:16, 1:] = 0.0                             # axis-aligned rays
    rd[8:16, 0] = 1.0
    bvh = t_bvh.build(t(v), t(tri), leaf_size=16)
    got = t_tracer.any_hit(t(ro), t(rd), bvh, tmin=0.0, ray_chunk=1000)
    j = jnp.asarray
    want = np.asarray(j_tracer.any_hit_bruteforce(
        j(ro), j(rd), j(v[tri[:, 0]]), j(v[tri[:, 1]]), j(v[tri[:, 2]]),
        tmin=0.0))
    got = got.numpy()
    assert not got[:8].any()
    assert (got == want).mean() >= 0.999, (got != want).sum()
    assert want.mean() > 0.04


def _scene(side=16, seed=21):
    """G-buffer over a ground plane with a triangle blocker overhead and a
    few masked pixels (as tests/test_pallas_shade.py)."""
    rng = np.random.RandomState(seed)
    xs = np.linspace(-1, 1, side, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs)
    pos = np.stack([gx, np.zeros_like(gx), gz], -1)[None]
    nrm = np.zeros_like(pos)
    nrm[..., 1] = 1.0
    view = pos + np.array([0.3, 2.0, 0.1], np.float32)
    kd = rng.uniform(0.2, 0.9, pos.shape).astype(np.float32)
    ks = np.stack([np.zeros_like(gx), rng.uniform(0.3, 0.8, gx.shape),
                   rng.uniform(0.0, 1.0, gx.shape)], -1)[None].astype(
                       np.float32)
    mask = np.ones((1, side, side), np.float32)
    mask[:, :2, :2] = 0.0
    ro = pos + nrm * 1e-3
    v = np.array([[-1.0, 0.5, -1.0], [0.0, 0.5, -1.0], [-1.0, 0.5, 0.0],
                  [0.2, 0.3, 0.2], [0.9, 0.3, 0.2], [0.2, 0.3, 0.9]],
                 np.float32)
    tri = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    return (mask, ro, pos, nrm, view, kd, ks), (v, tri)


@pytest.mark.parametrize('shadow_scale', [1.0, 0.75])
def test_shade_forward_matches_jax(shadow_scale):
    gbuf, (v, tri) = _scene()
    base, pdf, rows, cols = bf16_tables(9)
    n, seed = 2, 7
    P = gbuf[0].size
    u8 = j_ps.make_uniforms(jax.random.PRNGKey(seed), n * n, P, n, None)
    jbvh = j_bvh.build(jnp.asarray(v), jnp.asarray(tri), leaf_size=16)
    jargs = tuple(jnp.asarray(x) for x in gbuf) + (base, pdf, rows, cols)
    dj, sj = j_ps.env_shade_fused_jnp(*jargs, jbvh, None, seed, shadow_scale,
                                      BSDF=0, n_samples_x=n)
    tbvh = t_bvh.build(t(v), t(tri), leaf_size=16)
    targs = tuple(t(x) for x in gbuf) + tuple(t(x) for x in
                                               (base, pdf, rows, cols))
    dt, st = t_ps.env_shade_fused(*targs, tbvh, None, seed, shadow_scale,
                                  BSDF=0, n_samples_x=n, uniforms=t(u8))
    for g, w in ((dt, dj), (st, sj)):
        err = np.abs(g.numpy() - np.asarray(w)).max(-1)
        assert (err <= 1e-4).mean() >= 0.995, err.max()
    assert float(np.abs(np.asarray(dj)).sum()) > 0.1
    # the blockers shadow part of the plane: shadow_scale 0 lights it all
    d0, _ = t_ps.env_shade_fused(*targs, tbvh, None, seed, 0.0,
                                 n_samples_x=n, uniforms=t(u8))
    dark = (d0 - dt).amax(-1) > 1e-3
    assert 0.0 < float(dark.float().mean()) < 0.9


def test_make_uniforms_shape_and_strata():
    g = torch.Generator()
    g.manual_seed(0)
    u = t_ps.make_uniforms(g, 16, 100, 4, device='cpu')
    assert u.shape == (16, 8, 100)
    assert float(u[:, :5].min()) >= 0.0 and float(u[:, :5].max()) < 1.0
    # each pixel visits every stratum cell exactly once
    cells = u[:, 5].long()
    assert (torch.sort(cells, dim=0).values
            == torch.arange(16)[:, None]).all()
