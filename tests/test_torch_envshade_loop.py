"""Port parity, the env-shade stratum loop (env_shade past 256 strata, the
validation protocol).  Per stratum the port runs the fused pipeline's
sampling (pallas_shade.sample_all on that stratum's uniforms), one trace of
both ray sets and the fused pipeline's shading; its JAX twin is
env_shade_fused_jnp, the JAX package's jnp loop over the same per-stratum
sampling and shading.  Both are fed JAX's make_uniforms array on a 16x16
G-buffer.

Tolerances, with their reasons:
- the loop's diffuse and specular sums against JAX: 1e-4 abs + 1e-4 rel on
  >= 99.9% of entries (a grazing shadow ray may flip between the JAX
  matmul test and the port's elementwise Plücker sums).  The light tables
  are exact in bfloat16 (JAX's table gathers round to bf16; the port reads
  float32), and the probe varies slowly from texel to texel, so a sample
  that lands one texel over (trig ulps at a texel border) moves little.
- the loop against the port's own fused pipeline on the same uniforms:
  1e-5 abs + 1e-5 rel everywhere (the same functions; the sums differ only
  in float32 rounding order), forward and gradient.
- the loop's gradient against jax.grad of env_shade_fused_jnp: 1e-4
  max|g| (see test_loop_raises_under_autograd and
  test_loop_gradient_matches_jax_in_the_light).
The scene has at most 15 leaves, so the JAX tracer's k_pairs cap drops
nothing (tracer.OCCLUSION_DROPPED_PAIRS stays 0)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import bvh as j_bvh
from nvdiffrecmc_tpu.ops import envshade as j_es
from nvdiffrecmc_tpu.ops import pallas_shade as j_ps
from nvdiffrecmc_tpu.ops import tracer as j_tracer
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu_torch.ops import bvh as t_bvh
from nvdiffrecmc_tpu_torch.ops import envshade as t_es
from nvdiffrecmc_tpu_torch.ops import pallas_shade as t_ps


@pytest.fixture(autouse=True)
def _one_thread():
    """The stratum loop runs a few hundred small PyTorch ops per stratum;
    with one intra-op thread they do not oversubscribe the cores that
    parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.as_tensor(np.array(x))


def smooth_light(H=32, W=64):
    """A probe that varies slowly from texel to texel, with a bright lobe;
    its pdf and CDF tables rounded to bfloat16."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    lobe = np.exp(-((y - 0.3 * H) ** 2 + (x - 0.6 * W) ** 2) / (0.05 * H * W))
    base = (0.6 + 0.3 * np.sin(2 * np.pi * x / W)[..., None]
            * np.array([1.0, 0.8, 0.6]) + 3.0 * lobe[..., None])
    base = jnp.asarray(base.astype(np.float32))
    tb = j_light.update_pdf(base)

    def rnd(v):
        return jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32)
    return base, rnd(tb.pdf), rnd(tb.rows), rnd(tb.cols)


def _loop_scene(side=16, seed=21):
    """A ground-plane G-buffer (as tests/test_torch_shade.py) under a soup
    of 48 small triangles (leaf size 16: 3 leaves), a few masked
    pixels."""
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
    n_tri = 48
    c = rng.uniform(-1.2, 1.2, (n_tri, 3)) * [1, 0, 1] + [0, 0.6, 0]
    v = np.concatenate([c + rng.randn(n_tri, 3) * 0.12 for _ in range(3)])
    tri = np.arange(3 * n_tri).reshape(3, n_tri).T
    return ((mask, ro, pos, nrm, view, kd, ks),
            (v.astype(np.float32), tri.astype(np.int32)))


def _port_args(gbuf, light):
    return tuple(t(a) for a in gbuf) + tuple(t(a) for a in light)


@pytest.mark.parametrize('n_samples_x', [17, 32])
def test_env_shade_loop_matches_jax(n_samples_x):
    """17: the permutation-table path; 32: the Kensler permutation."""
    gbuf, (v, tri) = _loop_scene()
    light = smooth_light()
    n2, P = n_samples_x * n_samples_x, gbuf[0].size
    perms = j_es.make_perms(n_samples_x, n_tables=64)
    seed = 11
    j_tracer.OCCLUSION_DROPPED_PAIRS[0] = 0
    jbvh = j_bvh.build(jnp.asarray(v), jnp.asarray(tri), leaf_size=16)
    assert jbvh.n_leaves <= 15
    jargs = tuple(jnp.asarray(a) for a in gbuf) + light
    dj, sj = j_ps.env_shade_fused_jnp(*jargs, jbvh, perms, seed, 1.0,
                                      BSDF=0, n_samples_x=n_samples_x)
    dj, sj = np.asarray(dj), np.asarray(sj)
    assert j_tracer.OCCLUSION_DROPPED_PAIRS[0] == 0

    tbvh = t_bvh.build(t(v), t(tri), leaf_size=16)
    targs = _port_args(gbuf, light)
    u8 = t(j_ps.make_uniforms(jax.random.PRNGKey(seed), n2, P, n_samples_x,
                              perms))
    dt, st = t_es.env_shade(*targs, tbvh, t(perms).long(), seed, 1.0,
                            BSDF=0, n_samples_x=n_samples_x, uniforms=u8)
    for g, w in ((dt, dj), (st, sj)):
        g = g.numpy()
        ok = np.abs(g - w) <= 1e-4 + 1e-4 * np.abs(w)
        assert ok.mean() >= 0.999, (ok.mean(), np.abs(g - w).max())
    assert float(np.abs(dj).sum()) > 0.1
    assert (dj[0, :2, :2] == 0).all() and (dt[0, :2, :2] == 0).all()
    if n_samples_x != 17:
        return
    # the blockers take part of the light (shadow_scale 0: all visible)
    d0, _ = t_es.env_shade(*targs, tbvh, t(perms).long(), seed, 0.0,
                           BSDF=0, n_samples_x=n_samples_x, uniforms=u8)
    assert 0.05 < float(dt.sum() / d0.sum()) < 0.95


@pytest.mark.parametrize('shadow_scale', [1.0, 0.5])
def test_loop_matches_fused_pipeline(shadow_scale):
    """The loop is the fused pipeline taken one stratum at a time."""
    gbuf, (v, tri) = _loop_scene(side=8)
    n_samples_x = 17
    n2, P = n_samples_x * n_samples_x, gbuf[0].size
    perms = t_es.make_perms(n_samples_x, n_tables=16, device='cpu')
    gen = torch.Generator()
    gen.manual_seed(5)
    u8 = t_ps.make_uniforms(gen, n2, P, n_samples_x, perms, device='cpu')
    tbvh = t_bvh.build(t(v), t(tri), leaf_size=16)
    targs = _port_args(gbuf, smooth_light())
    got = t_es.env_shade(*targs, tbvh, perms, 0, shadow_scale,
                         n_samples_x=n_samples_x, uniforms=u8)
    want = t_ps.env_shade_fused(*targs, tbvh, perms, 0, shadow_scale,
                                n_samples_x=n_samples_x, uniforms=u8)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    assert float(got[0].abs().sum()) > 0.1


@pytest.mark.parametrize('n_samples_x', [5, 8])
def test_stratum_draws_match_make_uniforms(n_samples_x):
    """The loop's per-stratum cells are make_uniforms' rows, and the sample
    kernel's plain version on one stratum is that stratum of the whole."""
    n2, P = n_samples_x * n_samples_x, 64
    perms = t_es.make_perms(n_samples_x, n_tables=16, device='cpu')
    gen = torch.Generator()
    gen.manual_seed(3)
    u8 = t_ps.make_uniforms(gen, n2, P, n_samples_x, perms, device='cpu')
    gen.manual_seed(3)
    torch.rand((n2, 5, P), generator=gen)
    seeds = t_ps.perm_seeds(gen, P, n_samples_x, perms, device='cpu')
    base, pdf, rows, cols = (t(a) for a in smooth_light())
    rng = np.random.RandomState(4)
    nrm = rng.randn(3, P)
    wo = rng.randn(3, P)
    gb8 = t(np.concatenate([nrm / np.linalg.norm(nrm, axis=0),
                            wo / np.linalg.norm(wo, axis=0),
                            rng.uniform(0.01, 0.6, (1, P)),
                            rng.uniform(0, 1, (1, P))]).astype(np.float32))
    guide = t_ps.sample_guide(rows, cols)
    whole = t_ps.sample_all(u8, gb8, rows, cols, guide, pdf, base,
                            n_samples_x)
    for i in (0, n2 // 2, n2 - 1):
        cells = t_ps.stratum_cells(i, n_samples_x, *seeds, perms)
        assert torch.equal(cells, u8[i, 5:7])
        one = t_ps.sample_all(u8[i:i + 1], gb8, rows, cols, guide, pdf,
                              base, n_samples_x)
        assert torch.equal(one[0], whole[i])


@pytest.mark.parametrize('n_samples_x,path', [(16, 'fused'), (17, 'loop')])
def test_env_shade_switches_at_256_strata(monkeypatch, n_samples_x, path):
    taken = []
    monkeypatch.setattr(t_ps, 'env_shade_fused',
                        lambda *a, **k: taken.append('fused') or (None, None))
    monkeypatch.setattr(t_es, '_env_shade_loop',
                        lambda *a, **k: taken.append('loop') or (None, None))
    gbuf, (v, tri) = _loop_scene(side=4)
    tbvh = t_bvh.build(t(v), t(tri), leaf_size=16)
    t_es.env_shade(*_port_args(gbuf, smooth_light()), tbvh, None, 0, 1.0,
                   n_samples_x=n_samples_x)
    assert taken == [path]


_GRAD_N = 17      # 289 strata: the loop
_GRAD_SEED = 11
# argument positions of (base, pos, nrm, view, kd, ks) in _port_args
_DIFF = (7, 2, 3, 4, 5, 6)


def _cotangents(side):
    rng = np.random.RandomState(3)
    return tuple(rng.randn(1, side, side, 3).astype(np.float32)
                 for _ in range(2))


@functools.lru_cache(maxsize=None)
def _jax_jitted():
    """JAX's any_hit and _shade_stratum under jax.jit, made once so that
    the file's gradient tests share their compiles."""
    return (jax.jit(j_tracer.any_hit,
                    static_argnames=('tmin', 'tmax', 'ray_chunk', 'k_pairs',
                                     'pair_block')),
            jax.jit(j_ps._shade_stratum, static_argnums=(4,)))


def _jax_grads(monkeypatch, side, n_samples_x, perms, argnums):
    """jax.grad of <g_d, diffuse> + <g_s, specular> through
    env_shade_fused_jnp in (base, pos, nrm, view, kd, ks)[argnums] on the
    side x side scene (JAX's any_hit and _shade_stratum jitted)."""
    any_hit, shade = _jax_jitted()
    monkeypatch.setattr(j_tracer, 'any_hit', any_hit)
    monkeypatch.setattr(j_ps, '_shade_stratum', shade)
    gbuf, (v, tri) = _loop_scene(side=side)
    base, pdf, rows, cols = smooth_light()
    jbvh = j_bvh.build(jnp.asarray(v), jnp.asarray(tri), leaf_size=16)
    mask, ro = jnp.asarray(gbuf[0]), jnp.asarray(gbuf[1])
    gd, gs = _cotangents(side)

    def f(lb, *g):
        d, s = j_ps.env_shade_fused_jnp(mask, ro, *g, lb, pdf, rows, cols,
                                        jbvh, perms, _GRAD_SEED, 1.0, BSDF=0,
                                        n_samples_x=n_samples_x)
        return jnp.sum(d * gd) + jnp.sum(s * gs)
    return jax.grad(f, argnums=argnums)(
        base, *(jnp.asarray(a) for a in gbuf[2:7]))


@functools.lru_cache(maxsize=None)
def _loop_grads():
    """The port loop's forward and the gradients of <g_d, diffuse> +
    <g_s, specular> in (base, pos, nrm, view, kd, ks) on the 8x8 scene
    at n_samples 17, on JAX's uniforms; computed once for the two tests
    that read them (the file's tests share a worker)."""
    gbuf, (v, tri) = _loop_scene(side=8)
    perms = j_es.make_perms(_GRAD_N, n_tables=16)
    n2, P = _GRAD_N * _GRAD_N, gbuf[0].size
    u8 = t(j_ps.make_uniforms(jax.random.PRNGKey(_GRAD_SEED), n2, P,
                              _GRAD_N, perms))
    tbvh = t_bvh.build(t(v), t(tri), leaf_size=16)
    gd, gs = _cotangents(8)

    def grads(fn):
        targs = list(_port_args(gbuf, smooth_light()))
        for k in _DIFF:
            targs[k].requires_grad_()
        d, s = fn(*targs, tbvh, t(perms).long(), _GRAD_SEED, 1.0, BSDF=0,
                  n_samples_x=_GRAD_N, uniforms=u8)
        (torch.sum(d * t(gd)) + torch.sum(s * t(gs))).backward()
        return (d.detach(), s.detach()), [targs[k].grad for k in _DIFF]
    return grads(t_es.env_shade), grads(t_ps.env_shade_fused), perms


def test_loop_raises_under_autograd(monkeypatch):
    """The stratum loop's gradient (n_samples 17, 289 strata, 8x8) against
    jax.grad of pallas_shade.env_shade_fused_jnp, the JAX package's jnp
    twin of its loop, on the same uniforms, in pos, nrm, view, kd and ks:
    within 1e-4 max|g| of each (the same arithmetic summed in another
    order; a grazing ray flips nothing on this scene).  JAX's any_hit and
    _shade_stratum run under jax.jit (dispatched op by op, 289 strata take
    minutes); its light gradient transposes 289 slices of the sample array,
    one compile each (85 s in all), so the light's gradient is held against
    the port's fused backward (the next test) and against JAX at 16 strata
    (test_loop_gradient_matches_jax_in_the_light).  (The test kept its
    name from when the loop raised under autograd.)"""
    (_, got), _, perms = _loop_grads()
    want = _jax_grads(monkeypatch, 8, _GRAD_N, perms, tuple(range(1, 6)))
    for name, g, w in zip(('pos', 'nrm', 'view', 'kd', 'ks'), got[1:],
                          want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_loop_backward_matches_fused_backward():
    """The loop's forward and gradient (light, pos, nrm, view, kd, ks) at
    289 strata equal the fused pipeline's on the same uniforms within
    1e-5 abs + 1e-5 rel (the loop launches shade backward and the light
    scatter once per stratum, each stratum weighed 1 / 289; the sums
    differ only in float32 rounding order)."""
    (fwd, got), (fwd_f, want), _ = _loop_grads()
    for a, b in zip(fwd, fwd_f):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0.0
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_loop_gradient_matches_jax_in_the_light(monkeypatch):
    """The stratum loop's backward (per stratum the shade backward and the
    light scatter, each stratum weighed 1 / n2) at 16 strata (n_samples 4,
    the Kensler path; 8x8), called directly since env_shade takes the fused
    path there, against jax.grad of env_shade_fused_jnp on the same
    uniforms in the light and in pos, nrm, view, kd and ks: within 1e-4
    max|g| of each, as at 289 strata.  JAX's light gradient at 289 strata
    transposes a slice of the sample array per stratum, one compile each;
    at 16 the light's path is the same, and the loop at 289 equals the
    fused backward (the test above)."""
    n = 4
    gbuf, (v, tri) = _loop_scene(side=8)
    perms = j_es.make_perms(n, n_tables=16)
    u8 = t(j_ps.make_uniforms(jax.random.PRNGKey(_GRAD_SEED), n * n,
                              gbuf[0].size, n, perms))
    targs = list(_port_args(gbuf, smooth_light()))
    for k in _DIFF:
        targs[k].requires_grad_()
    d, s = t_es._env_shade_loop(*targs, t_bvh.build(t(v), t(tri),
                                                    leaf_size=16),
                                t(perms).long(), _GRAD_SEED, 1.0, 0, n, u8)
    gd, gs = _cotangents(8)
    (torch.sum(d * t(gd)) + torch.sum(s * t(gs))).backward()
    want = _jax_grads(monkeypatch, 8, n, perms, tuple(range(6)))
    for name, k, w in zip(('light', 'pos', 'nrm', 'view', 'kd', 'ks'),
                          _DIFF, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.0, name
        np.testing.assert_allclose(targs[k].grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
