"""Port parity, decorrelated shading (the decorrelated flag): the forward
estimator on one set of uniforms, its gradient on another, as the JAX
package's env_shade_decorrelated computes it.  On the 16x16 G-buffer of
tests/test_torch_envshade_loop.py (a ground plane under 48 small
blockers) at n_samples 2, the fused path, fed JAX's make_uniforms arrays
of the forward seed and of the backward seed (rnd_seed + 0x77777), as
tests/test_torch_step.py feeds the one of a correlated step.

Tolerances, with their reasons:
- the decorrelated forward against the correlated forward on the forward
  uniforms: equal (the same launches on the same inputs);
- its gradient against the correlated gradient on the backward uniforms:
  equal (the backward samples and traces those uniforms as a correlated
  forward does, then runs the same shade backward and light scatter);
- the forward and the gradients in the light, pos, nrm, view, kd and ks
  against JAX's env_shade_decorrelated (its env_shade taken by
  env_shade_fused_jnp; the forward and VJP under one jax.jit): within
  1e-4 of max|x| on >=
  99.9% of entries (a grazing shadow ray may flip between the JAX matmul
  test and the port's Plücker sums; the light tables are exact in
  bfloat16)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nvdiffrecmc_tpu.ops import bvh as j_bvh
from nvdiffrecmc_tpu.ops import envshade as j_es
from nvdiffrecmc_tpu.ops import pallas_shade as j_ps
from nvdiffrecmc_tpu_torch import config as t_config
from nvdiffrecmc_tpu_torch.ops import bvh as t_bvh
from nvdiffrecmc_tpu_torch.ops import envshade as t_es
from nvdiffrecmc_tpu_torch.ops import pallas_shade as t_ps
from nvdiffrecmc_tpu_torch.render import render as t_render
from test_torch_envshade_loop import _loop_scene, _port_args, smooth_light, t
from test_torch_envshade_loop import _one_thread  # noqa: F401  (autouse)

N = 2
FWD_SEED = 5
BWD_SEED = FWD_SEED + 0x77777
# argument positions of (base, pos, nrm, view, kd, ks) in _port_args
DIFF = (7, 2, 3, 4, 5, 6)


def _scene():
    gbuf, (v, tri) = _loop_scene(side=16)
    P = gbuf[0].size
    perms = j_es.make_perms(N, n_tables=16)
    u = {seed: t(j_ps.make_uniforms(jax.random.PRNGKey(seed), N * N, P, N,
                                    perms))
         for seed in (FWD_SEED, BWD_SEED)}
    rng = np.random.RandomState(9)
    cot = tuple(rng.randn(*gbuf[2].shape).astype(np.float32)
                for _ in range(2))
    return gbuf, (v, tri), perms, u, cot


def _port(gbuf, v, tri, perms, cot, **kw):
    """(forward, gradients in DIFF order) of <cot_d, diffuse> + <cot_s,
    specular> through the port's fused env shade."""
    targs = list(_port_args(gbuf, smooth_light()))
    for k in DIFF:
        targs[k].requires_grad_()
    d, s = t_ps.env_shade_fused(*targs, t_bvh.build(t(v), t(tri),
                                                    leaf_size=16),
                                t(perms).long(), FWD_SEED, 1.0, BSDF=0,
                                n_samples_x=N, **kw)
    (torch.sum(d * t(cot[0])) + torch.sum(s * t(cot[1]))).backward()
    return (d.detach(), s.detach()), [targs[k].grad for k in DIFF]


def test_decorrelated_matches_correlated_on_each_uniform_set():
    gbuf, (v, tri), perms, u, cot = _scene()
    fwd, grads = _port(gbuf, v, tri, perms, cot, uniforms=u[FWD_SEED],
                       bwd=u[BWD_SEED])
    fwd_c = _port(gbuf, v, tri, perms, cot, uniforms=u[FWD_SEED])[0]
    grads_c = _port(gbuf, v, tri, perms, cot, uniforms=u[BWD_SEED])[1]
    for a, b in zip(fwd, fwd_c):
        assert torch.equal(a, b)
    for a, b in zip(grads, grads_c):
        assert float(b.abs().max()) > 0.0
        assert torch.equal(a, b)
    # and the gradient differs from the correlated one on the forward's
    grads_f = _port(gbuf, v, tri, perms, cot, uniforms=u[FWD_SEED])[1]
    assert not torch.equal(grads[0], grads_f[0])


def test_decorrelated_matches_jax(monkeypatch):
    gbuf, (v, tri), perms, u, cot = _scene()
    fwd, grads = _port(gbuf, v, tri, perms, cot, uniforms=u[FWD_SEED],
                       bwd=u[BWD_SEED])

    monkeypatch.setattr(j_es, 'env_shade', j_ps.env_shade_fused_jnp)
    base, pdf, rows, cols = smooth_light()
    jbvh = j_bvh.build(jnp.asarray(v), jnp.asarray(tri), leaf_size=16)
    mask, ro = jnp.asarray(gbuf[0]), jnp.asarray(gbuf[1])

    def f(lb, pos, nrm, view, kd, ks):
        return j_es.env_shade_decorrelated(
            mask, ro, pos, nrm, view, kd, ks, lb, pdf, rows, cols, jbvh,
            perms, FWD_SEED, BWD_SEED, 1.0, BSDF=0, n_samples_x=N)
    @jax.jit
    def fwd_and_vjp(args, cot):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cot)
    want_fwd, want = fwd_and_vjp(
        (base,) + tuple(jnp.asarray(a) for a in gbuf[2:7]),
        tuple(jnp.asarray(c) for c in cot))
    for name, g, w in zip(('d', 's', 'light', 'pos', 'nrm', 'view', 'kd',
                           'ks'), list(fwd) + grads,
                          list(want_fwd) + list(want)):
        g, w = g.numpy(), np.asarray(w)
        assert np.abs(w).max() > 0.0, name
        ok = np.abs(g - w) <= 1e-4 * np.abs(w).max()
        assert ok.mean() >= 0.999, (name, ok.mean(), np.abs(g - w).max())


def test_shade_mc_seeds_the_backward(monkeypatch):
    """shade_mc hands env_shade the backward seed rnd_seed + 0x77777 with
    decorrelated, and none without."""
    seen = []
    monkeypatch.setattr(t_es, 'env_shade',
                        lambda *a, **k: seen.append(k['bwd']))
    z = torch.zeros((1, 2, 2, 3))
    pre = dict(kd=z, ks=z, gb_pos=z, gb_normal_shaded=z, rast_id=z[..., 0],
               view_pos=torch.zeros((1, 1, 1, 3)))
    lgt = dict(base=None, pdf=None, rows=None, cols=None)
    for flag in (True, False):
        FLAGS = t_config.make_flags(decorrelated=flag, n_samples=N)
        t_render.shade_mc(FLAGS, pre, lgt, None, 'pbr', 1.0, 40, None)
    assert seen == [40 + 0x77777, None]
