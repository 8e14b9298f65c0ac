"""The public helpers of the JAX package that no path calls, each against
its counterpart in the port on the CPU, values and (where they are
differentiable) gradients, from seeded inputs.

- render/regularizer.py: laplace_regularizer_const, normal_consistency
  (on a perturbed octahedron, every edge's two faces), avg_edge_length;
  ops/mesh_ops.py: compute_edges_np (equal), avg_edge_length.  Values
  within rtol 1e-5, gradients within rtol 1e-4 / atol 1e-6.
- ops/vecmath.py: reflect, reinhard (rtol 1e-6), psnr_to_mse, scale_mtx,
  lookAt (numpy, within 1e-6).
- ops/denoiser.py: denoise on an 8-channel [1, 12, 16, 8] input at sigma
  1.5 within rtol 1e-5 (the taps' plain version against JAX's jnp taps),
  sigma_from_influence at and around its clamp (values and gradient,
  half at the tie as jnp.maximum gives it).
- render/light.py: pdf_scale; render/mesh.py: aabb (value and gradient:
  the min and max spread their gradient over ties alike).
- ops/tracer.py: any_hit_bruteforce equal to JAX's on every ray, and to
  the port's BVH tracer (any_hit) where no ray grazes an edge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import denoiser as j_den
from nvdiffrecmc_tpu.ops import mesh_ops as j_mesh_ops
from nvdiffrecmc_tpu.ops import tracer as j_tracer
from nvdiffrecmc_tpu.ops import vecmath as j_vec
from nvdiffrecmc_tpu.render import light as j_light
from nvdiffrecmc_tpu.render import mesh as j_mesh
from nvdiffrecmc_tpu.render import regularizer as j_reg
from nvdiffrecmc_tpu_torch.ops import bvh as t_bvh
from nvdiffrecmc_tpu_torch.ops import denoiser as t_den
from nvdiffrecmc_tpu_torch.ops import mesh_ops as t_mesh_ops
from nvdiffrecmc_tpu_torch.ops import tracer as t_tracer
from nvdiffrecmc_tpu_torch.ops import vecmath as t_vec
from nvdiffrecmc_tpu_torch.render import light as t_light
from nvdiffrecmc_tpu_torch.render import mesh as t_mesh
from nvdiffrecmc_tpu_torch.render import regularizer as t_reg

OCTA_V = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                   [0, 0, -1]], np.float32)
OCTA_T = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5],
                   [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)


def _octahedron(seed):
    rng = np.random.RandomState(seed)
    return (OCTA_V + 0.1 * rng.randn(*OCTA_V.shape)).astype(np.float32), OCTA_T


def _edge_to_face(t):
    faces = {}
    for f, tri in enumerate(t):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            faces.setdefault(tuple(sorted((tri[a], tri[b]))), []).append(f)
    return np.array([faces[e] for e in sorted(faces)], np.int32)


def _value_and_grad(jf, tf, args, grad_args):
    """Values of jf and tf on args, and the gradients of their sums
    against argument indices grad_args."""
    want = jf(*[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=i in grad_args)
          if np.issubdtype(np.asarray(a).dtype, np.floating)
          else torch.as_tensor(a) for i, a in enumerate(args)]
    got = tf(*ts)
    got.sum().backward()

    def jsum(*fa):
        a = list(args)
        for i, x in zip(grad_args, fa):
            a[i] = x
        return jnp.sum(jf(*[jnp.asarray(x) for x in a]))
    jg = jax.grad(jsum, argnums=tuple(range(len(grad_args))))(
        *[jnp.asarray(args[i]) for i in grad_args])
    return want, got, jg, [ts[i].grad for i in grad_args]


@pytest.mark.parametrize('name', ['laplace_regularizer_const',
                                  'laplace_masked', 'normal_consistency',
                                  'mesh_ops_avg_edge_length'])
def test_mesh_regularizers_match_jax(name):
    v, t = _octahedron(len(name))
    if name == 'laplace_regularizer_const':
        jf, tf, args = (j_reg.laplace_regularizer_const,
                        t_reg.laplace_regularizer_const, (v, t))
    elif name == 'laplace_masked':
        mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32)
        jf, tf, args = (j_reg.laplace_regularizer_const,
                        t_reg.laplace_regularizer_const, (v, t, mask))
    elif name == 'normal_consistency':
        jf, tf, args = (j_reg.normal_consistency, t_reg.normal_consistency,
                        (v, t, _edge_to_face(t)))
    else:
        jf, tf, args = (j_mesh_ops.avg_edge_length,
                        t_mesh_ops.avg_edge_length,
                        (v, j_mesh_ops.compute_edges_np(t)))
    want, got, jg, tg = _value_and_grad(jf, tf, args, (0,))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), rtol=1e-4,
                               atol=1e-6)


def test_edges_and_avg_edge_length_match_jax():
    v, t = _octahedron(3)
    e = t_mesh_ops.compute_edges_np(t)
    np.testing.assert_array_equal(e, j_mesh_ops.compute_edges_np(t))
    assert e.shape == (12, 2)
    got = t_reg.avg_edge_length(torch.as_tensor(v), torch.as_tensor(t))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, j_reg.avg_edge_length(jnp.asarray(v), t),
                               rtol=1e-6)


def test_vecmath_helpers_match_jax():
    rng = np.random.RandomState(5)
    x, n = rng.randn(2, 16, 3).astype(np.float32)
    np.testing.assert_allclose(
        t_vec.reflect(torch.as_tensor(x), torch.as_tensor(n)).numpy(),
        np.asarray(j_vec.reflect(jnp.asarray(x), jnp.asarray(n))),
        rtol=1e-6, atol=1e-6)
    f = rng.rand(8, 4, 3).astype(np.float32) * 5
    np.testing.assert_allclose(t_vec.reinhard(torch.as_tensor(f)).numpy(),
                               np.asarray(j_vec.reinhard(jnp.asarray(f))),
                               rtol=1e-6)
    for p in (10.0, 23.5, 40.0):
        assert t_vec.psnr_to_mse(p) == j_vec.psnr_to_mse(p)
        np.testing.assert_allclose(t_vec.mse_to_psnr(t_vec.psnr_to_mse(p)),
                                   p, rtol=1e-12)
    np.testing.assert_array_equal(t_vec.scale_mtx(1.7), j_vec.scale_mtx(1.7))
    for eye, at, up in (((0, 0, 3), (0, 0, 0), (0, 1, 0)),
                        ((1.5, -2, 0.5), (0.1, 0.2, 0.3), (0, 0, 1))):
        np.testing.assert_allclose(t_vec.lookAt(eye, at, up),
                                   j_vec.lookAt(eye, at, up), rtol=0,
                                   atol=1e-6)


def test_denoise_matches_jax():
    rng = np.random.RandomState(8)
    col = rng.rand(1, 12, 16, 3)
    nrm = rng.randn(1, 12, 16, 3)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[..., 2] = np.abs(nrm[..., 2]) + 2.0
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    zdz = np.concatenate([rng.rand(1, 12, 16, 1) + 2.0,
                          rng.rand(1, 12, 16, 1) * 0.1], -1)
    x = np.concatenate([col, nrm, zdz], -1).astype(np.float32)
    want = np.asarray(j_den.denoise(jnp.asarray(x), 1.5))
    got = t_den.denoise(torch.as_tensor(x), 1.5).numpy()
    assert got.shape == want.shape == (1, 12, 16, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_sigma_from_influence_matches_jax():
    f = np.array([0.0, 5e-5, 0.3, 1.0], np.float32)
    want, got, jg, tg = _value_and_grad(j_den.sigma_from_influence,
                                        t_den.sigma_from_influence, (f,),
                                        (0,))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-7)
    np.testing.assert_array_equal(tg[0].numpy(), np.asarray(jg[0]))
    assert float(tg[0][1]) == 1.0      # 2 * 5e-5 == 1e-4: half of 2


def test_pdf_scale_and_aabb_match_jax():
    base = np.zeros((32, 64, 3), np.float32)
    assert t_light.pdf_scale(torch.as_tensor(base)) == \
        j_light.pdf_scale(jnp.asarray(base))
    v, t = _octahedron(11)
    v[2, 0] = v[0, 0]                   # a tie for the max along x
    jm = j_mesh.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(t))
    tv = torch.tensor(v, requires_grad=True)
    tm = t_mesh.Mesh(v_pos=tv, t_pos_idx=torch.as_tensor(t))
    lo, hi = t_mesh.aabb(tm)
    jlo, jhi = j_mesh.aabb(jm)
    np.testing.assert_array_equal(lo.detach().numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.detach().numpy(), np.asarray(jhi))
    (lo.sum() + 2 * hi.sum()).backward()
    jg = jax.grad(lambda p: jnp.sum(jnp.min(p, 0))
                  + 2 * jnp.sum(jnp.max(p, 0)))(jnp.asarray(v))
    np.testing.assert_array_equal(tv.grad.numpy(), np.asarray(jg))


def test_any_hit_bruteforce_matches_jax_and_the_bvh_tracer():
    rng = np.random.RandomState(13)
    T, R = 60, 400
    c = rng.uniform(-1, 1, (T, 1, 3))
    tri = (c + 0.3 * rng.randn(T, 3, 3)).astype(np.float32)
    ro = rng.uniform(-2, 2, (R, 3)).astype(np.float32)
    rd = rng.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    v0, v1, v2 = (tri[:, k] for k in range(3))
    want = np.asarray(j_tracer.any_hit_bruteforce(
        *[jnp.asarray(a) for a in (ro, rd, v0, v1, v2)]))
    got = t_tracer.any_hit_bruteforce(
        *[torch.as_tensor(a) for a in (ro, rd, v0, v1, v2)]).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < got.mean() < 0.9
    bvh = t_bvh.build(torch.as_tensor(tri.reshape(-1, 3)),
                      torch.arange(3 * T, dtype=torch.int32).reshape(T, 3),
                      leaf_size=16)
    occ = t_tracer.any_hit(torch.as_tensor(ro), torch.as_tensor(rd), bvh,
                           tmin=1e-4).numpy()
    assert (occ != got).sum() <= 2, np.nonzero(occ != got)
