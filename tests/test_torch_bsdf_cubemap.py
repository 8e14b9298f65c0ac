"""The port's BSDF stack (ops/bsdf.py) and cubemap prefiltering
(ops/cubemap.py) against the JAX package's on the CPU, values and
gradients, from seeded inputs.

- Every function of bsdf.py, its value and the gradient of a seeded
  weighted sum of it with respect to every input, within rtol 1e-5 /
  atol 1e-6 (values) and rtol 1e-4 / atol 1e-5 (gradients: float32, the
  same formulas, products summed in other orders).  The cosines and alphas
  straddle the SPECULAR_EPSILON and roughness clamps and sit exactly on
  their edges, where JAX's jnp.clip gives zero gradient outside and half
  at a tie: the port's gradient there equals JAX's within the same
  tolerance.
- cubemap_dirs and cubemap_solid_angles equal JAX's at res 4 and 8 (both
  built in float64 numpy, then float32); diffuse_cubemap and
  specular_cubemap at res 4-8, with chunks that do and do not divide the
  texel count, values within rtol 1e-5 / atol 1e-6 and the gradient with
  respect to the cubemap within rtol 1e-4 / atol 1e-6 (float32 matmuls
  of 384-1,536 terms)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import bsdf as j_bsdf
from nvdiffrecmc_tpu.ops import cubemap as j_cube
from nvdiffrecmc_tpu_torch import ops as t_ops
from nvdiffrecmc_tpu_torch.ops import bsdf as t_bsdf
from nvdiffrecmc_tpu_torch.ops import cubemap as t_cube

N = 64
EPS = np.float32(t_bsdf.SPECULAR_EPSILON)


def _unit(rng, n):
    v = rng.randn(n, 3)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _cosines(rng, n):
    """Cosines across [-0.2, 1.2] with the clamp's edges among them."""
    c = rng.uniform(-0.2, 1.2, (n, 1)).astype(np.float32)
    c[:4, 0] = [EPS, np.float32(1.0) - EPS, 0.0, 1.0]
    return c


def _front(rng, nrm, n):
    """Directions mostly in nrm's hemisphere, some below it."""
    d = _unit(rng, n) + 1.2 * nrm
    d[-8:] = -d[-8:]
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(name, seed):
    rng = np.random.RandomState(seed)
    nrm = _unit(rng, N)
    wi, wo = _front(rng, nrm, N), _front(rng, nrm, N)
    c3 = rng.rand(N, 3).astype(np.float32)
    c1 = rng.rand(N, 1).astype(np.float32)
    alpha = rng.uniform(0.0, 1.2, (N, 1)).astype(np.float32)
    alpha[:2, 0] = [np.float32(0.08 * 0.08), 1.0]
    arm = rng.rand(N, 3).astype(np.float32)
    arm[:2, 1] = [0.08, 1.0]
    pos = (rng.randn(N, 3) * 0.3).astype(np.float32)
    view = pos + 3.0 * wo
    light = pos + 2.0 * wi
    return {
        'lambert': (nrm, wi),
        'frostbite': (nrm, wi, wo, c1),
        'fresnel_schlick': (c3, c1, _cosines(rng, N)),
        'ndf_ggx': (alpha, _cosines(rng, N)),
        'lambda_ggx': (alpha, _cosines(rng, N)),
        'masking_smith_ggx_correlated': (alpha, _cosines(rng, N),
                                         _cosines(rng, N)),
        'pbr_specular': (c3, nrm, wo, wi, alpha),
        'pbr_bsdf_lambert': (c3, arm, pos, nrm, view, light),
        'pbr_bsdf_frostbite': (c3, arm, pos, nrm, view, light),
        'pbr_bsdf_demodulated': (c3, arm, pos, nrm, view, wi),
    }[name]


def _fn(module, name):
    if name.startswith('pbr_bsdf_') and name != 'pbr_bsdf_demodulated':
        bsdf = 0 if name.endswith('lambert') else 1
        return lambda *a: module.pbr_bsdf(*a, BSDF=bsdf)
    return getattr(module, name)


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize('name', [
    'lambert', 'frostbite', 'fresnel_schlick', 'ndf_ggx', 'lambda_ggx',
    'masking_smith_ggx_correlated', 'pbr_specular', 'pbr_bsdf_lambert',
    'pbr_bsdf_frostbite', 'pbr_bsdf_demodulated'])
def test_bsdf_matches_jax(name):
    args = _inputs(name, seed=len(name))
    jf, tf = _fn(j_bsdf, name), _fn(t_bsdf, name)
    want = _outputs(jf(*[jnp.asarray(a) for a in args]))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    got = _outputs(tf(*ts))
    rng = np.random.RandomState(99)
    ws = [rng.rand(*np.shape(w)).astype(np.float32) for w in want]
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)

    def jloss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(_outputs(jf(*a)), ws))
    jg = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    sum((o * torch.as_tensor(w)).sum() for o, w in zip(got, ws)).backward()
    for i, (t, j) in enumerate(zip(ts, jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg='argument %d' % i)


def test_ops_reexports_the_jax_names():
    """ops/__init__.py re-exports the names JAX's does."""
    for k in ('lambert', 'frostbite', 'fresnel_schlick', 'ndf_ggx',
              'lambda_ggx', 'masking_smith_ggx_correlated', 'pbr_specular',
              'pbr_bsdf', 'SPECULAR_EPSILON', 'MIN_ROUGHNESS',
              'prepare_shading_normal', 'NORMAL_THRESHOLD', 'image_loss',
              'tonemap_log_srgb', 'xfm_points', 'xfm_vectors', 'vecmath'):
        assert hasattr(t_ops, k), k
    assert t_ops.SPECULAR_EPSILON == j_bsdf.SPECULAR_EPSILON
    assert t_ops.MIN_ROUGHNESS == j_bsdf.MIN_ROUGHNESS


@pytest.mark.parametrize('res', [4, 8])
def test_cubemap_geometry_matches_jax(res):
    d = t_cube.cubemap_dirs(res, device='cpu')
    sa = t_cube.cubemap_solid_angles(res, device='cpu')
    np.testing.assert_array_equal(d.numpy(),
                                  np.asarray(j_cube.cubemap_dirs(res)))
    np.testing.assert_array_equal(
        sa.numpy(), np.asarray(j_cube.cubemap_solid_angles(res)))
    assert abs(float(sa.double().sum()) - 4 * np.pi) < 1e-5


@pytest.mark.parametrize('kind, res, chunk', [
    ('diffuse', 4, 2048), ('diffuse', 8, 100), ('specular_0.5', 4, 96),
    ('specular_0.2', 8, 2048), ('specular_0.9', 6, 50)])
def test_cubemap_prefilter_matches_jax(kind, res, chunk):
    rng = np.random.RandomState(res * 10 + chunk)
    cube = (rng.rand(6, res, res, 3) * 2).astype(np.float32)
    w = rng.rand(6, res, res, 3).astype(np.float32)
    if kind == 'diffuse':
        def jf(c):
            return j_cube.diffuse_cubemap(c, chunk=chunk)

        def tf(c):
            return t_cube.diffuse_cubemap(c, chunk=chunk)
    else:
        r = float(kind.split('_')[1])

        def jf(c):
            return j_cube.specular_cubemap(c, r, chunk=chunk)

        def tf(c):
            return t_cube.specular_cubemap(c, r, chunk=chunk)
    want = jf(jnp.asarray(cube))
    t = torch.tensor(cube, requires_grad=True)
    got = tf(t)
    assert tuple(got.shape) == (6, res, res, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    jg = jax.grad(lambda c: jnp.sum(jf(c) * w))(jnp.asarray(cube))
    (got * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)


def test_specular_cubemap_refuses_a_non_cube():
    with pytest.raises(ValueError, match='cubemap'):
        t_cube.specular_cubemap(torch.zeros(6, 4, 5, 3), 0.5)
