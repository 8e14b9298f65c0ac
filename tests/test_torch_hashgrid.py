"""Port parity, the hash-grid encoding and the neural material
(nvdiffrecmc_tpu/ops/hashgrid.py): the same numpy-seeded table and points
through the JAX package's encode (its Pallas scatter run as its own CPU
tests run it) and encode_ref, and through the port's encode (one row
gather, the row scatter's plain version as its backward) and encode_ref.

Configs: 6 levels from 4 to 4096 with 2^14 rows (levels 0-1 dense, 2-5
hashed), and 5 levels from 16 to 4096 with 2^13 rows and 3 features (one
dense level).  Points: uniform in [0, 1]^3, the corners 0 and 1 of the
cube, points on cell faces, and points whose hash products overflow 32 bits
(y and z cells past 2^32 / 805459861).

Tolerances: features within 1e-6 (the sums of 8 products in another
order); the table's cotangent within 1e-5 of its largest entry (sums of up
to P x 8 terms in another order); the position cotangent within 1e-5 of
its largest entry (the products scale with the level's resolution, up to
4096).  sample_mlp_texture: values within 1e-6, every gradient within
1e-5 of its largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import hashgrid as J
from nvdiffrecmc_tpu_torch import convert
from nvdiffrecmc_tpu_torch.ops import hashgrid as T

CFGS = {
    'dense_and_hashed': dict(n_levels=6, n_features_per_level=2,
                             log2_hashmap_size=14, base_resolution=4,
                             desired_resolution=4096),
    'three_features': dict(n_levels=5, n_features_per_level=3,
                           log2_hashmap_size=13, base_resolution=16,
                           desired_resolution=4096),
}


def _points(n, seed):
    """Uniform points, the cube's corners 0 and 1, points on cell faces at
    the finest level, and points whose y and z cells make the hash's
    products pass 2^32."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 3).astype(np.float32)
    x[0] = 0.0
    x[1] = 1.0
    x[2] = [0.0, 1.0, 0.5]
    x[3:8] = np.floor(x[3:8] * 4096) / 4096            # on cell faces
    x[8:16, 1:] = rng.uniform(0.5, 1.0, (8, 2))        # big y, z cells
    return x


def _cfgs(name):
    return J.HashEncodingConfig(**CFGS[name]), T.HashEncodingConfig(
        **CFGS[name])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize('name', sorted(CFGS))
def test_encode_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    res = J.level_scales(jcfg)
    assert T.level_scales(tcfg) == res
    dense = [(r + 1) ** 3 <= 1 << jcfg.log2_hashmap_size for r in res]
    assert any(dense) and not all(dense)
    rng = np.random.RandomState(1)
    L, F = jcfg.n_levels, jcfg.n_features_per_level
    table = rng.uniform(-1, 1, (L, 1 << jcfg.log2_hashmap_size, F)).astype(
        np.float32)
    x = _points(700, 2)
    g = rng.randn(x.shape[0], L * F).astype(np.float32)
    # the hashed levels' products wrap in uint32
    cells = np.floor(x[8:16, 1:] * res[-1]).astype(np.int64)
    assert (cells * 805459861 >= 2 ** 32).all()

    feats, vjp = jax.vjp(lambda t, p: J.encode(t, p, jcfg),
                         jnp.asarray(table), jnp.asarray(x))
    d_table, d_x = vjp(jnp.asarray(g))
    ref = J.encode_ref(jnp.asarray(table), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(np.asarray(feats), np.asarray(ref),
                               rtol=0, atol=1e-6)

    tt = torch.tensor(table.reshape(-1, F), requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    got = T.encode(tt, xt, tcfg)
    (got * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(feats),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        T.encode_ref(torch.as_tensor(table.reshape(-1, F)),
                     torch.as_tensor(x), tcfg).numpy(),
        np.asarray(ref), rtol=0, atol=1e-6)
    assert _rel(tt.grad.numpy().reshape(table.shape), d_table) <= 1e-5
    assert _rel(xt.grad.numpy(), d_x) <= 1e-5


@pytest.mark.parametrize('name', sorted(CFGS))
def test_encode_rows_match_jax(name):
    """The port's rows [L, 8, P] equal the JAX package's: the dense levels'
    (ix (r+1) + iy) (r+1) + iz and the hashed levels' _hashed_rows, each
    offset by its level's block."""
    jcfg, tcfg = _cfgs(name)
    x = _points(300, 3)
    res_np, nD, Tn = J._level_consts(jcfg)
    p0, _ = J._wc_t(jnp.asarray(x.T), res_np)
    want_h = np.asarray(J._hashed_rows(p0[:, nD:], res_np[nD:], Tn)) + nD * Tn
    rows = T.encode_rows(torch.as_tensor(x), tcfg).numpy()
    np.testing.assert_array_equal(rows[nD:], want_h)
    for l in range(nD):
        r = int(res_np[l])
        p = np.asarray(p0[:, l])                               # [3, P]
        for c in range(8):
            ic = [np.clip(p[d] + ((c >> d) & 1), 0, r) for d in range(3)]
            want = (ic[0] * (r + 1) + ic[1]) * (r + 1) + ic[2] + l * Tn
            np.testing.assert_array_equal(rows[l, c], want)


def test_sample_mlp_texture_matches_jax():
    """The neural material: JAX's init_mlp_texture carried across with
    convert.mlp_texture, points in a box around an AABB (some clipped),
    the six channels bounded by (min, max); values and the gradients of
    the table, the weights and the points."""
    jcfg, tcfg = _cfgs('dense_and_hashed')
    jp = J.init_mlp_texture(jax.random.PRNGKey(3), jcfg, channels=6)
    # a livelier table than the init's 1e-4, so the MLP sees its features
    jp = jp._replace(table=jnp.asarray(np.random.RandomState(4).uniform(
        -1, 1, jp.table.shape).astype(np.float32)))
    lo = np.array([-1.0, -0.8, -1.2], np.float32)
    hi = np.array([1.1, 0.9, 1.0], np.float32)
    mn = np.array([0.0, 0.0, 0.0, 0.0, 0.1, 0.0], np.float32)
    mx = np.array([1.0, 1.0, 1.0, 0.0, 1.0, 1.0], np.float32)
    rng = np.random.RandomState(5)
    x = rng.uniform(-1.3, 1.3, (2, 9, 11, 3)).astype(np.float32)
    g = rng.randn(2, 9, 11, 6).astype(np.float32)

    def jfn(p, pts):
        return J.sample_mlp_texture(p, jcfg, (jnp.asarray(lo), jnp.asarray(hi)),
                                    (jnp.asarray(mn), jnp.asarray(mx)), pts)
    out, vjp = jax.vjp(jfn, jp, jnp.asarray(x))
    d_p, d_x = vjp(jnp.asarray(g))

    mat = convert.mlp_texture(jp, device='cpu')
    for v in mat.values():
        v.requires_grad_()
    tp = T.MLPTexture3DParams(
        table=mat['table'], weights=(mat['w0'], mat['w1'], mat['w2']))
    xt = torch.tensor(x, requires_grad=True)
    got = T.sample_mlp_texture(
        tp, tcfg, (torch.as_tensor(lo), torch.as_tensor(hi)),
        (torch.as_tensor(mn), torch.as_tensor(mx)), xt)
    (got * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-6)
    assert _rel(mat['table'].grad.numpy().reshape(d_p.table.shape),
                d_p.table) <= 1e-5
    for i, w in enumerate(d_p.weights):
        assert _rel(mat['w%d' % i].grad.numpy(), w) <= 1e-5, i
    assert _rel(xt.grad.numpy(), d_x) <= 1e-5


def test_init_mlp_texture_draws_jax_distributions():
    """The port draws its own init from a torch.Generator (JAX's keys
    cannot be reproduced): the same shapes as JAX's, the table in
    (-1e-4, 1e-4), each weight in +-sqrt(6 / fan_in), the same draws from
    the same seed."""
    cfg = T.HashEncodingConfig()
    jshapes = jax.eval_shape(lambda k: J.init_mlp_texture(
        k, J.HashEncodingConfig(), channels=6), jax.random.PRNGKey(0))
    gens = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(0)
        gens.append(T.init_mlp_texture(cfg, channels=6, generator=gen,
                                       device='cpu'))
    p = gens[0]
    L, Tn, F = jshapes.table.shape
    assert tuple(p.table.shape) == (L * Tn, F)
    assert float(p.table.abs().max()) <= 1e-4
    assert float(p.table.std()) > 5e-5
    assert [tuple(w.shape) for w in p.weights] == \
        [tuple(w.shape) for w in jshapes.weights]
    for w in p.weights:
        bound = np.sqrt(6.0 / w.shape[0])
        assert float(w.abs().max()) <= bound
        assert float(w.abs().max()) > 0.8 * bound
    assert torch.equal(p.table, gens[1].table)
