"""Port parity, the row scatter (the adjoint of every rows_gather):
scatter_add_plain against the JAX package's binned sorted_scatter_add_t
(interpret mode) with duplicate ids and ids past the table, ids below 0
dropped too, and the gradients of rows_gather / rows_gather_b against the
JAX rows_gather's; atol 1e-5 (float sums in another order).  For each
channel count of the training step's scatters (3, 4, 6, 9, 13), against
the JAX scatter_add_t (interpret mode): runs of equal ids in the vertex
adjoint's pattern (three ids per pixel, repeated across neighbouring
pixels of one triangle, uncovered pixels zero), every row on one id, and
ids out of range on both sides; and the rows_gather gradient on that
pattern."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu.ops import pallas_scatter as j_sc
from nvdiffrecmc_tpu_torch.ops import pallas_scatter as t_sc


@pytest.mark.parametrize('C', [1, 4, 9])
def test_scatter_add_plain_matches_jax(C):
    rng = np.random.RandomState(C)
    V, M = 700, 3000
    idx = np.sort(rng.randint(0, V + 50, M)).astype(np.int32)  # dup + OOB
    idx[:200] = 17                                             # hot row
    idx.sort()
    vals = rng.randn(M, C).astype(np.float32)
    want = j_sc.sorted_scatter_add_t(jnp.asarray(idx), jnp.asarray(vals.T),
                                     V, interpret=True)
    got = t_sc.scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), V)
    assert got.shape == (V, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, rtol=0,
                               atol=1e-5)


def test_scatter_add_drops_negative_ids():
    idx = torch.tensor([-1, 0, 2, 2, 5, -7])
    vals = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    got = t_sc.scatter_add_plain(idx, vals, 3)
    want = np.zeros((3, 2), np.float32)
    want[0] = [2, 3]
    want[2] = [4 + 6, 5 + 7]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('batched', [False, True])
def test_rows_gather_grad_matches_jax(batched):
    rng = np.random.RandomState(5)
    V, C = 40, 6
    table = rng.randn(2, V, C).astype(np.float32)
    idx = rng.randint(0, V, (2, 7, 5, 3)).astype(np.int32)
    g = rng.randn(2, 7, 5, 3, C).astype(np.float32)
    if batched:
        jfn = j_sc.rows_gather_b
        tfn = t_sc.rows_gather_b
        jt, tt = jnp.asarray(table), torch.as_tensor(table)
    else:
        def jfn(tab, i):
            return j_sc.rows_gather(tab, i)
        tfn = t_sc.rows_gather
        jt, tt = jnp.asarray(table[0]), torch.as_tensor(table[0])
    out, vjp = jax.vjp(lambda t: jfn(t, jnp.asarray(idx)), jt)
    want, = vjp(jnp.asarray(g))
    tt.requires_grad_()
    got = tfn(tt, torch.as_tensor(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


STEP_CHANNELS = [3, 4, 6, 9, 13]


def _vertex_pattern(rng, P, V):
    """[P * 3] vertex ids of P pixels in runs of 1-16 neighbouring pixels
    on one triangle, and a coverage flag per pixel (about 30% uncovered):
    the rows of the interpolate adjoint, three a pixel."""
    ids, cov = [], []
    while len(ids) < 3 * P:
        n = rng.randint(1, 17)
        tri = rng.randint(0, V, 3)
        covered = rng.rand() > 0.3
        ids.extend(list(tri) * n)
        cov.extend([covered] * n)
    return (np.array(ids[:3 * P], np.int32),
            np.repeat(np.array(cov[:P]), 3))


def _pattern(name, C, rng):
    V, M = 500, 2400
    if name == 'runs':
        idx, cov = _vertex_pattern(rng, M // 3, V)
        vals = rng.randn(M, C).astype(np.float32) * cov[:, None]
    elif name == 'one_id':
        idx = np.full(M, 123, np.int32)
        vals = rng.randn(M, C).astype(np.float32)
    else:                                          # out of range
        idx = rng.randint(-40, V + 40, M).astype(np.int32)
        idx[:64] = -1
        idx[64:128] = V
        vals = rng.randn(M, C).astype(np.float32)
    vals[rng.rand(M) < 0.1] = 0.0                  # whole zero rows
    return idx, vals, V


@pytest.mark.parametrize('pattern', ['runs', 'one_id', 'out_of_range'])
@pytest.mark.parametrize('C', STEP_CHANNELS)
def test_scatter_add_step_channels_match_jax(C, pattern):
    rng = np.random.RandomState(100 + C)
    idx, vals, V = _pattern(pattern, C, rng)
    want = j_sc.scatter_add_t(jnp.asarray(idx), jnp.asarray(vals.T), V,
                              interpret=True)
    got = t_sc.scatter_add(torch.as_tensor(idx), torch.as_tensor(vals), V)
    assert got.shape == (V, C) and got.dtype == torch.float32
    # the hot row sums ~2,000 terms of size ~1 in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want).T, rtol=1e-5,
                               atol=1e-5)
    if pattern == 'one_id':
        # every other row stays exactly zero
        assert float(got[torch.arange(V) != 123].abs().max()) == 0.0


@pytest.mark.parametrize('C', STEP_CHANNELS)
def test_rows_gather_grad_vertex_runs_match_jax(C):
    rng = np.random.RandomState(200 + C)
    V, P = 300, 1000
    idx, cov = _vertex_pattern(rng, P, V)
    idx = idx.reshape(P, 3)
    table = rng.randn(V, C).astype(np.float32)
    g = (rng.randn(P, 3, C) * cov.reshape(P, 3, 1)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: j_sc.rows_gather(t, jnp.asarray(idx)),
                       jnp.asarray(table))
    want, = vjp(jnp.asarray(g))
    tt = torch.as_tensor(table).requires_grad_()
    got = t_sc.rows_gather(tt, torch.as_tensor(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.as_tensor(g))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
