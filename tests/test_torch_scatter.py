"""Port parity, the row scatter (the adjoint of every rows_gather):
scatter_add_plain against the JAX package's binned sorted_scatter_add_t
(interpret mode) with duplicate ids and ids past the table, ids below 0
dropped too, and the gradients of rows_gather / rows_gather_b against the
JAX rows_gather's; atol 1e-5 (float sums in another order)."""

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
