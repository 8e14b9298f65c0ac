"""The sample kernel's CDF inversion (csrc/sample.cu) in plain PyTorch,
against the binary search of the plain version (pallas_shade._invert_cdf):
a guide table per CDF of K entries (pallas_shade.sample_guide_plain, the
guide kernel's plain version), g[b] = the number of entries whose bucket
floor(v K) (clamped to [0, K - 1]) is below b, and the binary search over
[g[b], g[b + 1]] for a draw x in bucket b.  For a non-decreasing CDF the
two give the same index, hence the same pdf and frac bits; the tables of
light.update_pdf are non-decreasing.  Lights with a ragged width (75),
black texels (flat runs), a black row, draws exactly on CDF values, at 0
and at 1; the search ranges' lengths; the guide tables against a count
by sorted search; and the light sizes the kernels take."""

import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu_torch.ops import pallas_shade
from nvdiffrecmc_tpu_torch.render import light as light_mod


def _bucket(v, K):
    return torch.clamp(torch.floor(v * float(K)).long(), 0, K - 1)


def _guides(t):
    """The column guides [Hl, Wl + 1] and the row guide [Hl + 1] of light
    tables t, split out of sample_guide_plain's flat layout."""
    Hl, Wl = t.cols.shape
    g = pallas_shade.sample_guide_plain(t.rows, t.cols).long()
    assert g.shape == (Hl * (Wl + 1) + Hl + 1,)
    return g[:Hl * (Wl + 1)].reshape(Hl, Wl + 1), g[Hl * (Wl + 1):]


def _guided(cdf, g, x):
    """The kernel's index: the plain binary search over [g[b], g[b + 1]]
    of x's bucket b, per draw (cdf, g: [n, K], [n, K + 1])."""
    K = cdf.shape[1]
    x = torch.clamp(x, max=pallas_shade.ONE_MINUS_EPS)
    b = _bucket(x, K)
    lo = g.gather(1, b[:, None])[:, 0]
    hi = g.gather(1, b[:, None] + 1)[:, 0]
    for _ in range(int(K).bit_length()):
        active = lo < hi
        mid = (lo + hi) // 2
        go = cdf.gather(1, torch.clamp(mid, max=K - 1)[:, None])[:, 0] <= x
        lo = torch.where(active & go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return torch.clamp(lo, max=K - 1)


def _tables(Hl, Wl, seed):
    rng = np.random.RandomState(seed)
    base = rng.rand(Hl, Wl, 3).astype(np.float32) ** 4
    base[rng.rand(Hl, Wl) < 0.2] = 0.0      # flat runs in the CDF
    base[Hl // 3] = 0.0                      # a row with no weight
    return light_mod.update_pdf(torch.as_tensor(base))


@pytest.mark.parametrize('Hl,Wl', [(37, 75), (16, 256), (64, 128)])
def test_guided_search_equals_binary_search(Hl, Wl):
    t = _tables(Hl, Wl, seed=Hl + Wl)
    assert bool((t.cols[:, 1:] >= t.cols[:, :-1]).all())
    assert bool((t.rows[1:] >= t.rows[:-1]).all())
    rng = np.random.RandomState(Wl)
    n = 4096
    y = torch.as_tensor(rng.randint(0, Hl, n))
    x = torch.as_tensor(rng.rand(n).astype(np.float32))
    # draws on CDF values (ties), at 0 and at the top
    on = torch.as_tensor(rng.randint(0, Wl, n // 4))
    x[:n // 4] = t.cols[y[:n // 4], on]
    x[n // 4:n // 4 + 8] = 0.0
    x[n // 4 + 8:n // 4 + 16] = 1.0
    y[n // 4 + 16:n // 4 + 64] = Hl // 3    # the black row: all entries 0
    want = pallas_shade._invert_cdf(t.cols.reshape(-1), y * Wl, Wl, x)[0]
    g, gr = _guides(t)
    assert torch.equal(_guided(t.cols[y], g[y], x), want.long())
    # the row CDF, on draws of its own
    xr = torch.cat([x, t.rows[torch.as_tensor(rng.randint(0, Hl, 64))]])
    want = pallas_shade._invert_cdf(t.rows, torch.zeros_like(xr).long(), Hl,
                                    xr)[0]
    gr = gr[None].expand(xr.numel(), -1)
    assert torch.equal(_guided(t.rows[None].expand(xr.numel(), -1), gr, xr),
                       want.long())


@pytest.mark.parametrize('Hl,Wl', [(37, 75), (16, 256), (64, 128)])
def test_sample_guide_plain_counts_buckets(Hl, Wl):
    """Each guide entry g[b] is the count of entries in buckets below b: on
    a non-decreasing CDF, where the sorted buckets would insert b."""
    t = _tables(Hl, Wl, seed=3 * Hl + Wl)
    g, gr = _guides(t)
    for cdf, guide in ((t.cols, g), (t.rows[None], gr[None])):
        K = cdf.shape[1]
        want = torch.searchsorted(_bucket(cdf, K).contiguous(),
                                  torch.arange(K + 1).expand(
                                      cdf.shape[0], -1).contiguous())
        assert torch.equal(guide, want)


def test_guide_ranges_are_short_on_the_probe():
    """On the repo's 512x1024 probe no search range [g[b], g[b + 1]] holds
    more than 20 entries (at most 5 search steps, where the whole row CDF
    takes 10 and a column CDF 11).  A uniform draw's range holds one entry
    in the mean: the ranges of the K buckets hold the K entries."""
    from nvdiffrecmc_tpu_torch.dataset.dataset_mesh import SPOT256_PROBE
    t = light_mod.update_pdf(light_mod.load_env(SPOT256_PROBE, device='cpu'))
    assert tuple(t.cols.shape) == (512, 1024)
    for g in _guides(t):
        g = g.reshape(-1, g.shape[-1])
        assert bool((g[:, -1] == g.shape[1] - 1).all())
        assert int((g[:, 1:] - g[:, :-1]).max()) <= 20


@pytest.mark.parametrize('Hl,Wl,fits', [(512, 1024, True),
                                        (6143, 12288, True),
                                        (6144, 64, False),
                                        (64, 12289, False)])
def test_sample_light_size_limit(Hl, Wl, fits):
    """The kernels take their shared memory within the 48 KB a block has
    without opting in (the guide kernel max(Hl, Wl) words, the sampler
    2 Hl + 1): the guide wrapper passes a light that fits on to the
    tensors' checks (which refuse CPU tensors) and refuses one that does
    not.  The tables are stride-0 views: only their shapes are read."""
    rows = torch.zeros(1).expand(Hl)
    cols = torch.zeros(1, 1).expand(Hl, Wl)
    match = 'must be a CUDA tensor' if fits else 'takes lights of at most'
    with pytest.raises(ValueError, match=match):
        pallas_shade._sample_guide_cuda(rows, cols)


def test_sample_refuses_a_light_too_large():
    """The guide wrapper refuses a light past that limit before it looks at
    the tensors' device, so the refusal shows on CPU tensors too."""
    with pytest.raises(ValueError, match='at most 6143 rows'):
        pallas_shade._sample_guide_cuda(torch.zeros(6144),
                                        torch.zeros(6144, 1))
    with pytest.raises(ValueError, match='12288 columns'):
        pallas_shade._sample_guide_cuda(torch.zeros(1), torch.zeros(1, 12289))
