"""checks.sample_bound, the bound the sample kernel is held to, on the
CPU.  Two float32 runs of the plain sampler (pallas_shade.sample_all_plain)
whose draws differ in their last ulp stand for the kernel and its plain
version, on a light map whose first and last rows carry most of the
light: there an ulp of a draw moves the pdfs' 1 / sin(theta) by more than
the plain 1e-3 + 1e-3 |x| (the reason the check corrects them), and the
corrected bound holds.  A wrong pdf, direction or radiance on one of
those entries, or a BSDF pdf on the wrong side of the grazing cut, fails
it."""

import numpy as np
import pytest
import torch

from nvdiffrecmc_tpu_torch import checks
from nvdiffrecmc_tpu_torch.ops import pallas_shade as ps
from nvdiffrecmc_tpu_torch.render import light as light_mod

HL, WL, P, N = 128, 256, 4096, 4


def _scene(seed):
    rng = np.random.RandomState(seed)
    base = rng.rand(HL, WL, 3).astype(np.float32)
    base[0] *= 50.0
    base[-1] *= 50.0
    t = light_mod.update_pdf(torch.as_tensor(base))
    nrm = rng.randn(3, P)
    nrm /= np.linalg.norm(nrm, axis=0)
    wo = rng.randn(3, P)
    wo /= np.linalg.norm(wo, axis=0)
    wo *= np.sign((wo * nrm).sum(0))
    gb8 = np.concatenate([nrm, wo, rng.uniform(0.05, 1.0, (1, P)),
                          rng.uniform(0.0, 1.0, (1, P))])
    gen = torch.Generator()
    gen.manual_seed(seed)
    u8 = ps.make_uniforms(gen, N * N, P, N, device='cpu')
    return t, torch.as_tensor(gb8.astype(np.float32)), u8, \
        torch.as_tensor(base)


def _pair(seed, step):
    """(got, want, gb8, tables): want from the draws, got from the draws
    one ulp up (step 1) or down (step -1)."""
    t, gb8, u8, base = _scene(seed)
    want = ps.sample_all_plain(u8, gb8, t.rows, t.cols, t.pdf, base, N)
    u = u8.clone()
    u[:, :5] = torch.nextafter(u[:, :5], torch.full_like(u[:, :5],
                                                         2.0 * step))
    got = ps.sample_all_plain(u, gb8, t.rows, t.cols, t.pdf, base, N)
    return got, want, gb8, t


def _plain_ratio(got, want):
    """The plain bound's err / bound per entry [n2, P], over the entries
    whose texels agree (0 elsewhere)."""
    same = (got[:, ps.S_LTEX:ps.S_LTEX + 2]
            == want[:, ps.S_LTEX:ps.S_LTEX + 2]).all(1)
    r = ((got - want).abs() / (1e-3 + 1e-3 * want.abs())).amax(1)
    return torch.where(same, r, 0.0)


def test_last_ulp_versions_stay_within_the_bound():
    plain = []
    for seed in (0, 1):
        for step in (1, -1):
            got, want, gb8, t = _pair(seed, step)
            share, bound, _, n_held, held_bound = checks.sample_bound(
                got, want, gb8, t.rows, t.cols, t.pdf)
            assert share >= checks.MIN_AGREE, (seed, step, share)
            assert bound <= 1.0 and held_bound <= 1.0, (seed, step, bound)
            assert n_held > 0
            plain.append(float(_plain_ratio(got, want).max()))
    # the uncorrected bound fails on these pole rows
    assert max(plain) > 1.0, plain


def _held_entry(got, want, gb8, which):
    """(stratum, pixel) of an entry whose texels agree, whose light
    (which 'light') or BSDF (which 'bsdf') texel lies in a pole row, and
    whose light direction is far from the grazing cut with a BSDF pdf
    there at least 0.2 from 1."""
    same = (got[:, ps.S_LTEX:ps.S_LTEX + 2]
            == want[:, ps.S_LTEX:ps.S_LTEX + 2]).all(1)
    c = ps.S_LTEX if which == 'light' else ps.S_BTEX
    row = torch.div(want[:, c], WL, rounding_mode='floor')
    L = ps.S_LDIR
    mix, m = ps.bsdf_pdf_mix(gb8[7][None], (gb8[0][None], gb8[1][None],
                                            gb8[2][None]),
                             (gb8[3][None], gb8[4][None], gb8[5][None]),
                             (got[:, L], got[:, L + 1], got[:, L + 2]),
                             gb8[6][None])
    ok = same & ((row == 0) | (row == HL - 1)) & (m > 0.1) & \
        ((mix - 1.0).abs() > 0.2)
    s, p = [int(v) for v in torch.nonzero(ok)[0]]
    return s, p, float(mix[s, p])


@pytest.mark.parametrize('fault', ['light_pdf', 'bsdf_pdf', 'cut_side',
                                   'direction', 'radiance'])
def test_a_wrong_value_at_a_pole_row_fails(fault):
    got, want, gb8, t = _pair(0, 1)
    assert checks.sample_bound(got, want, gb8, t.rows, t.cols,
                               t.pdf)[1] <= 1.0
    s, p, mix = _held_entry(got, want, gb8,
                            'bsdf' if fault == 'bsdf_pdf' else 'light')
    bad = got.clone()
    if fault == 'light_pdf':
        bad[s, ps.S_LPDF, p] *= 1.01
    elif fault == 'bsdf_pdf':
        bad[s, ps.S_BPDF, p] *= 1.01
    elif fault == 'cut_side':      # the BSDF term as if the light grazed
        bad[s, ps.S_LPDF, p] += 1.0 - mix
    elif fault == 'direction':
        bad[s, ps.S_LDIR + 1, p] += 0.01
    else:
        bad[s, ps.S_LRAD, p] *= 1.01
    bound = checks.sample_bound(bad, want, gb8, t.rows, t.cols, t.pdf)[1]
    assert bound > 1.0, (fault, bound)
