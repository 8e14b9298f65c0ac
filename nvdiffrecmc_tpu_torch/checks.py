"""Hold each CUDA kernel against its plain PyTorch version on the same CUDA
inputs, and time both.  Used by chip_smoke.py and by the GPU tests.

Tolerances, with their reasons:
- resolve: triangle id and depth equal on every pixel (the setup computes
  the plain version's fields term by term, the raster kernel evaluates them
  in its order, and the (depth, id) key keeps the lowest id on equal
  depths, as the plain version does).
- sample_guide: every entry equal (integer counts of float32 buckets,
  floor(v K) computed alike).
- sample, on covered pixels only (the shading multiplies masked pixels by
  zero, and their zero normals give arbitrary directions): >= 99.9% of the
  (stratum, pixel) entries agree, with the same texel ids and all 16
  values within 1e-4 + 1e-4 |x|; every entry whose texel ids agree lies
  within 1e-3 + 1e-3 |x| (`sample_bound`).  The rest differ in the last
  ulps of sin/acos/rsqrt, amplified where a direction grazes a pole of
  the lat-long map, lies on a texel border, or follows a sharp GGX lobe.
  Two kinds of entry have an amplification with no bound, so there the
  two pdf values are held within 1e-3 + 1e-3 |x| of the plain value
  corrected in float64, and the other 14 values within the plain bound:
  - a light or BSDF texel in the light map's first or last row.  The
    row's CDF step is near zero, so an ulp of the draw moves the row
    fraction, and x, z of the direction and the pdf's 1 / sin(theta)
    scale it; one ulp of a BSDF direction's y near +-1 moves its acos by
    percents (nerd_gold's pass-1 micro-step at n2 = 144: 535x the plain
    bound).  Each light-map term of the two pdfs, row and column CDF
    steps (or the texel's pdf) over sin(theta), is taken at the kernel's
    own texel and direction: sin(theta) is |xz| of a light direction and
    sin(acos(y)) of a BSDF one.  Where acos(y) lies near pi, the float32
    sin(v pi) of both versions carries SIN_SLACK, added to the bound;
  - a light direction within 1e-6 of the BSDF pdf's grazing cut
    (min(NdotV, NdotL) < 1e-6 gives pdf 1), or one the two versions, each
    on its own last-ulp direction, put on two sides of it (the loop
    backward's stratum 288 at n_samples 17: 0.998 apart, 480x the plain
    bound): the BSDF term may lie on either side of the cut.
  `compared_on` says how many entries were held so, and their largest
  error over the bound.
- trace_shade: visibility bits equal on >= 99.9% of rays; shading within
  1e-4 + 1e-4 |x| on pixels whose rays all agree.  The plain tracer runs
  on an evenly spaced subset of the covered pixels, against the full mesh.
- denoise: within 1e-4 |x| + 1e-6 (the exp of two libraries, summed
  over 529 taps; both take x^128 by the same 7 squarings).
- denoise_grad: each entry is a sum of n = 529 taps whose weights both
  versions compute in float32 (the exp of two libraries; x^128 by the
  same 7 squarings, since below 2^-126 a pow and a chain of squarings
  round apart by far more than this bound) and add in another order: within (1e-5 + n 2^-24) times the sum of the absolute
  values of its terms, the rounding bound of a float32 sum in any order,
  widened by 1e-5 for the weights.
- scatter, light_scatter: the kernel adds the same float32 terms as the
  plain version in the order its atomics land, so each entry is held to
  the float64 sum of its n terms within (1e-6 + 4 sqrt(n) 2^-24) times
  the sum of their absolute values: a float32 sum in a random order errs
  by ~sqrt(n/3) 2^-24 of that at most in the mean, and a lost or doubled
  term moves the entry by the term itself.  A float32 atomic add flushes
  subnormal inputs and results to zero (PTX red.add.f32; index_add_ on
  the card does the same), so each entry may also lose up to n 2^-126.
- shade_bwd, on an evenly spaced subset of the covered pixels (the plain
  version is autograd over every stratum): >= 99.9% of the entries within
  1e-4 |x| + 1e-6 max|x| of their row, every entry within 2e-2 |x| +
  1e-4 max|x|.  The wide bound is the GGX D term at roughness 0.08
  (alpha^2 = 4.1e-5), whose denominator 1 - c^2 (1 - alpha^2) cancels to
  that size; the CPU tests measured ~1% between the JAX package and the
  port there.
- trace: every ray's result equal to the plain tracer's (the walk computes
  the plain version's quantities in its order, --fmad=false).
- mask: every entry equal to the plain version's (the same slab
  arithmetic; max/min are exact).

- denoise_one, denoise_one_grad (the one-buffer instance of the
  denoiser, 3 channels): as denoise and denoise_grad.
- the launches of a decorrelated backward (check_decorrelated_backward)
  and of the stratum loop's backward (check_loop_strata, shade_bwd with
  each stratum weighed 1 / n2 of all strata): each kernel's own
  tolerance above, the light scatter's against the float64 sum.

Times: the kernel's by CUDA events over `reps` calls after a warm-up;
the plain version's over a few calls, or, for resolve, trace_shade,
shade_bwd and trace (seconds a call at the largest widths), on the one
call that is compared.

On a depth-peel layer that covers no pixel, the checks that compare
covered pixels only (sample, trace_shade, shade_bwd) have nothing to
compare and pass, saying so in `compared_on`.

`bound` gives each kernel's bound: the least time the card could take
for the same work, the largest of the bytes the function
must move (each input read once, each output written once) over 3.35 TB/s,
the float operations these inputs need over 67 TFLOP/s, the H100 SXM's
published float32 rates at 700 W, and, where a kernel needs special
functions, their count over the special-function units' rate (16 per SM
per clock, 132 SMs at 1.98 GHz).  Three counts depend on the data:

- resolve: SETUP_OPS per triangle for the setup, then RESOLVE_OPS for
  each (pixel, triangle) pair that passes the inside test and the peel
  rule (pallas_raster.covered_pairs on the plain version's fields) and
  for one test per pixel; bytes: v_clip, tri, prev_z, prev_id, z and tid.
- denoise, both modes: TAP_OPS float operations and an ex2 and a
  reciprocal (the depth weight's exp and division) for each (pixel, tap)
  pair inside the image and the dynamic radius; bytes: the three input
  planes and the 7-channel output.
- mask: SLAB_OPS for each test the answer needs, every ray of a block for
  a leaf it does not enter and one for a leaf it does; bytes: the boxes,
  the output and the 64-byte feature rows of the rays a block must read,
  all of them where some leaf is not entered, else those up to the last
  of its leaves' first entering rays (pallas_tracer.visit_first_hits)."""

import math

import torch

from .ops import (bvh as bvh_mod, denoiser, pallas_denoise, pallas_raster,
                  pallas_scatter, pallas_shade, pallas_tracer, tracer)

MIN_AGREE = 0.999
TRACE_SUBSET = 8192   # covered pixels the plain tracer is held to


def timed(fn):
    """(fn(), device milliseconds of that one call, by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_ms(fn, reps=10, warmup=1):
    """Mean device milliseconds per call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _close(a, b, atol, rtol):
    return (a - b).abs() <= atol + rtol * b.abs()


def check_resolve(v_clip, tri, H, W, prev_z, prev_id, reps=20):
    args = (v_clip, tri, H, W, prev_z, prev_id)
    z, tid = pallas_raster._resolve_cuda(*args)
    (zp, tidp), plain_ms = timed(lambda: pallas_raster.resolve_plain(*args))
    ids_differ = int((tid != tidp).sum())
    z_differ = int((z != zp).sum())
    return dict(
        name='resolve', agree=1.0 - ids_differ / tid.numel(),
        max_abs_err=float((z - zp).abs().max()), ids_differ=ids_differ,
        z_differ=z_differ, ok=ids_differ == 0 and z_differ == 0,
        ms=time_ms(lambda: pallas_raster._resolve_cuda(*args), reps),
        plain_ms=plain_ms)


def check_sample_guide(rows, cols, reps=20):
    args = (rows, cols)
    got = pallas_shade._sample_guide_cuda(*args)
    want = pallas_shade.sample_guide_plain(*args)
    differ = int((got != want).sum())
    return dict(
        name='sample_guide', agree=1.0 - differ / want.numel(),
        max_abs_err=float((got - want).abs().max()), ok=differ == 0,
        ms=time_ms(lambda: pallas_shade._sample_guide_cuda(*args), reps),
        plain_ms=time_ms(lambda: pallas_shade.sample_guide_plain(*args), 3))


# absolute error of a float32 sin(v pi) where v pi lies near pi: the
# product's rounding (an ulp of pi, 2.4e-7) and the sine's own
SIN_SLACK = 1e-6


def _light_pdf_terms(s, rows, cols, pdf_tex):
    """float64 terms of samples s [n, 16] whose 1 / sin(theta) the light
    map's pole rows amplify, each from the sample's own texels and
    direction: the light sample's pdf (its row and column CDF steps over
    sin(theta) = |xz| of its direction, as uv_to_dir makes it), the BSDF
    direction's light pdf (its texel's pdf over sin(acos(y))), and that
    term's slack where acos(y) lies near pi (SIN_SLACK over the sine)."""
    Hl, Wl = cols.shape
    c = Wl * Hl / (2.0 * math.pi * math.pi)
    rows64, cols64 = rows.double().reshape(-1), cols.double().reshape(-1)
    t = s[:, pallas_shade.S_LTEX].long()
    y, x = torch.div(t, Wl, rounding_mode='floor'), t % Wl
    pdf_row = rows64[y] - torch.where(
        y > 0, rows64[torch.clamp(y - 1, min=0)], 0.0)
    pdf_col = cols64[t] - torch.where(
        x > 0, cols64[torch.clamp(t - 1, min=0)], 0.0)
    d = s[:, pallas_shade.S_LDIR:pallas_shade.S_LDIR + 3].double()
    st = torch.clamp(torch.sqrt(d[:, 0] ** 2 + d[:, 2] ** 2), min=1e-4)
    lp = pdf_row * pdf_col * c / st
    dy = torch.clamp(s[:, pallas_shade.S_BDIR + 1].double(), -1.0, 1.0)
    sb = torch.clamp(torch.sin(pallas_shade.acos_poly(dy)), min=1e-4)
    blp = pdf_tex.double().reshape(-1)[s[:, pallas_shade.S_BTEX].long()] \
        * c / sb
    return lp, blp, torch.where(dy < 0.0, SIN_SLACK / sb, 0.0) * blp


def sample_bound(got, want, g8, rows, cols, pdf_tex):
    """The sample kernel's output got [n2, 16, P] against the plain
    version's want on the same pixels (g8 [8, P]: their G-buffer).
    Returns (the share of agreeing entries, the largest error over its
    bound, the max |got - want| on entries with the same texels, the
    count of entries held to the corrected pdfs, the largest error over
    its bound among them).  The light map's pole rows and the BSDF pdf's
    grazing cut get the corrected pdfs: see the module's docstring."""
    tex = pallas_shade.S_LTEX
    same_tex = (got[:, tex:tex + 2] == want[:, tex:tex + 2]).all(1)
    agree = same_tex & _close(got, want, 1e-4, 1e-4).all(1)    # [n2, P]
    share = float(agree.double().mean()) if agree.numel() else 1.0
    Hl, Wl = cols.shape
    row = torch.div(want[:, tex:tex + 2], Wl, rounding_mode='floor')
    pole = ((row == 0) | (row == Hl - 1)).any(1)                 # [n2, P]
    nrm = (g8[0], g8[1], g8[2])
    ndotv = pallas_shade.dot3(nrm, (g8[3], g8[4], g8[5]))

    def grazing(s):
        ldir = (s[:, 0], s[:, 1], s[:, 2])
        return torch.minimum(ndotv, pallas_shade.dot3(nrm, ldir))
    m_got = grazing(got)
    near = ((m_got < 1e-6) != (grazing(want) < 1e-6)) | \
        ((m_got - 1e-6).abs() < 1e-6)
    held = same_tex & (pole | near)
    plain = same_tex & ~held
    diff = (got - want).abs()
    err = float(torch.where(same_tex, diff.amax(1), 0.0).max()) \
        if diff.numel() else 0.0
    ratio = (diff / (1e-3 + 1e-3 * want.abs())).amax(1)         # [n2, P]
    bound = float(torch.where(plain, ratio, 0.0).max()) \
        if ratio.numel() else 0.0
    del diff, ratio
    n_held, held_bound = int(held.sum()), 0.0
    if n_held:
        Gh, Wh = got.permute(0, 2, 1)[held], want.permute(0, 2, 1)[held]
        pix = torch.nonzero(held)[:, 1]
        r = (Gh - Wh).abs() / (1e-3 + 1e-3 * Wh.abs())
        keep = torch.ones(16, dtype=torch.bool, device=r.device)
        keep[[pallas_shade.S_LPDF, pallas_shade.S_BPDF]] = False
        lp_g, blp_g, slack_g = _light_pdf_terms(Gh, rows, cols, pdf_tex)
        lp_w, blp_w, slack_w = _light_pdf_terms(Wh, rows, cols, pdf_tex)
        # the light sample's pdf: the plain value with its light-map term
        # taken at the kernel's direction, and, within 1e-6 of the grazing
        # cut, its BSDF term on either side of the cut
        L = pallas_shade.S_LDIR
        mix, m_w = pallas_shade.bsdf_pdf_mix(
            g8[7, pix], (g8[0, pix], g8[1, pix], g8[2, pix]),
            (g8[3, pix], g8[4, pix], g8[5, pix]),
            (Wh[:, L], Wh[:, L + 1], Wh[:, L + 2]), g8[6, pix])
        side_w = torch.where(m_w < 1e-6, 1.0, mix).double()
        base = (Wh[:, pallas_shade.S_LPDF].double() - side_w + lp_g - lp_w)
        cands = torch.stack([side_w, torch.ones_like(side_w), mix.double()])
        either = near[held]
        e6 = base[None] + cands
        r6 = (Gh[:, pallas_shade.S_LPDF].double() - e6).abs() \
            / (1e-3 + 1e-3 * e6.abs())
        r6 = torch.where(either, r6.min(0).values, r6[0])
        # the BSDF sample's pdf: its light-map term at the kernel's
        # direction
        e7 = Wh[:, pallas_shade.S_BPDF].double() + blp_g - blp_w
        r7 = (Gh[:, pallas_shade.S_BPDF].double() - e7).abs() \
            / (1e-3 + 1e-3 * e7.abs() + slack_g + slack_w)
        held_bound = max(float(r[:, keep].max()), float(r6.max()),
                         float(r7.max()))
    return share, max(bound, held_bound), err, n_held, held_bound


def check_sample(u8, gb8, rows, cols, guide, pdf_tex, base, n_samples_x,
                 mask=None, reps=20):
    """mask: bool [P] of covered pixels (None: all)."""
    args = (u8, gb8, rows, cols, guide, pdf_tex, base, n_samples_x)
    got = pallas_shade._sample_cuda(*args)
    want = pallas_shade.sample_all_plain(u8, gb8, rows, cols, pdf_tex, base,
                                         n_samples_x)
    g8 = gb8
    if mask is not None:
        got, want, g8 = got[:, :, mask], want[:, :, mask], gb8[:, mask]
    share, bound, err, n_held, held_bound = sample_bound(
        got, want, g8, rows, cols, pdf_tex)
    return dict(
        name='sample', agree=share, max_abs_err=err,
        err_over_bound=bound, ok=share >= MIN_AGREE and bound <= 1.0,
        compared_on='%d of %d pixels (covered); %d samples at a pole row or '
                    'the grazing cut held to the corrected pdfs (err/bound '
                    '%.3g there)' % (got.shape[2], u8.shape[2], n_held,
                                     held_bound),
        ms=time_ms(lambda: pallas_shade._sample_cuda(*args), reps),
        plain_ms=time_ms(lambda: pallas_shade.sample_all_plain(
            u8, gb8, rows, cols, pdf_tex, base, n_samples_x), 3))


def check_trace_shade(samp, gb, bvh, BSDF=0, tmin=0.0, reps=5):
    n2, _, P = samp.shape
    out, visw = pallas_shade._trace_shade_cuda(samp, gb, bvh, BSDF, tmin)
    covered = torch.nonzero(gb[pallas_shade.GB_MASK] > 0)[:, 0]
    stride = max(1, covered.numel() // TRACE_SUBSET)
    idx = covered[::stride][:TRACE_SUBSET]
    gb_s = gb[:, idx].contiguous()
    samp_s = samp[:, :, idx].contiguous()
    (out_p, visw_p), plain_ms = timed(lambda: pallas_shade.trace_shade_plain(
        samp_s, gb_s, bvh, BSDF, tmin))
    n = idx.numel()
    vk = torch.stack([visw[:, idx], visw[:, P + idx]], 1)      # [n2, 2, n]
    vp = torch.stack([visw_p[:, :n], visw_p[:, n:]], 1)
    bits = vk == vp
    share = float(bits.double().mean()) if n else 1.0
    pix_ok = bits.all(0).all(0)                                 # [n]
    ok_out = out[:, idx][:, pix_ok]
    ok_plain = out_p[:, pix_ok]
    err = float((ok_out - ok_plain).abs().max()) if bool(pix_ok.any()) else 0.0
    ok = share >= MIN_AGREE and bool(_close(ok_out, ok_plain, 1e-4,
                                            1e-4).all())
    return dict(
        name='trace_shade', agree=share, max_abs_err=err, ok=ok,
        compared_on='%d of %d pixels (%d rays)' % (n, P, 2 * n2 * n),
        ms=time_ms(lambda: pallas_shade._trace_shade_cuda(
            samp, gb, bvh, BSDF, tmin), reps),
        plain_ms=plain_ms)


def _check_denoise(name, cuda_fn, col, nrm, zdz, sigma, reps):
    got = cuda_fn(col, nrm, zdz, sigma)
    want = pallas_denoise.denoise_pair_plain(col, nrm, zdz, sigma)
    err = float((got - want).abs().max())
    close = _close(got, want, 1e-6, 1e-4)
    return dict(
        name=name, agree=float(close.double().mean()), max_abs_err=err,
        ok=bool(close.all()),
        ms=time_ms(lambda: cuda_fn(col, nrm, zdz, sigma), reps),
        plain_ms=time_ms(lambda: pallas_denoise.denoise_pair_plain(
            col, nrm, zdz, sigma), 2))


def check_denoise(col6, nrm, zdz, sigma, reps=20):
    return _check_denoise('denoise', pallas_denoise._denoise_cuda, col6, nrm,
                          zdz, sigma, reps)


def check_denoise_one(col3, nrm, zdz, sigma, reps=20):
    return _check_denoise('denoise_one', pallas_denoise._denoise_one_cuda,
                          col3, nrm, zdz, sigma, reps)


def _sum_bound(got, want, abs_sum, rel, floor=0.0):
    """Share of entries within, and the worst ratio to, the bound
    rel sum|terms| + floor (an entry with no terms must be 0)."""
    ratio = (got.double() - want.double()).abs() / (
        rel * abs_sum.double() + floor + 1e-300)
    return float((ratio <= 1.0).double().mean()), float(ratio.max())


def _sqrt_n_bound(count):
    return 1e-6 + 4.0 * count.double().sqrt() * 2.0 ** -24


def _flushed(count):
    """What float32 atomics may flush to zero in n adds: n 2^-126."""
    return count.double() * 2.0 ** -126


def _check_denoise_grad(name, cuda_fn, g, nrm, zdz, sigma, reps):
    C = g.shape[-1]
    got = cuda_fn(g, nrm, zdz, sigma)[..., :C]
    want = pallas_denoise.denoise_pair_plain(g, nrm, zdz, sigma, True)
    abs_sum = pallas_denoise.denoise_pair_plain(g.abs(), nrm, zdz, sigma,
                                                True)[..., :C]
    share, worst = _sum_bound(got, want[..., :C], abs_sum,
                              1e-5 + 529 * 2.0 ** -24)
    return dict(
        name=name, agree=share, err_over_bound=worst,
        max_abs_err=float((got - want[..., :C]).abs().max()),
        ok=worst <= 1.0,
        ms=time_ms(lambda: cuda_fn(g, nrm, zdz, sigma), reps),
        plain_ms=time_ms(lambda: pallas_denoise.denoise_pair_plain(
            g, nrm, zdz, sigma, True), 2))


def check_denoise_grad(g6, nrm, zdz, sigma, reps=20):
    return _check_denoise_grad('denoise_grad',
                               pallas_denoise._denoise_grad_cuda, g6, nrm,
                               zdz, sigma, reps)


def check_denoise_one_grad(g3, nrm, zdz, sigma, reps=20):
    return _check_denoise_grad('denoise_one_grad',
                               pallas_denoise._denoise_one_grad_cuda, g3,
                               nrm, zdz, sigma, reps)


def check_scatter(idx, vals, out_rows, reps=20, generic=False):
    """The row scatter (its generic instance with generic) against the
    float64 sum of the plain version."""
    got = pallas_scatter._scatter_cuda(idx, vals, out_rows, generic)
    exact = vals.double()
    want = pallas_scatter.scatter_add_plain(idx, exact, out_rows)
    abs_sum = pallas_scatter.scatter_add_plain(idx, exact.abs(), out_rows)
    count = pallas_scatter.scatter_add_plain(
        idx, torch.ones_like(exact[:, :1]), out_rows)
    share, worst = _sum_bound(got, want, abs_sum, _sqrt_n_bound(count),
                              _flushed(count))
    return dict(
        name='scatter', agree=share, err_over_bound=worst,
        max_abs_err=float((got - want).abs().max()), ok=worst <= 1.0,
        compared_on='%d rows x %d channels into %d' % (
            vals.shape[0], vals.shape[1], out_rows),
        ms=time_ms(lambda: pallas_scatter._scatter_cuda(
            idx, vals, out_rows, generic), reps),
        plain_ms=time_ms(lambda: pallas_scatter.scatter_add_plain(
            idx, vals, out_rows), reps))


def check_light_scatter(drad, Hl, Wl, reps=20):
    got = pallas_shade._light_scatter_cuda(drad, Hl, Wl)
    exact = drad.double()
    want = pallas_shade.light_scatter_plain(exact, Hl, Wl)
    absd = torch.cat([exact[:, 0:6].abs(), exact[:, 6:8]], 1)
    ones = torch.cat([torch.ones_like(exact[:, 0:6]), exact[:, 6:8]], 1)
    count = pallas_shade.light_scatter_plain(ones, Hl, Wl)
    share, worst = _sum_bound(
        got, want, pallas_shade.light_scatter_plain(absd, Hl, Wl),
        _sqrt_n_bound(count), _flushed(count))
    return dict(
        name='light_scatter', agree=share, err_over_bound=worst,
        max_abs_err=float((got - want).abs().max()), ok=worst <= 1.0,
        ms=time_ms(lambda: pallas_shade._light_scatter_cuda(drad, Hl, Wl),
                   reps),
        plain_ms=time_ms(lambda: pallas_shade.light_scatter_plain(
            drad, Hl, Wl), reps))


def check_shade_bwd(samp, gb, vw, g6, BSDF=0, sample_frac=None, reps=10):
    n2, _, P = samp.shape
    dgb, drad = pallas_shade._shade_bwd_cuda(samp, gb, vw, g6, BSDF,
                                             sample_frac)
    covered = torch.nonzero(gb[pallas_shade.GB_MASK] > 0)[:, 0]
    stride = max(1, covered.numel() // TRACE_SUBSET)
    idx = covered[::stride][:TRACE_SUBSET]
    sub = (samp[:, :, idx].contiguous(), gb[:, idx].contiguous(),
           torch.cat([vw[:, idx], vw[:, P + idx]], 1).contiguous(),
           g6[:, idx].contiguous())
    with torch.enable_grad():
        (dgb_p, drad_p), plain_ms = timed(
            lambda: pallas_shade.shade_bwd_plain(*sub, BSDF, sample_frac))
    got = torch.cat([dgb[:, idx], drad[:, 0:6, idx].reshape(-1, idx.numel())])
    want = torch.cat([dgb_p, drad_p[:, 0:6].reshape(-1, idx.numel())])
    err = (got - want).abs()
    row_max = want.abs().amax(1, keepdim=True)
    close = err <= 1e-4 * want.abs() + 1e-6 * row_max
    bound = float((err / (2e-2 * want.abs() + 1e-4 * row_max + 1e-30))
                  .max()) if err.numel() else 0.0
    ids_same = bool(torch.equal(drad[:, 6:8, idx], drad_p[:, 6:8]))
    share = float(close.double().mean()) if close.numel() else 1.0
    return dict(
        name='shade_bwd', agree=share,
        max_abs_err=float(err.max()) if err.numel() else 0.0,
        err_over_bound=bound,
        ok=share >= MIN_AGREE and bound <= 1.0 and ids_same,
        compared_on='%d of %d pixels' % (idx.numel(), P),
        ms=time_ms(lambda: pallas_shade._shade_bwd_cuda(
            samp, gb, vw, g6, BSDF, sample_frac), reps),
        plain_ms=plain_ms)


def check_trace(ro, rd, bvh, tmin=0.0, reps=5):
    got = pallas_tracer._trace_cuda(ro, rd, bvh, tmin)
    want, plain_ms = timed(lambda: tracer.any_hit(ro, rd, bvh, tmin=tmin))
    share = float((got == want).double().mean())
    return dict(
        name='trace', agree=share, max_abs_err=float(
            (got.float() - want.float()).abs().max()) if got.numel() else 0.0,
        ok=share == 1.0,
        compared_on='%d rays, %.4f occluded' % (ro.shape[0],
                                               float(want.float().mean())),
        ms=time_ms(lambda: pallas_tracer._trace_cuda(ro, rd, bvh, tmin),
                   reps),
        plain_ms=plain_ms)


def check_mask(rayf, aabb_lo, aabb_hi, ray_block, tmin, tmax, reps=10):
    args = (rayf, aabb_lo, aabb_hi, ray_block, tmin, tmax)
    got = pallas_tracer._mask_cuda(*args)
    want = pallas_tracer.visit_masks_plain(*args)
    share = float((got == want).double().mean())
    return dict(
        name='mask', agree=share,
        max_abs_err=float((got - want).abs().max()), ok=share == 1.0,
        compared_on='[%d, %d] mask, %.4f set' % (
            got.shape[0], got.shape[1], float(want.double().mean())),
        ms=time_ms(lambda: pallas_tracer._mask_cuda(*args), reps),
        plain_ms=time_ms(lambda: pallas_tracer.visit_masks_plain(*args), 2))


CHECKS = {'resolve': check_resolve, 'sample_guide': check_sample_guide,
          'sample': check_sample,
          'trace_shade': check_trace_shade, 'denoise': check_denoise,
          'denoise_grad': check_denoise_grad, 'denoise_one': check_denoise_one,
          'denoise_one_grad': check_denoise_one_grad,
          'shade_bwd': check_shade_bwd,
          'light_scatter': check_light_scatter, 'scatter': check_scatter,
          'trace': check_trace, 'mask': check_mask}
FORWARD = ('resolve', 'sample_guide', 'sample', 'trace_shade', 'denoise')
BACKWARD = ('denoise_grad', 'shade_bwd', 'light_scatter', 'scatter')
VALIDATE = ('trace', 'mask')
# the one-buffer denoiser (denoiser_demodulate false), off the default path
OPTIONS = ('denoise_one', 'denoise_one_grad')


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for each kernel's work
# ---------------------------------------------------------------------------

BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
SFU_PER_S = 16 * 132 * 1.98e9   # special-function results per second
# float operations per test, counted from the sources: a slab test is 2
# subtractions, 2 products, 4 min/max per axis and a compare; the Plücker
# triangle test 3 x 11 for the edges, 11 for num and den, 2 for tmin and
# 8 for the sign tests
SLAB_OPS = 25
TRI_OPS = 54
# per item, counted from the sources and rounded down: the BSDF and light
# sampling of one (stratum, pixel) (two CDF inversions, a cosine and a GGX
# sample, three pdfs); the guide tables' bucket and count of one CDF entry;
# the shading of one ray; its adjoint; one (pixel, tap)
# of the denoiser (weights of 3 factors and 7 accumulations) and its
# special functions (an ex2 and a reciprocal); one (pixel, triangle) inside
# test of the resolve; the resolve's setup of one triangle (adjugate,
# determinant, the 15 fields, the screen rectangle)
SAMPLE_OPS = 300
GUIDE_OPS = 4
SHADE_OPS = 100
SHADE_BWD_OPS = 300
TAP_OPS = 30
RESOLVE_OPS = 20
SETUP_OPS = 100
TAP_SFU = 2


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _walk_tests(o, d, rows, entered, tmin, pair_chunk=1 << 14):
    """Triangle tests [R] of a walk that visits the entered boxes of each
    ray in index order, `rows` [boxes, n, 24] each, and stops at the first
    hit, and whether the ray hit [R].  The walk of trace.cuh visits boxes
    in index order: supernodes hold consecutive leaves, leaves consecutive
    sub-boxes, and it tests each level in order."""
    R, n_box = entered.shape
    n = rows.shape[1]
    pr, pb = torch.nonzero(entered, as_tuple=True)
    hit_any, pos = [], []
    for p in range(0, pr.numel(), pair_chunk):
        h = tracer.tri_hits(o[pr[p:p + pair_chunk]], d[pr[p:p + pair_chunk]],
                            rows[pb[p:p + pair_chunk]], tmin)
        hit_any.append(h.any(1))
        pos.append(h.int().argmax(1))           # the first hit's row
    hit_any = torch.cat(hit_any) if hit_any else pr.bool()
    pos = torch.cat(pos) if pos else pr
    first = torch.full((R,), n_box, dtype=torch.long, device=o.device)
    first.scatter_reduce_(0, pr, torch.where(hit_any, pb, n_box), 'amin')
    count = torch.zeros(R, dtype=torch.long, device=o.device)
    count.index_add_(0, pr, (pb < first[pr]).long() * n)
    at = pb == first[pr]
    count.index_add_(0, pr[at], pos[at] + 1)
    return count, first < n_box


def trace_work(ro, rd, bvh, tmin=0.0, chunk=1 << 14):
    """The work of the walk on these rays, as a dict:

    - `walk_tris`: the triangle tests of the walk of trace.cuh, which
      visits the sub-boxes it enters in order and stops at the first hit;
      `walk_tris_two_level` the same when every leaf entered costs all its
      L triangles (the walk before the sub-box level);
    - `slabs` and `tris`: the box and triangle tests that any walk of this
      structure needs (the bound's count): a ray that hits nothing tests
      every supernode box, the leaf boxes of the supernodes it enters, the
      sub-boxes of the leaves it enters and the triangles of the sub-boxes
      it enters; a ray that hits needs at least one box of each level and
      the triangle of one hit; `tris_two_level` the same with whole
      leaves."""
    C, S = bvh.n_leaves, bvh.super_lo.shape[0]
    L, G = bvh.leaf_size, bvh.sub_size
    per_super = torch.clamp(C - bvh_mod.SUPER * torch.arange(
        S, device=ro.device), max=bvh_mod.SUPER).double()
    sub_rows = bvh.tri.reshape(-1, G, bvh.tri.shape[-1])
    leaf_rows = bvh.tri.reshape(C, L, bvh.tri.shape[-1])
    work = dict(slabs=0, tris=0, tris_two_level=0, walk_tris=0,
                walk_tris_two_level=0)
    for s in range(0, ro.shape[0], chunk):
        o, d = ro[s:s + chunk], rd[s:s + chunk]
        inv = 1.0 / d
        sup = tracer.slab_hits(o, inv, bvh.super_lo, bvh.super_hi, tmin)
        leaves = (tracer.slab_hits(o, inv, bvh.aabb_lo, bvh.aabb_hi, tmin)
                  & sup.repeat_interleave(bvh_mod.SUPER, 1)[:, :C])
        subs = tracer.entered(o, d, bvh, tmin)
        walk, hit = _walk_tests(o, d, sub_rows, subs, tmin)
        walk2, _ = _walk_tests(o, d, leaf_rows, leaves, tmin)
        miss = ~hit
        n_hit = int(hit.sum())
        n_leaves = int(leaves[miss].sum())
        work['walk_tris'] += int(walk.sum())
        work['walk_tris_two_level'] += int(walk2.sum())
        work['slabs'] += (int(miss.sum()) * S
                          + int((sup[miss].double() @ per_super).sum())
                          + n_leaves * (L // G) + 3 * n_hit)
        work['tris'] += int(subs[miss].sum()) * G + n_hit
        work['tris_two_level'] += n_leaves * L + n_hit
    return work


def _walk_tensors(bvh):
    """What the walk reads of the structure: triangle rows and boxes."""
    return (bvh.tri, bvh.aabb_lo, bvh.aabb_hi, bvh.super_lo, bvh.super_hi,
            bvh.sub_lo, bvh.sub_hi)


def _bound_of(nbytes, ops, sfu=0):
    t_bytes = nbytes / BYTES_PER_S
    t_ops = max(ops / F32_PER_S, sfu / SFU_PER_S)
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bound_bytes=nbytes, bound_ops=ops, bound_sfu=sfu)


def resolve_pairs(v_clip, tri, H, W, prev_z, prev_id):
    """The (pixel, triangle) pairs of the resolve's atomics, summed over
    the batch (pallas_raster.covered_pairs)."""
    n = 0
    for b in range(v_clip.shape[0]):
        n += pallas_raster.covered_pairs(
            pallas_raster._tri_coefs(v_clip[b], tri),
            pallas_raster._tri_rects(v_clip[b], tri, H, W), H, W, prev_z[b],
            prev_id[b])[0].numel()
    return n


def denoise_taps(N, H, W, sigma):
    """(pixel, tap) pairs inside the image and the dynamic radius."""
    r = min(denoiser._max_radius(), int(2 * math.ceil(sigma * 2.5) + 1))

    def per_axis(n):
        i = torch.arange(n)
        return int((torch.clamp(i, max=r) + torch.clamp(n - 1 - i, max=r)
                    + 1).sum())
    return N * per_axis(H) * per_axis(W)


def bound(name, args):
    """The bound of kernel `name` on the arguments a Recorder took (or the
    check was given); see the module docstring."""
    if name == 'resolve':
        v_clip, tri, H, W, pz, pid = args
        N = pz.shape[0]
        pairs = resolve_pairs(*args)
        return dict(_bound_of(
            _nbytes(v_clip, tri, pz, pid) + N * H * W * 8,
            SETUP_OPS * N * tri.shape[0] + RESOLVE_OPS * (pairs + N * H * W)),
            pairs=pairs)
    if name == 'sample_guide':
        rows, cols = args
        entries = cols.numel() + rows.numel()
        return _bound_of(_nbytes(rows, cols) + (entries + rows.numel() + 1)
                         * 4, GUIDE_OPS * entries)
    if name == 'sample':
        u8, gb8, rows, cols, guide, pdf, base, n = args
        n2, _, P = u8.shape
        return _bound_of(_nbytes(u8, gb8, rows, cols, guide, pdf, base)
                         + n2 * 16 * P * 4, SAMPLE_OPS * n2 * P)
    if name == 'trace_shade':
        samp, gb, bvh = args[:3]
        n2, _, P = samp.shape
        covered = gb[pallas_shade.GB_MASK] > 0
        ro = gb[0:3].T[covered].contiguous()
        work = dict(rays=0)
        for s in range(n2):
            for k in (pallas_shade.S_LDIR, pallas_shade.S_BDIR):
                rd = samp[s, k:k + 3].T[covered].contiguous()
                for key, v in trace_work(ro, rd, bvh).items():
                    work[key] = work.get(key, 0) + v
                work['rays'] += ro.shape[0]
        ops = (SLAB_OPS * work['slabs'] + TRI_OPS * work['tris']
               + SHADE_OPS * 2 * n2 * int(covered.sum()))
        return dict(_bound_of(_nbytes(samp, gb, *_walk_tensors(bvh))
                              + (12 * P + 2 * n2 * P) * 4, ops), **work)
    if name in ('denoise', 'denoise_grad', 'denoise_one',
                'denoise_one_grad'):
        col, nrm, zdz, sigma = args
        N, H, W, C = col.shape
        taps = denoise_taps(N, H, W, sigma)
        return dict(_bound_of(_nbytes(col, nrm, zdz)
                              + N * H * W * (C + 1) * 4,
                              TAP_OPS * taps, TAP_SFU * taps), taps=taps)
    if name == 'shade_bwd':
        samp, gb, vw, g6 = args[:4]
        n2, _, P = samp.shape
        covered = int((gb[pallas_shade.GB_MASK] > 0).sum())
        return _bound_of(_nbytes(samp, gb, vw, g6) + (15 + n2 * 8) * P * 4,
                         SHADE_BWD_OPS * 2 * n2 * covered)
    if name == 'light_scatter':
        drad, Hl, Wl = args
        return _bound_of(_nbytes(drad) + Hl * Wl * 3 * 4,
                         int((drad[:, 0:6] != 0).sum()))
    if name == 'scatter':
        idx, vals, out_rows = args
        return _bound_of(_nbytes(idx, vals) + out_rows * vals.shape[1] * 4,
                         int((vals != 0).sum()))
    if name == 'trace':
        ro, rd, bvh = args[:3]
        work = trace_work(ro, rd, bvh, *args[3:])
        return dict(_bound_of(_nbytes(ro, rd, *_walk_tensors(bvh))
                              + ro.shape[0], SLAB_OPS * work['slabs']
                              + TRI_OPS * work['tris']),
                    rays=ro.shape[0], **work)
    if name == 'mask':
        rayf, aabb_lo, aabb_hi, ray_block = args[:4]
        first = pallas_tracer.visit_first_hits(*args)
        unset = first == ray_block
        # a block's unset leaf needs every ray tested, a set one at least one
        tests = int(unset.sum()) * ray_block + int((~unset).sum())
        rays = int(torch.where(unset.any(1), ray_block,
                               first.amax(1) + 1).sum())
        return dict(_bound_of(rays * rayf.shape[1] * rayf.element_size()
                              + _nbytes(aabb_lo, aabb_hi) + first.numel() * 4,
                              SLAB_OPS * tests), rays_needed=rays)
    raise KeyError(name)


def library_ms(name, args, reps=20):
    """Time of the one PyTorch call that computes kernel `name`'s function
    (index_add_ for the two scatters; for the guide tables, searchsorted of
    the bucket edges arange(K + 1) into each CDF scaled by K, one call for
    the column CDFs and one for the row CDF, which equals the guide where
    the CDF is non-decreasing, as the sampler assumes, but for each table's
    last entry where v K reaches K), or None where there is none.  Used as
    a yardstick only; the port never calls it on the card."""
    if name == 'scatter':
        idx, vals, out_rows = args
        out = torch.zeros((out_rows, vals.shape[1]), device=vals.device)
        return time_ms(lambda: out.index_add_(0, idx, vals), reps)
    if name == 'light_scatter':
        drad, Hl, Wl = args
        tex = torch.cat([drad[:, 6], drad[:, 7]]).long().reshape(-1)
        gr = torch.cat([drad[:, 0:3], drad[:, 3:6]]).permute(0, 2, 1)
        gr = gr.reshape(-1, 3).contiguous()
        out = torch.zeros((Hl * Wl, 3), device=drad.device)
        return time_ms(lambda: out.index_add_(0, tex, gr), reps)
    if name == 'sample_guide':
        pairs = guide_search_args(*args)
        return time_ms(lambda: [torch.searchsorted(c, e, out_int32=True)
                                for c, e in pairs], reps)
    return None


def guide_search_args(rows, cols):
    """(CDFs scaled by K, bucket edges arange(K + 1)) for the column CDFs
    and the row CDF of a light: the arguments of the guide's searchsorted
    yardstick."""
    Hl, Wl = cols.shape
    dev = cols.device
    return (((cols * float(Wl)).contiguous(),
             torch.arange(Wl + 1, dtype=torch.float32, device=dev)
             .expand(Hl, Wl + 1).contiguous()),
            ((rows[None] * float(Hl)).contiguous(),
             torch.arange(Hl + 1, dtype=torch.float32, device=dev)[None]))


def run(name, recorded, **kw):
    """Run the check of kernel `name` on the arguments a Recorder took;
    the sample check reads the coverage mask from trace_shade's G-buffer."""
    if name == 'sample':
        kw['mask'] = recorded['trace_shade'][1][pallas_shade.GB_MASK] > 0
    return CHECKS[name](*recorded[name], **kw)


def run_launches(name, each, **kw):
    """The check of kernel `name` on each of its launches that a
    Recorder(every=1) took, in launch order (one per depth-peel layer
    for the per-layer kernels: a step launches layer 0's first).  The
    sample kernel's forward launch i is checked on the pixels that
    trace_shade's launch i covers (its replays in the backward repeat the
    forward launches)."""
    out = []
    for i, args in enumerate(each[name]):
        if name == 'sample':
            if i >= len(each['trace_shade']):
                break
            kw['mask'] = each['trace_shade'][i][1][pallas_shade.GB_MASK] > 0
        out.append(CHECKS[name](*args, **kw))
    return out

@torch.no_grad()
def check_decorrelated_backward(each, reps=5):
    """The launches of one decorrelated step on the fused path (one layer)
    that a Recorder(every=1) took: the sampler's second launch (the
    backward's) must read uniforms other than its first's (the
    forward's), and it, the second trace + shade launch (the backward's
    trace, on those samples), shade_bwd and the light scatter are each
    held against their plain versions with their own tolerances.
    Returns (kernel name -> result, the share of the five uniform rows
    that differ between the two launches)."""
    u_f, u_b = each['sample'][0][0], each['sample'][1][0]
    differ = float((u_f[:, 0:5] != u_b[:, 0:5]).double().mean())
    mask = each['trace_shade'][1][1][pallas_shade.GB_MASK] > 0
    return {'sample': check_sample(*each['sample'][1], mask=mask, reps=reps),
            'trace_shade': check_trace_shade(*each['trace_shade'][1],
                                             reps=reps),
            'shade_bwd': check_shade_bwd(*each['shade_bwd'][0], reps=reps),
            'light_scatter': check_light_scatter(
                *each['light_scatter'][0], reps=reps)}, differ


@torch.no_grad()
def check_loop_strata(each, reps=3):
    """The stratum loop's backward launches that a Recorder took over the
    backward alone (per stratum: sample, trace, shade_bwd, light scatter;
    the i-th recorded launch of each kernel is one stratum's), each held
    against its plain version with its own tolerance, the sample kernel
    on the pixels that stratum's shade_bwd G-buffer covers.  Returns
    kernel name -> list of results, one per recorded stratum."""
    out = {k: [] for k in ('sample', 'trace', 'shade_bwd', 'light_scatter')}
    for i, args in enumerate(each['shade_bwd']):
        mask = args[1][pallas_shade.GB_MASK] > 0
        out['sample'].append(check_sample(*each['sample'][i], mask=mask,
                                          reps=reps))
        out['trace'].append(check_trace(*each['trace'][i], reps=reps))
        out['shade_bwd'].append(check_shade_bwd(*args, reps=reps))
        out['light_scatter'].append(check_light_scatter(
            *each['light_scatter'][i], reps=reps))
    return out


# kernel name -> (source, TPU kernel it replaces)
SOURCES = {
    'resolve': ('nvdiffrecmc_tpu_torch/csrc/resolve.cu',
                'nvdiffrecmc_tpu/ops/pallas_raster.py:148'),
    'sample_guide': ('nvdiffrecmc_tpu_torch/csrc/sample.cu',
                     'nvdiffrecmc_tpu/ops/pallas_shade.py:354'),
    'sample': ('nvdiffrecmc_tpu_torch/csrc/sample.cu',
               'nvdiffrecmc_tpu/ops/pallas_shade.py:354'),
    'trace_shade': ('nvdiffrecmc_tpu_torch/csrc/shade.cu',
                    'nvdiffrecmc_tpu/ops/pallas_shade.py:568'),
    'denoise': ('nvdiffrecmc_tpu_torch/csrc/denoise.cu',
                'nvdiffrecmc_tpu/ops/pallas_denoise.py:47'),
    'denoise_grad': ('nvdiffrecmc_tpu_torch/csrc/denoise.cu',
                     'nvdiffrecmc_tpu/ops/pallas_denoise.py:47'),
    # no TPU kernel: the JAX package denoises the modulated color in jnp
    'denoise_one': ('nvdiffrecmc_tpu_torch/csrc/denoise.cu',
                    'nvdiffrecmc_tpu/ops/denoiser.py:94'),
    'denoise_one_grad': ('nvdiffrecmc_tpu_torch/csrc/denoise.cu',
                         'nvdiffrecmc_tpu/ops/denoiser.py:94'),
    'shade_bwd': ('nvdiffrecmc_tpu_torch/csrc/shade_bwd.cu',
                  'nvdiffrecmc_tpu/ops/pallas_shade.py:723'),
    'light_scatter': ('nvdiffrecmc_tpu_torch/csrc/light_scatter.cu',
                      'nvdiffrecmc_tpu/ops/pallas_shade.py:777'),
    'scatter': ('nvdiffrecmc_tpu_torch/csrc/scatter.cu',
                'nvdiffrecmc_tpu/ops/pallas_scatter.py:45'),
    'trace': ('nvdiffrecmc_tpu_torch/csrc/trace.cu',
              'nvdiffrecmc_tpu/ops/pallas_tracer.py:189'),
    'mask': ('nvdiffrecmc_tpu_torch/csrc/mask.cu',
             'nvdiffrecmc_tpu/ops/pallas_tracer.py:94'),
}


class Recorder:
    """Context manager that records the arguments of the first launch of
    each kernel wrapper while the main path runs (the launch itself goes
    through unchanged); for the row scatter, which runs once per gather,
    the launch with the most updates (the texture pyramid's adjoint) under
    'scatter', and every launch, in order, under 'scatter_all'.  every:
    also keep every every-th launch of each kernel (launches 0, every,
    2 every, ...; 1 for all of them), in order, in `each` (name -> list of
    arguments; it holds their tensors alive)."""

    _TARGETS = ((pallas_raster, '_resolve_cuda', 'resolve'),
                (pallas_shade, '_sample_guide_cuda', 'sample_guide'),
                (pallas_shade, '_sample_cuda', 'sample'),
                (pallas_shade, '_trace_shade_cuda', 'trace_shade'),
                (pallas_denoise, '_denoise_cuda', 'denoise'),
                (pallas_denoise, '_denoise_grad_cuda', 'denoise_grad'),
                (pallas_denoise, '_denoise_one_cuda', 'denoise_one'),
                (pallas_denoise, '_denoise_one_grad_cuda', 'denoise_one_grad'),
                (pallas_shade, '_shade_bwd_cuda', 'shade_bwd'),
                (pallas_shade, '_light_scatter_cuda', 'light_scatter'),
                (pallas_scatter, '_scatter_cuda', 'scatter'),
                (pallas_tracer, '_trace_cuda', 'trace'),
                (pallas_tracer, '_mask_cuda', 'mask'))

    def __init__(self, every=0):
        self.args = {'scatter_all': []}
        self.every = every
        self.each = {name: [] for _, _, name in self._TARGETS}
        self._count = dict.fromkeys(self.each, 0)
        self._saved = []

    def __enter__(self):
        for mod, attr, name in self._TARGETS:
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))

            def wrapped(*a, _orig=orig, _name=name):
                old = self.args.get(_name)
                if old is None or (_name == 'scatter'
                                   and a[1].numel() > old[1].numel()):
                    self.args[_name] = a
                if _name == 'scatter':
                    self.args['scatter_all'].append(a)
                if self.every and self._count[_name] % self.every == 0:
                    self.each[_name].append(a)
                self._count[_name] += 1
                return _orig(*a)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        return False
