"""Hold each CUDA kernel against its plain PyTorch version on the same CUDA
inputs, and time both.  Used by chip_smoke.py and by the GPU tests.

Tolerances, with their reasons:
- resolve: triangle ids equal on >= 99.9% of pixels (the fields are computed
  in the same order; only ties at shared edges may differ), depth |err|
  <= 1e-6 where they agree.
- sample, on covered pixels only (the shading multiplies masked pixels by
  zero, and their zero normals give arbitrary directions): >= 99.9% of the
  (stratum, pixel) entries agree, with the same texel ids and all 16
  values within 1e-4 + 1e-4 |x|; every entry whose texel ids agree lies
  within 1e-3 + 1e-3 |x|.  The rest differ in the last ulps of
  sin/acos/rsqrt, amplified where a direction grazes a pole of the
  lat-long map (the pdf's 1/sin(theta)), lies on a texel border, or
  follows a sharp GGX lobe.
- trace_shade: visibility bits equal on >= 99.9% of rays; shading within
  1e-4 + 1e-4 |x| on pixels whose rays all agree.  The plain tracer runs
  on an evenly spaced subset of the covered pixels, against the full mesh.
- denoise: within 1e-4 |x| + 1e-6 (exp and pow of two libraries, summed
  over 529 taps).
- denoise_grad: each entry is a sum of n = 529 taps whose weights both
  versions compute in float32 (exp and pow of two libraries) and add in
  another order: within (1e-5 + n 2^-24) times the sum of the absolute
  values of its terms, the rounding bound of a float32 sum in any order,
  widened by 1e-5 for the weights.
- scatter, light_scatter: the kernel adds the same float32 terms as the
  plain version in the order its atomics land, so each entry is held to
  the float64 sum of its n terms within (1e-6 + 4 sqrt(n) 2^-24) times
  the sum of their absolute values: a float32 sum in a random order errs
  by ~sqrt(n/3) 2^-24 of that at most in the mean, and a lost or doubled
  term moves the entry by the term itself.
- shade_bwd, on an evenly spaced subset of the covered pixels (the plain
  version is autograd over every stratum): >= 99.9% of the entries within
  1e-4 |x| + 1e-6 max|x| of their row, every entry within 2e-2 |x| +
  1e-4 max|x|.  The wide bound is the GGX D term at roughness 0.08
  (alpha^2 = 4.1e-5), whose denominator 1 - c^2 (1 - alpha^2) cancels to
  that size; the CPU tests measured ~1% between the JAX package and the
  port there."""

import torch

from .ops import pallas_denoise, pallas_raster, pallas_scatter, pallas_shade

MIN_AGREE = 0.999
TRACE_SUBSET = 8192   # covered pixels the plain tracer is held to


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


def check_resolve(coef, bbox, H, W, prev_z, prev_id, reps=20):
    z, tid = pallas_raster._resolve_cuda(coef, bbox, H, W, prev_z, prev_id)
    zp, tidp = pallas_raster.resolve_batch_plain(coef, H, W, prev_z, prev_id)
    agree = tid == tidp
    err = float((z - zp).abs()[agree].max()) if bool(agree.any()) else 0.0
    share = float(agree.double().mean())
    return dict(
        name='resolve', agree=share, max_abs_err=err,
        ok=share >= MIN_AGREE and err <= 1e-6,
        ms=time_ms(lambda: pallas_raster._resolve_cuda(
            coef, bbox, H, W, prev_z, prev_id), reps),
        plain_ms=time_ms(lambda: pallas_raster.resolve_batch_plain(
            coef, H, W, prev_z, prev_id), 2))


def check_sample(u8, gb8, rows, cols, pdf_tex, base, n_samples_x, mask=None,
                 reps=20):
    """mask: bool [P] of covered pixels (None: all)."""
    args = (u8, gb8, rows, cols, pdf_tex, base, n_samples_x)
    got = pallas_shade._sample_cuda(*args)
    want = pallas_shade.sample_all_plain(*args)
    if mask is not None:
        got, want = got[:, :, mask], want[:, :, mask]
    tex = pallas_shade.S_LTEX
    same_tex = (got[:, tex:tex + 2] == want[:, tex:tex + 2]).all(1)
    agree = same_tex & _close(got, want, 1e-4, 1e-4).all(1)    # [n2, P]
    share = float(agree.double().mean())
    err = (got - want).abs().permute(0, 2, 1)[same_tex]         # [n, 16]
    ratio = err / (1e-3 + 1e-3 * want.abs().permute(0, 2, 1)[same_tex])
    bound = float(ratio.max()) if ratio.numel() else 0.0
    return dict(
        name='sample', agree=share,
        max_abs_err=float(err.max()) if err.numel() else 0.0,
        err_over_bound=bound, ok=share >= MIN_AGREE and bound <= 1.0,
        compared_on='%d of %d pixels (covered)' % (got.shape[2],
                                                   u8.shape[2]),
        ms=time_ms(lambda: pallas_shade._sample_cuda(*args), reps),
        plain_ms=time_ms(lambda: pallas_shade.sample_all_plain(*args), 3))


def check_trace_shade(samp, gb, bvh, BSDF=0, tmin=0.0, reps=5):
    n2, _, P = samp.shape
    out, visw = pallas_shade._trace_shade_cuda(samp, gb, bvh, BSDF, tmin)
    covered = torch.nonzero(gb[pallas_shade.GB_MASK] > 0)[:, 0]
    stride = max(1, covered.numel() // TRACE_SUBSET)
    idx = covered[::stride][:TRACE_SUBSET]
    gb_s = gb[:, idx].contiguous()
    samp_s = samp[:, :, idx].contiguous()
    out_p, visw_p = pallas_shade.trace_shade_plain(samp_s, gb_s, bvh, BSDF,
                                                   tmin)
    n = idx.numel()
    vk = torch.stack([visw[:, idx], visw[:, P + idx]], 1)      # [n2, 2, n]
    vp = torch.stack([visw_p[:, :n], visw_p[:, n:]], 1)
    bits = vk == vp
    share = float(bits.double().mean())
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
        plain_ms=time_ms(lambda: pallas_shade.trace_shade_plain(
            samp_s, gb_s, bvh, BSDF, tmin), 1, warmup=0))


def check_denoise(col6, nrm, zdz, sigma, reps=20):
    got = pallas_denoise._denoise_cuda(col6, nrm, zdz, sigma)
    want = pallas_denoise.denoise_pair_plain(col6, nrm, zdz, sigma)
    err = float((got - want).abs().max())
    close = _close(got, want, 1e-6, 1e-4)
    return dict(
        name='denoise', agree=float(close.double().mean()), max_abs_err=err,
        ok=bool(close.all()),
        ms=time_ms(lambda: pallas_denoise._denoise_cuda(col6, nrm, zdz,
                                                        sigma), reps),
        plain_ms=time_ms(lambda: pallas_denoise.denoise_pair_plain(
            col6, nrm, zdz, sigma), 2))


def _sum_bound(got, want, abs_sum, rel):
    """Share of entries within, and the worst ratio to, the bound
    rel sum|terms| (an entry with no terms must be 0)."""
    ratio = (got.double() - want.double()).abs() / (
        rel * abs_sum.double() + 1e-300)
    return float((ratio <= 1.0).double().mean()), float(ratio.max())


def _sqrt_n_bound(count):
    return 1e-6 + 4.0 * count.double().sqrt() * 2.0 ** -24


def check_denoise_grad(g6, nrm, zdz, sigma, reps=20):
    got = pallas_denoise._denoise_grad_cuda(g6, nrm, zdz, sigma)[..., :6]
    want = pallas_denoise.denoise_pair_plain(g6, nrm, zdz, sigma, True)
    abs_sum = pallas_denoise.denoise_pair_plain(g6.abs(), nrm, zdz, sigma,
                                                True)[..., :6]
    share, worst = _sum_bound(got, want[..., :6], abs_sum,
                              1e-5 + 529 * 2.0 ** -24)
    return dict(
        name='denoise_grad', agree=share, err_over_bound=worst,
        max_abs_err=float((got - want[..., :6]).abs().max()),
        ok=worst <= 1.0,
        ms=time_ms(lambda: pallas_denoise._denoise_grad_cuda(
            g6, nrm, zdz, sigma), reps),
        plain_ms=time_ms(lambda: pallas_denoise.denoise_pair_plain(
            g6, nrm, zdz, sigma, True), 2))


def check_scatter(idx, vals, out_rows, reps=20):
    got = pallas_scatter._scatter_cuda(idx, vals, out_rows)
    exact = vals.double()
    want = pallas_scatter.scatter_add_plain(idx, exact, out_rows)
    abs_sum = pallas_scatter.scatter_add_plain(idx, exact.abs(), out_rows)
    count = pallas_scatter.scatter_add_plain(
        idx, torch.ones_like(exact[:, :1]), out_rows)
    share, worst = _sum_bound(got, want, abs_sum, _sqrt_n_bound(count))
    return dict(
        name='scatter', agree=share, err_over_bound=worst,
        max_abs_err=float((got - want).abs().max()), ok=worst <= 1.0,
        compared_on='%d rows x %d channels into %d' % (
            vals.shape[0], vals.shape[1], out_rows),
        ms=time_ms(lambda: pallas_scatter._scatter_cuda(idx, vals, out_rows),
                   reps),
        plain_ms=time_ms(lambda: pallas_scatter.scatter_add_plain(
            idx, vals, out_rows), reps))


def check_light_scatter(drad, Hl, Wl, reps=20):
    got = pallas_shade._light_scatter_cuda(drad, Hl, Wl)
    exact = drad.double()
    want = pallas_shade.light_scatter_plain(exact, Hl, Wl)
    absd = torch.cat([exact[:, 0:6].abs(), exact[:, 6:8]], 1)
    ones = torch.cat([torch.ones_like(exact[:, 0:6]), exact[:, 6:8]], 1)
    share, worst = _sum_bound(
        got, want, pallas_shade.light_scatter_plain(absd, Hl, Wl),
        _sqrt_n_bound(pallas_shade.light_scatter_plain(ones, Hl, Wl)))
    return dict(
        name='light_scatter', agree=share, err_over_bound=worst,
        max_abs_err=float((got - want).abs().max()), ok=worst <= 1.0,
        ms=time_ms(lambda: pallas_shade._light_scatter_cuda(drad, Hl, Wl),
                   reps),
        plain_ms=time_ms(lambda: pallas_shade.light_scatter_plain(
            drad, Hl, Wl), reps))


def check_shade_bwd(samp, gb, vw, g6, BSDF=0, reps=10):
    n2, _, P = samp.shape
    dgb, drad = pallas_shade._shade_bwd_cuda(samp, gb, vw, g6, BSDF)
    covered = torch.nonzero(gb[pallas_shade.GB_MASK] > 0)[:, 0]
    stride = max(1, covered.numel() // TRACE_SUBSET)
    idx = covered[::stride][:TRACE_SUBSET]
    sub = (samp[:, :, idx].contiguous(), gb[:, idx].contiguous(),
           torch.cat([vw[:, idx], vw[:, P + idx]], 1).contiguous(),
           g6[:, idx].contiguous())
    with torch.enable_grad():
        dgb_p, drad_p = pallas_shade.shade_bwd_plain(*sub, BSDF)
    got = torch.cat([dgb[:, idx], drad[:, 0:6, idx].reshape(-1, idx.numel())])
    want = torch.cat([dgb_p, drad_p[:, 0:6].reshape(-1, idx.numel())])
    err = (got - want).abs()
    row_max = want.abs().amax(1, keepdim=True)
    close = err <= 1e-4 * want.abs() + 1e-6 * row_max
    bound = float((err / (2e-2 * want.abs() + 1e-4 * row_max + 1e-30))
                  .max())
    ids_same = bool(torch.equal(drad[:, 6:8, idx], drad_p[:, 6:8]))
    share = float(close.double().mean())
    return dict(
        name='shade_bwd', agree=share, max_abs_err=float(err.max()),
        err_over_bound=bound,
        ok=share >= MIN_AGREE and bound <= 1.0 and ids_same,
        compared_on='%d of %d pixels' % (idx.numel(), P),
        ms=time_ms(lambda: pallas_shade._shade_bwd_cuda(samp, gb, vw, g6,
                                                        BSDF), reps),
        plain_ms=time_ms(lambda: pallas_shade.shade_bwd_plain(*sub, BSDF),
                         1, warmup=0))


CHECKS = {'resolve': check_resolve, 'sample': check_sample,
          'trace_shade': check_trace_shade, 'denoise': check_denoise,
          'denoise_grad': check_denoise_grad, 'shade_bwd': check_shade_bwd,
          'light_scatter': check_light_scatter, 'scatter': check_scatter}
FORWARD = ('resolve', 'sample', 'trace_shade', 'denoise')
BACKWARD = ('denoise_grad', 'shade_bwd', 'light_scatter', 'scatter')


def run(name, recorded, **kw):
    """Run the check of kernel `name` on the arguments a Recorder took;
    the sample check reads the coverage mask from trace_shade's G-buffer."""
    if name == 'sample':
        kw['mask'] = recorded['trace_shade'][1][pallas_shade.GB_MASK] > 0
    return CHECKS[name](*recorded[name], **kw)

# kernel name -> (source, TPU kernel it replaces)
SOURCES = {
    'resolve': ('nvdiffrecmc_tpu_torch/csrc/resolve.cu',
                'nvdiffrecmc_tpu/ops/pallas_raster.py:148'),
    'sample': ('nvdiffrecmc_tpu_torch/csrc/sample.cu',
               'nvdiffrecmc_tpu/ops/pallas_shade.py:354'),
    'trace_shade': ('nvdiffrecmc_tpu_torch/csrc/shade.cu',
                    'nvdiffrecmc_tpu/ops/pallas_shade.py:568'),
    'denoise': ('nvdiffrecmc_tpu_torch/csrc/denoise.cu',
                'nvdiffrecmc_tpu/ops/pallas_denoise.py:47'),
    'denoise_grad': ('nvdiffrecmc_tpu_torch/csrc/denoise.cu',
                     'nvdiffrecmc_tpu/ops/pallas_denoise.py:47'),
    'shade_bwd': ('nvdiffrecmc_tpu_torch/csrc/shade_bwd.cu',
                  'nvdiffrecmc_tpu/ops/pallas_shade.py:723'),
    'light_scatter': ('nvdiffrecmc_tpu_torch/csrc/light_scatter.cu',
                      'nvdiffrecmc_tpu/ops/pallas_shade.py:777'),
    'scatter': ('nvdiffrecmc_tpu_torch/csrc/scatter.cu',
                'nvdiffrecmc_tpu/ops/pallas_scatter.py:45'),
}


class Recorder:
    """Context manager that records the arguments of the first launch of
    each kernel wrapper while the main path runs (the launch itself goes
    through unchanged); for the row scatter, which runs once per gather,
    the launch with the most updates (the texture pyramid's adjoint)."""

    _TARGETS = ((pallas_raster, '_resolve_cuda', 'resolve'),
                (pallas_shade, '_sample_cuda', 'sample'),
                (pallas_shade, '_trace_shade_cuda', 'trace_shade'),
                (pallas_denoise, '_denoise_cuda', 'denoise'),
                (pallas_denoise, '_denoise_grad_cuda', 'denoise_grad'),
                (pallas_shade, '_shade_bwd_cuda', 'shade_bwd'),
                (pallas_shade, '_light_scatter_cuda', 'light_scatter'),
                (pallas_scatter, '_scatter_cuda', 'scatter'))

    def __init__(self):
        self.args = {}
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
                return _orig(*a)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        return False

