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
    zp, tidp = pallas_raster.resolve_plain(*args)
    ids_differ = int((tid != tidp).sum())
    z_differ = int((z != zp).sum())
    return dict(
        name='resolve', agree=1.0 - ids_differ / tid.numel(),
        max_abs_err=float((z - zp).abs().max()), ids_differ=ids_differ,
        z_differ=z_differ, ok=ids_differ == 0 and z_differ == 0,
        ms=time_ms(lambda: pallas_raster._resolve_cuda(*args), reps),
        plain_ms=time_ms(lambda: pallas_raster.resolve_plain(*args), 2))


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


def check_sample(u8, gb8, rows, cols, guide, pdf_tex, base, n_samples_x,
                 mask=None, reps=20):
    """mask: bool [P] of covered pixels (None: all)."""
    args = (u8, gb8, rows, cols, guide, pdf_tex, base, n_samples_x)
    got = pallas_shade._sample_cuda(*args)
    want = pallas_shade.sample_all_plain(u8, gb8, rows, cols, pdf_tex, base,
                                         n_samples_x)
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
    share, worst = _sum_bound(got, want, abs_sum, _sqrt_n_bound(count),
                              _flushed(count))
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


def check_trace(ro, rd, bvh, tmin=0.0, reps=5):
    got = pallas_tracer._trace_cuda(ro, rd, bvh, tmin)
    want = tracer.any_hit(ro, rd, bvh, tmin=tmin)
    share = float((got == want).double().mean())
    return dict(
        name='trace', agree=share, max_abs_err=float(
            (got.float() - want.float()).abs().max()) if got.numel() else 0.0,
        ok=share == 1.0,
        compared_on='%d rays, %.4f occluded' % (ro.shape[0],
                                               float(want.float().mean())),
        ms=time_ms(lambda: pallas_tracer._trace_cuda(ro, rd, bvh, tmin),
                   reps),
        plain_ms=time_ms(lambda: tracer.any_hit(ro, rd, bvh, tmin=tmin), 1,
                         warmup=0))


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
          'denoise_grad': check_denoise_grad, 'shade_bwd': check_shade_bwd,
          'light_scatter': check_light_scatter, 'scatter': check_scatter,
          'trace': check_trace, 'mask': check_mask}
FORWARD = ('resolve', 'sample_guide', 'sample', 'trace_shade', 'denoise')
BACKWARD = ('denoise_grad', 'shade_bwd', 'light_scatter', 'scatter')
VALIDATE = ('trace', 'mask')


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
    if name in ('denoise', 'denoise_grad'):
        col6, nrm, zdz, sigma = args
        N, H, W = col6.shape[:3]
        taps = denoise_taps(N, H, W, sigma)
        return dict(_bound_of(_nbytes(col6, nrm, zdz) + N * H * W * 7 * 4,
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
    'scatter', and every launch, in order, under 'scatter_all'."""

    _TARGETS = ((pallas_raster, '_resolve_cuda', 'resolve'),
                (pallas_shade, '_sample_guide_cuda', 'sample_guide'),
                (pallas_shade, '_sample_cuda', 'sample'),
                (pallas_shade, '_trace_shade_cuda', 'trace_shade'),
                (pallas_denoise, '_denoise_cuda', 'denoise'),
                (pallas_denoise, '_denoise_grad_cuda', 'denoise_grad'),
                (pallas_shade, '_shade_bwd_cuda', 'shade_bwd'),
                (pallas_shade, '_light_scatter_cuda', 'light_scatter'),
                (pallas_scatter, '_scatter_cuda', 'scatter'),
                (pallas_tracer, '_trace_cuda', 'trace'),
                (pallas_tracer, '_mask_cuda', 'mask'))

    def __init__(self):
        self.args = {'scatter_all': []}
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
                return _orig(*a)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        return False
