"""Coverage resolve of the rasterizer: the nearest-z triangle per pixel with
depth peeling (counterpart of nvdiffrecmc_tpu/ops/pallas_raster.py).

`resolve_batch` launches csrc/resolve.cu on CUDA tensors: a setup kernel
per triangle (the fields of `_chunk_coefs` and the pixel rectangle of
`_tri_rects`), a raster kernel with one warp per triangle whose lanes take
a 64-bit atomicMin of (depth, id) keys over the rectangle's pixels, and an
unpack kernel per pixel.  On CPU tensors it runs `resolve_plain`:
`resolve_batch_plain`, the same function in plain PyTorch, over the
per-chunk coefficients of `_chunk_coefs` and the rectangles of
`_tri_rects`.  `_tri_coefs` gives those fields per triangle, as the setup
kernel lays them out, and `covered_pairs` lists the (pixel, triangle)
pairs the raster kernel takes its atomics on, in plain PyTorch.

A triangle covers only pixels of its rectangle (its screen box grown by
one pixel).  Where its three vertices nearly coincide, its edge fields are
rounding noise and can pass the inside test pixels away from it: the spot
mesh has two such slivers (ids 15947 and 17640), which the JAX package's
per-chunk boxes let through."""

import functools

import torch


BIG = 3e37
TC = 128          # triangles per chunk of the plain version
Z_EPS = 1e-7      # depth-peel strict-behind epsilon


def _chunk_coefs(v_clip, tri):
    """Per-chunk coefficients and screen bboxes for one batch element.

    Returns coef [NC, 15, TC] f32 (row f*3 + c: field f in e0, e1, e2, z, s;
    component c multiplies sx, sy, 1), edge and sum rows pre-multiplied by
    sign(det), invalid triangles zeroed; bbox [NC, 4] (xlo, ylo, xhi, yhi)
    in NDC, full-screen for triangles that cross w = 0."""
    from .rasterizer import _tri_setup
    A, az, asum, det, valid = _tri_setup(v_clip, tri)
    T = tri.shape[0]
    ds = torch.where(valid, torch.sign(det), torch.zeros_like(det))[:, None]
    e_rows = A * ds[:, :, None]                       # [T, 3, 3]
    fields = torch.cat([e_rows, az[:, None, :], (asum * ds)[:, None, :]],
                       dim=1)                         # [T, 5, 3]
    fields = torch.where(valid[:, None, None], fields,
                         torch.zeros_like(fields))

    p = v_clip[tri.long()]
    w = p[..., 3]
    front = torch.amin(w, -1) > 1e-6
    w_safe = torch.clamp(torch.abs(w), min=1e-20)
    sx = p[..., 0] / w_safe
    sy = p[..., 1] / w_safe
    big1 = torch.full_like(sx[:, 0], 4.0)

    def ext(v, fn, sign):
        return torch.where(valid, torch.where(front, fn(v, -1), sign * big1),
                           big1)
    xlo, xhi = ext(sx, torch.amin, -1.0), ext(sx, torch.amax, 1.0)
    ylo, yhi = ext(sy, torch.amin, -1.0), ext(sy, torch.amax, 1.0)

    pad = (-T) % TC
    if pad:
        fields = torch.cat([fields, fields.new_zeros((pad, 5, 3))], 0)
        xlo, xhi, ylo, yhi = (torch.cat([v, v.new_full((pad,), 4.0)])
                              for v in (xlo, xhi, ylo, yhi))
    NC = fields.shape[0] // TC
    coef = fields.reshape(NC, TC, 15).permute(0, 2, 1).contiguous()
    bbox = torch.stack([xlo.reshape(NC, TC).amin(-1),
                        ylo.reshape(NC, TC).amin(-1),
                        xhi.reshape(NC, TC).amax(-1),
                        yhi.reshape(NC, TC).amax(-1)], dim=-1)
    return coef, bbox


def _tri_coefs(v_clip, tri):
    """The fields of `_chunk_coefs` per triangle, [T, 15] f32 (the setup
    kernel's coef of one batch element).  v_clip [V, 4]; tri [T, 3]."""
    coef = _chunk_coefs(v_clip, tri)[0]
    return coef.permute(0, 2, 1).reshape(-1, 15)[:tri.shape[0]]


@functools.lru_cache(maxsize=16)
def _pixel_ndc_xy(H, W, device):
    """Pixel centres in NDC, sx [W] and sy [H]; made once per resolution
    and device (the callers only read them)."""
    sx = (2.0 * (torch.arange(W, dtype=torch.float32, device=device) + 0.5)
          / W) - 1.0
    sy = (2.0 * (torch.arange(H, dtype=torch.float32, device=device) + 0.5)
          / H) - 1.0
    return sx, sy


def resolve_batch_plain(coef, rect, H, W, prev_z, prev_id):
    """Plain PyTorch resolve.  coef [N, NC, 15, TC]; rect [N, NC, 4, TC]
    int32, each triangle's pixel rectangle (`_tri_rects`, chunked as
    coef): a pixel outside it is not the triangle's, whatever its fields
    say; prev_z [N, H, W] (-BIG for the first layer, +BIG where the pixel
    stays empty); prev_id [N, H, W] int32 (tri_id+1 to exclude).  Returns
    (z [N,H,W] f32, tid [N,H,W] int32, tri_id+1, 0 empty)."""
    N, NC = coef.shape[:2]
    sx, sy = _pixel_ndc_xy(H, W, coef.device)
    sx = sx[None, None, :, None]
    sy = sy[None, :, None, None]
    xs = torch.arange(W, device=coef.device)[None, None, :, None]
    ys = torch.arange(H, device=coef.device)[None, :, None, None]
    pz = prev_z[..., None]
    pid = prev_id[..., None]
    best_z = torch.full((N, H, W), BIG, device=coef.device)
    best_id = torch.zeros((N, H, W), dtype=torch.int32, device=coef.device)
    lane = torch.arange(TC, device=coef.device, dtype=torch.int32)
    for c in range(NC):
        cf = coef[:, c][:, :, None, None, :]          # [N, 15, 1, 1, TC]
        r = rect[:, c][:, :, None, None, :]           # [N, 4, 1, 1, TC]

        def field(f):
            return cf[:, 3 * f] * sx + cf[:, 3 * f + 1] * sy + cf[:, 3 * f + 2]
        e0, e1, e2, z, s = (field(f) for f in range(5))
        ids = c * TC + lane + 1
        inside = ((e0 > 0.0) & (e1 > 0.0) & (e2 > 0.0) & (s > 0.0)
                  & (z >= -1.0) & (z <= 1.0) & (z > pz + Z_EPS)
                  & (ids != pid) & (xs >= r[:, 0]) & (ys >= r[:, 1])
                  & (xs <= r[:, 2]) & (ys <= r[:, 3]))
        zm = torch.where(inside, z, torch.full_like(z, BIG))
        zmin, k = torch.min(zm, dim=-1)               # first (lowest) id
        better = zmin < best_z
        best_z = torch.where(better, zmin, best_z)
        best_id = torch.where(better, (c * TC + k + 1).to(torch.int32),
                              best_id)
    hit = best_z < BIG
    return (torch.where(hit, best_z, torch.zeros_like(best_z)),
            torch.where(hit, best_id, torch.zeros_like(best_id)))


def _chunk_rects(rect):
    """[T, 4] rectangles -> [NC, 4, TC], padded with empty ones."""
    pad = (-rect.shape[0]) % TC
    if pad:
        rect = torch.cat([rect, rect.new_tensor([[0, 0, -1, -1]]).expand(
            pad, 4)], 0)
    return rect.reshape(-1, TC, 4).permute(0, 2, 1).contiguous()


PAIR_BUDGET = 1 << 25     # (pixel, triangle) pairs evaluated at once


def resolve_plain(v_clip, tri, H, W, prev_z, prev_id):
    """The resolve's whole function in plain PyTorch, over the (pixel,
    triangle) pairs of each triangle's rectangle (`covered_pairs`, the
    fields evaluated as `resolve_batch_plain` evaluates them): per pixel
    the least z of the pairs that pass, and of those the lowest id, as
    resolve_batch_plain's chunked minimum keeps the first lowest id.
    v_clip [N, V, 4]; tri [T, 3]; prev_z, prev_id [N, H, W]."""
    N = v_clip.shape[0]
    dev = v_clip.device
    z_out = torch.zeros((N, H * W), device=dev)
    id_out = torch.zeros((N, H * W), dtype=torch.int32, device=dev)
    for b in range(N):
        coef15 = _tri_coefs(v_clip[b], tri)
        rect = _tri_rects(v_clip[b], tri, H, W)
        x0, y0, x1, y1 = rect.long().unbind(-1)
        area = (torch.clamp(x1 - x0 + 1, min=0)
                * torch.clamp(y1 - y0 + 1, min=0))
        group = (torch.cumsum(area, 0) - area) // PAIR_BUDGET
        cuts = (torch.nonzero(group[1:] != group[:-1])[:, 0] + 1).tolist()
        ts, pixs, zs = [], [], []
        for t0, t1 in zip([0] + cuts, cuts + [tri.shape[0]]):
            t, pix, z = covered_pairs(coef15[t0:t1], rect[t0:t1], H, W,
                                      prev_z[b], prev_id[b], t_offset=t0)
            ts.append(t)
            pixs.append(pix)
            zs.append(z)
        t, pix, z = torch.cat(ts), torch.cat(pixs), torch.cat(zs)
        zmin = torch.full((H * W,), BIG, device=dev).scatter_reduce_(
            0, pix, z, 'amin')
        first = torch.full((H * W,), tri.shape[0], dtype=torch.int64,
                           device=dev).scatter_reduce_(
            0, pix, torch.where(z == zmin[pix], t, tri.shape[0]), 'amin')
        hit = zmin < BIG
        z_out[b] = torch.where(hit, zmin, 0.0)
        id_out[b] = torch.where(hit, first + 1, 0).to(torch.int32)
    return z_out.reshape(N, H, W), id_out.reshape(N, H, W)


def _tri_rects(v_clip, tri, H, W):
    """Pixel rectangle [T, 4] int32 (x0, y0, x1, y1, inclusive) of each
    triangle's screen box grown by one pixel and clamped to the screen, as
    the setup kernel computes it: the whole screen where a vertex has
    w <= 1e-6 (as `_chunk_coefs` boxes those), empty (x1 < x0) for an
    invalid triangle.  v_clip [V, 4]; tri [T, 3]."""
    from .rasterizer import _tri_setup
    valid = _tri_setup(v_clip, tri)[4]
    p = v_clip[tri.long()]
    w = p[..., 3]
    front = torch.amin(w, -1) > 1e-6
    w_safe = torch.clamp(torch.abs(w), min=1e-20)
    spans = []
    for v, size in ((p[..., 0] / w_safe, W), (p[..., 1] / w_safe, H)):
        half = 0.5 * size
        lo = torch.floor((torch.amin(v, -1) + 1.0) * half - 0.5) - 1.0
        hi = torch.ceil((torch.amax(v, -1) + 1.0) * half - 0.5) + 1.0
        spans.append((torch.clamp(lo, 0.0, float(size)),
                      torch.clamp(hi, -1.0, float(size - 1))))
    (x0, x1), (y0, y1) = spans
    box = torch.stack([x0, y0, x1, y1], -1).to(torch.int32)
    full = torch.tensor([0, 0, W - 1, H - 1], dtype=torch.int32,
                        device=box.device)
    empty = torch.tensor([0, 0, -1, -1], dtype=torch.int32,
                         device=box.device)
    return torch.where(valid[:, None],
                       torch.where(front[:, None], box, full), empty)


def covered_pairs(coef15, rect, H, W, prev_z, prev_id, t_offset=0):
    """The (pixel, triangle) pairs of one batch element on which the raster
    kernel takes its atomicMin: the pixels of each triangle's rectangle
    that pass the inside test and the peel rule.  coef15 [T, 15] (the
    setup kernel's fields, `_tri_coefs`); rect [T, 4];
    prev_z [H, W]; prev_id [H, W] int32; t_offset: the id of coef15's
    first triangle.  Returns (tri [P] int64, pixel
    [P] int64 (y * W + x), z [P] f32), the fields evaluated as
    `resolve_batch_plain` evaluates them."""
    dev = coef15.device
    x0, y0, x1, y1 = rect.long().unbind(-1)
    rw = torch.clamp(x1 - x0 + 1, min=0)
    area = rw * torch.clamp(y1 - y0 + 1, min=0)
    t = torch.repeat_interleave(torch.arange(rect.shape[0], device=dev), area)
    i = torch.arange(t.numel(), device=dev) - (torch.cumsum(area, 0)
                                                - area)[t]
    x = x0[t] + i % rw[t]
    y = y0[t] + i // rw[t]
    px, py = _pixel_ndc_xy(H, W, dev)
    sx, sy = px[x], py[y]
    cf = coef15[t]

    def field(f):
        return cf[:, 3 * f] * sx + cf[:, 3 * f + 1] * sy + cf[:, 3 * f + 2]
    e0, e1, e2, z, s = (field(f) for f in range(5))
    pix = y * W + x
    inside = ((e0 > 0.0) & (e1 > 0.0) & (e2 > 0.0) & (s > 0.0)
              & (z >= -1.0) & (z <= 1.0)
              & (z > prev_z.reshape(-1)[pix] + Z_EPS)
              & (t + t_offset + 1 != prev_id.reshape(-1)[pix]))
    return t[inside] + t_offset, pix[inside], z[inside]


def resolve_batch(v_clip, tri, H, W, prev_z, prev_id):
    """Coverage resolve for a batch: v_clip [N, V, 4]; tri [T, 3]; prev_z
    [N, H*W] (-BIG first layer, +BIG stay-empty); prev_id [N, H*W] int32.
    Returns (z [N,H,W], tid [N,H,W] int32).  Not differentiable."""
    N = v_clip.shape[0]
    v_clip = v_clip.detach()
    pz = prev_z.reshape(N, H, W).contiguous().float()
    pid = prev_id.reshape(N, H, W).contiguous().to(torch.int32)
    return resolve_plain(v_clip, tri, H, W, pz, pid)
