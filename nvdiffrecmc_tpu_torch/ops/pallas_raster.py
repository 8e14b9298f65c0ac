"""Coverage resolve of the rasterizer: the nearest-z triangle per pixel with
depth peeling (counterpart of nvdiffrecmc_tpu/ops/pallas_raster.py).

`resolve_batch` launches the CUDA kernel csrc/resolve.cu on CUDA tensors and
runs `resolve_batch_plain`, the same function in plain PyTorch, on CPU
tensors.  Both read the per-chunk coefficients and screen bboxes that
`_chunk_coefs` computes in PyTorch."""

import torch

from .. import kernels

BIG = 3e37
TC = 128          # triangles per chunk
TILE = 32         # pixel tile edge of the kernel's blocks
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


def _pixel_ndc_xy(H, W, device):
    sx = (2.0 * (torch.arange(W, dtype=torch.float32, device=device) + 0.5)
          / W) - 1.0
    sy = (2.0 * (torch.arange(H, dtype=torch.float32, device=device) + 0.5)
          / H) - 1.0
    return sx, sy


def resolve_batch_plain(coef, H, W, prev_z, prev_id):
    """Plain PyTorch resolve.  coef [N, NC, 15, TC]; prev_z [N, H, W]
    (-BIG for the first layer, +BIG where the pixel stays empty); prev_id
    [N, H, W] int32 (tri_id+1 to exclude).  Returns (z [N,H,W] f32,
    tid [N,H,W] int32, tri_id+1, 0 empty)."""
    N, NC = coef.shape[:2]
    sx, sy = _pixel_ndc_xy(H, W, coef.device)
    sx = sx[None, None, :, None]
    sy = sy[None, :, None, None]
    pz = prev_z[..., None]
    pid = prev_id[..., None]
    best_z = torch.full((N, H, W), BIG, device=coef.device)
    best_id = torch.zeros((N, H, W), dtype=torch.int32, device=coef.device)
    lane = torch.arange(TC, device=coef.device, dtype=torch.int32)
    for c in range(NC):
        cf = coef[:, c][:, :, None, None, :]          # [N, 15, 1, 1, TC]

        def field(f):
            return cf[:, 3 * f] * sx + cf[:, 3 * f + 1] * sy + cf[:, 3 * f + 2]
        e0, e1, e2, z, s = (field(f) for f in range(5))
        ids = c * TC + lane + 1
        inside = ((e0 > 0.0) & (e1 > 0.0) & (e2 > 0.0) & (s > 0.0)
                  & (z >= -1.0) & (z <= 1.0) & (z > pz + Z_EPS)
                  & (ids != pid))
        zm = torch.where(inside, z, torch.full_like(z, BIG))
        zmin, k = torch.min(zm, dim=-1)               # first (lowest) id
        better = zmin < best_z
        best_z = torch.where(better, zmin, best_z)
        best_id = torch.where(better, (c * TC + k + 1).to(torch.int32),
                              best_id)
    hit = best_z < BIG
    return (torch.where(hit, best_z, torch.zeros_like(best_z)),
            torch.where(hit, best_id, torch.zeros_like(best_id)))


def _resolve_cuda(coef, bbox, H, W, prev_z, prev_id):
    N, NC = coef.shape[:2]
    dev = coef.device
    kernels.require(coef, 'coef', torch.float32, (N, NC, 15, TC))
    kernels.require(bbox, 'bbox', torch.float32, (N, NC, 4), dev)
    kernels.require(prev_z, 'prev_z', torch.float32, (N, H, W), dev)
    kernels.require(prev_id, 'prev_id', torch.int32, (N, H, W), dev)
    z = torch.empty((N, H, W), dtype=torch.float32, device=dev)
    tid = torch.empty((N, H, W), dtype=torch.int32, device=dev)
    lib = kernels.lib()
    with torch.cuda.device(dev):
        rc = lib.nvk_resolve(
            coef.data_ptr(), bbox.data_ptr(), prev_z.data_ptr(),
            prev_id.data_ptr(), z.data_ptr(), tid.data_ptr(), N, NC, H, W,
            kernels.stream_ptr(coef))
    kernels.LAUNCHES['resolve'] += 1
    kernels.check(rc, 'nvk_resolve')
    return z, tid


def resolve_batch(v_clip, tri, H, W, prev_z, prev_id):
    """Coverage resolve for a batch: v_clip [N, V, 4]; tri [T, 3]; prev_z
    [N, H*W] (-BIG first layer, +BIG stay-empty); prev_id [N, H*W] int32.
    Returns (z [N,H,W], tid [N,H,W] int32).  Not differentiable."""
    N = v_clip.shape[0]
    v_clip = v_clip.detach()
    cb = [_chunk_coefs(v_clip[b], tri) for b in range(N)]
    coef = torch.stack([c for c, _ in cb]).contiguous()
    bbox = torch.stack([b for _, b in cb]).contiguous()
    pz = prev_z.reshape(N, H, W).contiguous().float()
    pid = prev_id.reshape(N, H, W).contiguous().to(torch.int32)
    if coef.is_cuda:
        return _resolve_cuda(coef, bbox, H, W, pz, pid)
    return resolve_batch_plain(coef, H, W, pz, pid)
