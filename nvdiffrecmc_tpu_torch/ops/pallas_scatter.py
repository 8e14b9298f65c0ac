"""Row scatter-add and the row gather whose adjoint it is (counterpart of
nvdiffrecmc_tpu/ops/pallas_scatter.py).

`scatter_add` launches csrc/scatter.cu on CUDA tensors and runs
`scatter_add_plain` (index_add_) on CPU tensors.  The kernel gives a warp
32 update rows, sums the rows of a warp that share an output row, and adds
each such sum with Hopper's vector float atomics; it has an instance for
each channel count of the training step (3, 4, 6, 9, 13) and a generic
one.  `rows_gather` is `table[idx]` with that scatter as its backward: the
adjoint of every vertex-attribute, triangle and texel gather of the
training step goes through it, as it does in the JAX package.  Rows whose
id lies outside [0, V) are dropped.  The JAX package's work lists and
value layout [C, M] serve the TPU's one-hot matmul and are not carried
over: here values are [M, C] rows."""

import torch

from .. import kernels


def scatter_add_plain(idx, vals, out_rows):
    """Plain PyTorch version: idx [M] int; vals [M, C] -> [out_rows, C]
    float32 (float64 for float64 vals) with vals[i] added to row idx[i]
    (ids outside [0, out_rows) dropped)."""
    idx = idx.reshape(-1).long()
    vals = vals.reshape(idx.shape[0], vals.shape[-1])
    vals = vals.to(torch.promote_types(vals.dtype, torch.float32))
    keep = (idx >= 0) & (idx < out_rows)
    out = vals.new_zeros((out_rows, vals.shape[1]))
    return out.index_add_(0, idx[keep], vals[keep])


def _scatter_cuda(idx, vals, out_rows):
    M, C = vals.shape
    dev = vals.device
    kernels.require(idx, 'idx', torch.int64, (M,), dev)
    kernels.require(vals, 'vals', torch.float32, (M, C))
    out = torch.zeros((out_rows, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels.lib().nvk_scatter_add(
            idx.data_ptr(), vals.data_ptr(), out.data_ptr(), M, C, out_rows,
            kernels.stream_ptr(vals))
    kernels.LAUNCHES['scatter'] += 1
    kernels.check(rc, 'nvk_scatter_add')
    return out


def scatter_add(idx, vals, out_rows):
    """idx [M] int; vals [M, C] -> [out_rows, C] float32."""
    if vals.is_cuda:
        idx = idx.reshape(-1).to(torch.int64).contiguous()
        vals = vals.reshape(idx.shape[0], vals.shape[-1]).float().contiguous()
        return _scatter_cuda(idx, vals, out_rows)
    return scatter_add_plain(idx, vals, out_rows)


class _RowsGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, dout):
        idx, = ctx.saved_tensors
        C = dout.shape[-1]
        d_table = scatter_add(idx.reshape(-1), dout.reshape(-1, C), ctx.rows)
        return d_table.to(dout.dtype), None


def rows_gather(table, idx):
    """table [V, C]; idx any int shape -> idx.shape + (C,), with the table
    gradient accumulated by scatter_add."""
    return _RowsGather.apply(table, idx.long())


def rows_gather_b(table, idx):
    """Batched rows_gather: table [N, V, C], idx [N, ...].  The batch is
    folded into the row id, so the backward is one scatter over N*V rows."""
    N, V, C = table.shape
    offs = (torch.arange(N, device=idx.device) * V).reshape(
        (N,) + (1,) * (idx.dim() - 1))
    return rows_gather(table.reshape(N * V, C), idx.long() + offs)
