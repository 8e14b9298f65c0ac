"""Multi-resolution hash-grid encoding and the small MLP of the neural
material (counterpart of nvdiffrecmc_tpu/ops/hashgrid.py).

Encoding: `n_levels` grids of geometrically growing resolution; each level
looks up the 8 corners of the cell around a point in a table of
2^log2_hashmap_size rows of `n_features_per_level` features, indexed
densely where the level's (r+1)^3 corners fit the table and by the spatial
hash of the JAX package otherwise, and interpolates them trilinearly.  The
MLP has `hidden` ReLU layers of `internal_dims`, no bias, and a sigmoid
output scaled to [min, max].

The port keeps the contract, not the TPU layouts: one flat [L*T, F] table
(level l's rows at l*T ... l*T + T - 1) and the rows of every (level,
corner, point) in one [L, 8, P] index, level-major, then corner, then
point.  The forward is one `pallas_scatter.rows_gather` over that index,
so the table's cotangent is one row scatter (csrc/scatter.cu, C = F) whose
warps see 32 neighbouring points of one level and corner, which mostly
share a cell at the coarse levels; the position cotangent comes from
autograd through the trilinear weights (the JAX package's hand adjoint
computes the same sums).  The JAX package's dense-level cell tables and
their adjoint are a TPU tactic for the same function.

The hash multiplies in uint32 with wraparound; here the products are
taken in int64 and masked to 32 bits before the XOR and the modulo, which
gives the same rows."""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import constant, resolve
from .pallas_scatter import rows_gather
from .vecmath import clip_split

PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF

# corner c's offsets (cx, cy, cz) = bits 0, 1, 2 of c
_CORNER_BITS = [[(c >> d) & 1 for d in range(3)] for c in range(8)]


class HashEncodingConfig(NamedTuple):
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    desired_resolution: int = 4096


def level_scales(cfg: HashEncodingConfig):
    per_level_scale = math.exp(
        math.log(cfg.desired_resolution / cfg.base_resolution)
        / (cfg.n_levels - 1))
    return [int(np.floor(cfg.base_resolution * per_level_scale ** l))
            for l in range(cfg.n_levels)]


def table_size(cfg: HashEncodingConfig):
    return 1 << cfg.log2_hashmap_size


def init_encoding(cfg: HashEncodingConfig, generator=None, device=None):
    """The flat table [L*T, F], U(-1e-4, 1e-4) (tcnn's init) from
    generator."""
    device = resolve(device)
    rows = cfg.n_levels * table_size(cfg)
    u = torch.rand((rows, cfg.n_features_per_level), generator=generator,
                   device=device)
    return u * 2e-4 - 1e-4


def _corner_rows(p0, res, T):
    """Rows [8, P] int64 into one level's block of T rows: corner c of the
    cell at p0 [P, 3] (int64, in [0, res]), clipped to the grid; dense
    when the (res+1)^3 corners fit T, hashed otherwise."""
    bits = constant(_CORNER_BITS, torch.int64, p0.device)
    ic = torch.clamp(p0[None] + bits[:, None, :], 0, res)     # [8, P, 3]
    ix, iy, iz = ic[..., 0], ic[..., 1], ic[..., 2]
    if (res + 1) ** 3 <= T:
        return (ix * (res + 1) + iy) * (res + 1) + iz
    h = (((ix * PRIMES[0]) & _MASK32) ^ ((iy * PRIMES[1]) & _MASK32)
         ^ ((iz * PRIMES[2]) & _MASK32))
    return h % T


def encode_rows(x, cfg: HashEncodingConfig):
    """The table rows of every (level, corner, point) [L, 8, P] int64,
    level-major, for points x [P, 3] in [0, 1]."""
    T = table_size(cfg)
    with torch.no_grad():
        out = []
        for l, res in enumerate(level_scales(cfg)):
            p0 = torch.clamp(torch.floor(x * res).long(), 0, res)
            out.append(_corner_rows(p0, res, T) + l * T)
        return torch.stack(out)


def encode_weights(x, cfg: HashEncodingConfig):
    """Trilinear weights [L, 8, P] of the corners of encode_rows:
    prod over d of w_d (corner bit 1) or 1 - w_d (bit 0), w = x r -
    floor(x r); differentiable in x."""
    res = constant(level_scales(cfg), x.dtype, x.device)
    p = x[None] * res[:, None, None]                           # [L, P, 3]
    w = p - torch.floor(p)
    pair = torch.stack([1.0 - w, w], dim=1)                    # [L, 2, P, 3]
    bits = constant(_CORNER_BITS, torch.int64, x.device)       # [8, 3]
    wx, wy, wz = (pair[..., d][:, bits[:, d]] for d in range(3))
    return wx * wy * wz


def encode(table, x, cfg: HashEncodingConfig):
    """table [L*T, F] (flat); x [P, 3] in [0, 1].  Returns [P, L*F]:
    level l's F features at columns l*F ... l*F + F - 1."""
    L, F = cfg.n_levels, cfg.n_features_per_level
    P = x.shape[0]
    rows = encode_rows(x.detach(), cfg)                        # [L, 8, P]
    cf = rows_gather(table, rows)                              # [L, 8, P, F]
    wprod = encode_weights(x, cfg)
    feats = torch.sum(cf * wprod[..., None], dim=1)            # [L, P, F]
    return feats.permute(1, 0, 2).reshape(P, L * F)


def encode_ref(table, x, cfg: HashEncodingConfig):
    """Plain per-level, per-corner twin of encode (the JAX package's
    encode_ref), gathering with plain indexing."""
    T = table_size(cfg)
    feats = []
    for l, res in enumerate(level_scales(cfg)):
        p = x * res
        p0f = torch.floor(p)
        w = p - p0f
        p0 = torch.clamp(p0f.long(), 0, res)
        rows = _corner_rows(p0, res, T) + l * T
        out = 0.0
        for c, (cx, cy, cz) in enumerate(_CORNER_BITS):
            wt = ((w[:, 0] if cx else 1 - w[:, 0])
                  * (w[:, 1] if cy else 1 - w[:, 1])
                  * (w[:, 2] if cz else 1 - w[:, 2]))
            out = out + table[rows[c]] * wt[:, None]
        feats.append(out)
    return torch.cat(feats, dim=-1)


class MLPTexture3DParams(NamedTuple):
    table: torch.Tensor         # [L*T, F]
    weights: tuple              # MLP weight matrices [in, out]


def init_mlp_texture(cfg: HashEncodingConfig, channels=6, internal_dims=32,
                     hidden=2, generator=None, device=None):
    """The table (init_encoding) and the MLP's weights, each
    U(-sqrt(6 / fan_in), sqrt(6 / fan_in)) (kaiming-uniform for ReLU), drawn
    in that order from generator."""
    device = resolve(device)
    table = init_encoding(cfg, generator, device)
    dims = ([cfg.n_levels * cfg.n_features_per_level]
            + [internal_dims] * hidden + [channels])
    weights = []
    for i in range(len(dims) - 1):
        bound = math.sqrt(6.0 / dims[i])
        u = torch.rand((dims[i], dims[i + 1]), generator=generator,
                       device=device)
        weights.append(u * (2.0 * bound) - bound)
    return MLPTexture3DParams(table=table, weights=tuple(weights))


def sample_mlp_texture(params: MLPTexture3DParams, cfg: HashEncodingConfig,
                       aabb, min_max, x):
    """The neural texture at world positions x [..., 3]: x mapped into
    aabb = (lo [3], hi [3]) and clipped to [0, 1], encoded, the MLP, a
    sigmoid scaled to min_max = (min [C], max [C])."""
    shape = x.shape[:-1]
    p = x.reshape(-1, 3)
    lo, hi = aabb
    p = clip_split((p - lo[None]) / (hi - lo)[None], 0.0, 1.0)
    h = encode(params.table, p, cfg)
    for w in params.weights[:-1]:
        h = torch.relu(h @ w)
    out = h @ params.weights[-1]
    mn, mx = min_max
    out = torch.sigmoid(out) * (mx - mn)[None] + mn[None]
    return out.reshape(*shape, out.shape[-1])
