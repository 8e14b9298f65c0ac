"""The reference's neural material, written from the semantics of
tiny-cuda-nn's multi-resolution hash encoding as upstream nvdiffrecmc
configures it (render/mlptexture.py) and independent of the program's
code: 16 levels of 2 features in tables of 2^19 rows, resolutions from
16 to 4096 in a geometric series, a level indexed densely where its
(r + 1)^3 corners fit its table and by the spatial hash otherwise,
trilinear interpolation; then the MLP of 2 hidden ReLU layers of 32
without biases and a sigmoid output scaled to the material's bounds.

The table is one flat [16 * 2^19, 2] tensor, level l's rows at l * 2^19
onwards, and the MLP's weights are [in, out]: the layout of the seeded
inputs (harness/inputs.py), which both sides read.  A level's rows are
gathered by index_select, whose backward adds into the table's gradient
(index_add_): the backward of an indexing gather sorts its indices and
adds each row's run of repeats in turn, 0.18 s a gather on an H100 where
a coarse level's few thousand rows take a million points each."""

import math

import torch

LEVELS = 16
LOG2_ROWS = 19
BASE_RES = 16
FINEST_RES = 4096
PRIMES = (1, 2654435761, 805459861)


def resolutions():
    growth = math.exp(math.log(FINEST_RES / BASE_RES) / (LEVELS - 1))
    return [int(math.floor(BASE_RES * growth ** l)) for l in range(LEVELS)]


def _rows(cx, cy, cz, res):
    """The table rows (within a level) of grid corners (cx, cy, cz)."""
    rows = 1 << LOG2_ROWS
    if (res + 1) ** 3 <= rows:
        return (cx * (res + 1) + cy) * (res + 1) + cz
    mask = 0xFFFFFFFF
    h = ((cx * PRIMES[0]) & mask) ^ ((cy * PRIMES[1]) & mask) \
        ^ ((cz * PRIMES[2]) & mask)
    return h % rows


def encode(table, x):
    """Features [P, 16 * 2] of points x [P, 3] in [0, 1], level-major."""
    out = []
    for level, res in enumerate(resolutions()):
        p = x * res
        cell = torch.floor(p)
        frac = p - cell
        c0 = torch.clamp(cell.long(), 0, res)
        feat = 0.0
        for corner in range(8):
            bit = [(corner >> d) & 1 for d in range(3)]
            c = [torch.clamp(c0[:, d] + bit[d], 0, res) for d in range(3)]
            row = _rows(c[0], c[1], c[2], res) + (level << LOG2_ROWS)
            w = 1.0
            for d in range(3):
                w = w * (frac[:, d] if bit[d] else 1.0 - frac[:, d])
            feat = feat + table.index_select(0, row) * w[:, None]
        out.append(feat)
    return torch.cat(out, -1)


def material(params, lo, hi, kd_ks_min, kd_ks_max):
    """kd_ks(pos [..., 3]) -> [..., 6]: pos mapped from the box [lo, hi]
    into [0, 1] (clamped), encoded, the MLP, the sigmoid scaled to
    [kd_ks_min, kd_ks_max]."""
    weights = [params['w%d' % i] for i in range(len(params) - 1)]

    def kd_ks(pos):
        x = torch.clamp((pos.reshape(-1, 3) - lo) / (hi - lo), 0.0, 1.0)
        h = encode(params['table'], x)
        for w in weights[:-1]:
            h = torch.relu(h @ w)
        y = torch.sigmoid(h @ weights[-1])
        y = y * (kd_ks_max - kd_ks_min) + kd_ks_min
        return y.reshape(*pos.shape[:-1], y.shape[-1])
    return kd_ks
