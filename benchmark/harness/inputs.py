"""The inputs the benchmark makes from --seed and hands to both the
program and the plain reference: the trainable light, the material
(textures, or the hash-grid table and the MLP), the SDF and deformation
of a DMTet grid.  Everything is drawn on the run's device in a few large
calls from one torch.Generator seeded with the seed, in the shapes and
ranges of the configuration.  Nothing here imports the program."""

import math

import torch

HASH_LEVELS = 16          # the port's HashEncodingConfig: 16 levels of 2
HASH_FEATURES = 2         # features, 2^19 rows a level, a 32-wide MLP of
HASH_LOG2_ROWS = 19       # 2 hidden layers and 6 outputs (kd, ks)
MLP_WIDTH = 32
MLP_HIDDEN = 2
MLP_OUT = 6


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def _uniform(shape, lo, hi, gen, device):
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def light(flags, gen, device):
    """A probe_res^2 light, uniform in [0.25, 0.75] per texel and channel:
    the trainable light of a run past its start, no longer the constant
    0.5 it starts from."""
    r = flags['probe_res']
    return _uniform((r, r, 3), 0.25, 0.75, gen, device)


def textures(flags, gen, device):
    """kd, ks and normal [1, H, W, C] at texture_res: kd and ks uniform
    within their bounds per texel (kd_min / kd_max, ks_min / ks_max), the
    normal map flat (0, 0, 1), as a random_textures run starts it."""
    H, W = flags['texture_res']
    kd = _uniform((1, H, W, 3), flags['kd_min'][:3], flags['kd_max'][:3],
                  gen, device)
    ks = _uniform((1, H, W, 3), flags['ks_min'], flags['ks_max'], gen,
                  device)
    nrm = torch.tensor([0.0, 0.0, 1.0], device=device).expand(
        1, H, W, 3).contiguous()
    return {'kd': kd, 'ks': ks, 'normal': nrm}


# The RMS of each level's table rows after 500 iterations of upstream
# spot.json's pass 1 on spot256 (the program's train.main, lr 0.03, on an
# H100): over the rows a level reads, (res + 1)^3 where that fits its
# 2^19 rows, all of them where it hashes.  The levels differ by 2.7x, so
# each is drawn at its own scale; tcnn's U(-1e-4, 1e-4) start leaves the
# MLP's products too small for a precision a step below float32 to show.
# A second witness, 500 steps from this cell's own sphere start with the
# table at tcnn's init, reads 0.16-0.35 a level, 0.71-2.08x these.  Both
# runs overflow marching tets' 24 r^2 slots, so neither is a clean run.
TABLE_RMS = (0.33, 0.26, 0.21, 0.17, 0.12, 0.12, 0.13, 0.15, 0.17, 0.19,
             0.21, 0.22, 0.21, 0.22, 0.22, 0.21)


def hashgrid_mlp(gen, device):
    """The hash-grid table [16 * 2^19, 2], level l's rows U(-a, a) with
    a = sqrt(3) TABLE_RMS[l] (a trained table's scale), and the MLP's
    weights w0 [32, 32], w1 [32, 32], w2 [32, 6], each
    U(-sqrt(6 / fan_in), sqrt(6 / fan_in))."""
    a = math.sqrt(3.0) * torch.tensor(TABLE_RMS, device=device)
    table = _uniform((HASH_LEVELS, 1 << HASH_LOG2_ROWS, HASH_FEATURES),
                     -1.0, 1.0, gen, device) * a[:, None, None]
    out = {'table': table.reshape(-1, HASH_FEATURES)}
    dims = ([HASH_LEVELS * HASH_FEATURES] + [MLP_WIDTH] * MLP_HIDDEN
            + [MLP_OUT])
    for i in range(len(dims) - 1):
        b = math.sqrt(6.0 / dims[i])
        out['w%d' % i] = _uniform((dims[i], dims[i + 1]), -b, b, gen, device)
    return out


def sphere_sdf(verts, radius):
    """SDF of a sphere of radius about the origin at the grid's vertices,
    norm(v) - radius (the sphere of the port's bench, pass1_annealed), and
    a zero deformation."""
    return {'sdf': torch.linalg.norm(verts, dim=-1) - radius,
            'deform': torch.zeros_like(verts)}
