"""The readings the limits of limits/<cell>.json are set from, outside the
benchmark's runs: the control and the planted faults, each put in the
program's place and compared with the plain reference by the numbers of
harness/numbers.py, at the cell's own sizes.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--faults]

Per seed, one JSON line: the control (the reference with its matrix
products in TF32) against the reference (--no-control leaves it out),
with --program the program's first steps as a run reads them (the lower
readings), and with --faults the faults a training cell can have,
planted in the reference: 'half_batch' (each
step on the first half of its batch, the mean over that half),
'double_grad' (the material's first leaf's gradient doubled where the
step produces it: a texture, or the hash-grid table) and, on a 'dmtet'
path, 'double_mlp_grad' (the MLP's first weight's gradient doubled).  A
step that leaves the state unchanged reads 1 by change_gap's measure
and needs no run."""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]   # the harness, the program

import torch  # noqa: E402

from harness import cell, numbers  # noqa: E402
from reference import follow, step  # noqa: E402


def readings(spec, seed, device, faults=False, overrides=None,
             program=False, control=True):
    """{name: gaps} of the program, the control and the faults against
    the reference on one seed."""
    n = spec['traffic']['reference_steps']
    out = {}
    if program:
        prog = cell.Run(follow.load('nvdiffrecmc_tpu_torch'), spec, seed,
                        device, overrides).first_steps(n)
        if device.type == 'cuda':
            torch.cuda.empty_cache()
    ref = follow.follow(spec, seed, device, n, overrides)
    if program:
        detail = {}
        out['program'] = numbers.gaps(prog, ref, detail)
        out['program_detail'] = detail
    if control:
        detail = {}
        out['control_tf32'] = numbers.gaps(
            follow.follow(spec, seed, device, n, overrides, tf32=True), ref,
            detail)
        out['control_tf32_detail'] = detail
    if faults:
        for f in step.faults(spec['traffic']['path']):
            out[f] = numbers.gaps(
                follow.follow(spec, seed, device, n, overrides, fault=f), ref)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--faults', action='store_true')
    p.add_argument('--program', action='store_true')
    p.add_argument('--no-control', action='store_true')
    a = p.parse_args()
    if not torch.cuda.is_available():
        print('control.py: no CUDA card', file=sys.stderr)
        return 1
    spec = cell.load_spec(a.workload)
    for s in a.seeds:
        t = time.perf_counter()
        got = readings(spec, s, torch.device('cuda', 0), a.faults,
                       program=a.program, control=not a.no_control)
        print(json.dumps({'workload': a.workload, 'seed': s,
                          'seconds': time.perf_counter() - t, **got}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
