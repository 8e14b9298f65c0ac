"""What the kernel benches (bench_walk.py, bench_raster_denoise.py,
bench_sample_bwd.py) share: the card line, CUDA-event and profiler timing,
the recording of wrapper arguments on the main path, the command line
(--root, --inputs, --out, --compare) and the comparison of two result
files.  Each bench passes its own targets: the wrappers to record and a
run function that times them."""

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smi_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def events_ms(fn, reps, warmup=1, median=False):
    """Mean (or median) device milliseconds of fn over reps calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not median:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps):
    """(device milliseconds, kernel launches) per call of fn: the sum of
    its kernels' times under a CUDA-only torch.profiler trace of reps
    calls, after one warm-up call.  A process's later launches run slower
    after a profiler session, so a bench calls this after its other
    timings."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    key = 'self_device_time_total'
    if events and not hasattr(events[0], key):
        key = 'self_cuda_time_total'
    return (sum(getattr(e, key) for e in events) / 1e3 / reps,
            sum(e.count for e in events) / reps)


@contextlib.contextmanager
def recording(targets, room):
    """Record the arguments (detached copies on the CPU) of the wrappers
    `targets`, (module, attribute, name) each, into calls[name], while
    room[name] says how many more to keep (the caller opens the room
    around the calls it wants: the datasets render their targets through
    the same wrappers).  Yields calls; the wrappers are restored on exit."""
    import torch
    calls = {name: [] for _, _, name in targets}
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]
    for (mod, attr, name), (_, _, orig) in zip(targets, saved):
        def wrapped(*a, _orig=orig, _name=name):
            if len(calls[_name]) < room.get(_name, 0):
                calls[_name].append(tuple(
                    x.detach().cpu().clone() if torch.is_tensor(x) else x
                    for x in a))
            return _orig(*a)
        setattr(mod, attr, wrapped)
    try:
        yield calls
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def to_device(args, dev):
    import torch
    return tuple(x.to(dev) if torch.is_tensor(x) else x for x in args)


def compare(path_a, path_b):
    """Print, for each tensor of two result files, the entries that
    differ, the largest difference and the non-finite entries of each."""
    import torch
    a, b = (torch.load(f) for f in (path_a, path_b))
    keys = sorted(k for k in a if torch.is_tensor(a[k]))
    print('compare %s %s: entries that differ %s; max abs difference %s; '
          'non-finite entries %s'
          % (path_a, path_b,
             {k: '%d of %d' % (int((a[k] != b[k]).sum()), a[k].numel())
              for k in keys},
             {k: float((a[k].double() - b[k].double()).abs().max())
              for k in keys},
             {k: (int((~a[k].double().isfinite()).sum()),
                  int((~b[k].double().isfinite()).sum())) for k in keys}))


def use_root(root):
    """Import nvdiffrecmc_tpu_torch and chip_smoke from the checkout at
    root from here on (its kernels build into root/build)."""
    here = (ROOT, os.path.join(ROOT, 'nvdiffrecmc_tpu_torch'))
    sys.path[:] = [os.path.abspath(root)] + [
        p for p in sys.path if os.path.abspath(p or '.') not in here]
    for name in list(sys.modules):
        if name == 'chip_smoke' or name.startswith('nvdiffrecmc_tpu_torch'):
            del sys.modules[name]


def main(doc, run, record=None, add_args=None):
    """The command line of a bench whose module docstring is doc:

        --root DIR --inputs FILE --out FILE [its own options]
        --compare FILE FILE

    Builds the kernels of the checkout at DIR, records the inputs into
    FILE with record(dev, path) where FILE is absent, then calls run(dev,
    args), which returns (times, results): the results are saved to --out
    and the times printed as one JSON line with the card."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument('--root', default=ROOT)
    parser.add_argument('--out')
    parser.add_argument('--inputs',
                        help='the recorded inputs (read if present, else '
                             'recorded and written)')
    parser.add_argument('--compare', nargs=2)
    if add_args is not None:
        add_args(parser)
    args = parser.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('%s: torch.cuda.is_available() is false'
                         % os.path.basename(sys.argv[0]))
    if not (args.out and args.inputs):
        parser.error('--out and --inputs are required')
    use_root(args.root)
    from nvdiffrecmc_tpu_torch import kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.lib()
    print('root %s; build %.1f s; %s'
          % (args.root, time.perf_counter() - t0, smi_line()), flush=True)
    if record is not None and not os.path.exists(args.inputs):
        record(dev, args.inputs)
    times, res = run(dev, args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in res.items()}, args.out)
    print(json.dumps(dict(root=args.root, card=smi_line(), **times)),
          flush=True)
