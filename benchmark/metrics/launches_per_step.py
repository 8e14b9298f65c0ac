"""Kernel launches on the device per step, counted in the profiler's
trace (copies and sets left out)."""


def read(ctx):
    return len(ctx['trace']['kernels']) / ctx['steps']
