"""Share of the traced window in which the device runs no kernel, copy or
set: the window less the union of the device's intervals in the
profiler's timeline, over the window."""


def read(ctx):
    t = ctx['trace']
    if t['window_us'] <= 0:
        return None
    return 100.0 * (t['window_us'] - t['busy_us']) / t['window_us']
