"""The training forward's env_shade calls: their least time (harness/
roofline.py, counted from each call's public inputs against a BVH the
benchmark builds) over the device time of the kernels launched inside
their spans, in %.  The least time of each call is the larger of its
bytes over 3.35 TB/s and its operations over 67 TFLOP/s; the walk is
counted on 8,192 seeded rays of each call and scaled.  Which bound binds
is in ctx['notes']."""

from harness import roofline


def read(ctx):
    calls = ctx['spans'].env_shade_calls
    us = ctx['trace']['span_device_us']['env_shade']
    if not calls or us <= 0:
        return None
    works = [roofline.env_shade_work(ctx['plain'], dict(c, **c['mesh']))
             for c in calls]
    by = sorted({w['bound_by'] for w in works})
    ctx['notes']['env_shade_bound_by'] = '+'.join(by)
    ctx['notes']['env_shade_bound_s'] = sum(w['bound_s'] for w in works)
    ctx['notes']['env_shade_device_s'] = us / 1e6
    return 100.0 * sum(w['bound_s'] for w in works) / (us / 1e6)
