"""The numbers that decide `correct`: the program's first steps against
the plain reference's, from the same inputs and seeds.

- loss_gap: over the steps the reference follows, the largest gap of a
  step's img_loss or reg_loss, over the reference's |img_loss| +
  |reg_loss| of that step (reg_loss can be near 0 or negative);
  loss1_gap: the same of the first step alone;
- grad_gap: over the leaves, the gap between the norms of the program's
  and the reference's first gradient as the optimizer took it, over the
  larger of the reference's norm of that leaf and its median leaf norm;
- change_gap: the same of the norms of each leaf's change over the steps
  the reference follows, the worst leaf; change_median_gap: the median
  of those leaves' gaps.  A leaf whose reference gradient is under a
  thousandth of the median leaf's moves by round-off alone and is left
  out of both.

A cell compares the numbers its limits/<cell>.json names, each against
its limit there: a number above its limit, or one that is not finite,
makes the run not correct.  `detail` names the leaf behind each leaf
number, for the record."""

import math
import statistics

NAMES = ('loss_gap', 'loss1_gap', 'grad_gap', 'change_gap',
         'change_median_gap')
NEGLIGIBLE_GRAD = 1e-3


def _leaf_gaps(prog, ref, keys):
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


def _step_gap(p, r):
    return (max(abs(p[0] - r[0]), abs(p[1] - r[1]))
            / max(abs(r[0]) + abs(r[1]), 1e-30))


def gaps(prog, ref, detail=None):
    """{name: value} of the program's readings (Run.first_steps) against
    the reference's over the reference's steps; detail, a dict, gets the
    worst leaf of each leaf number."""
    n = len(ref['losses'])
    steps = [_step_gap(p, r) for p, r in zip(prog['losses'][:n],
                                              ref['losses'])]
    out = dict(loss_gap=max(steps), loss1_gap=steps[0])
    keys = sorted(ref['grads'])
    if sorted(prog['grads']) != keys or not keys:
        return dict(out, grad_gap=math.inf, change_gap=math.inf,
                    change_median_gap=math.inf)
    med = statistics.median(ref['grads'][k] for k in keys)
    moving = [k for k in keys if ref['grads'][k] >= NEGLIGIBLE_GRAD * med]
    g = _leaf_gaps(prog['grads'], ref['grads'], keys)
    c = _leaf_gaps(prog['change'], ref['change'], moving)
    if detail is not None:
        detail.update(grad_leaf=max(g, key=g.get),
                      change_leaf=max(c, key=c.get),
                      change_by_leaf=c, step_gaps=steps)
    return dict(out, grad_gap=max(g.values()), change_gap=max(c.values()),
                change_median_gap=statistics.median(c.values()))


def verdict(values, limits):
    """(correct, {name: {'value', 'limit'}}) over the numbers limits
    names: every one finite and at most its limit."""
    checks = {k: {'value': values[k], 'limit': limits[k]}
              for k in NAMES if k in limits}
    ok = bool(checks) and all(
        math.isfinite(c['value']) and c['value'] <= c['limit']
        for c in checks.values())
    return ok, checks
