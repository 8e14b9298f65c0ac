"""Device milliseconds a step in the kernels launched inside the program's
train.optimizer span (apply_grads: the gradients' scales, the clip,
Adam, the clamps).

Read from the traced run's second pass, inside the program's
tracing.recording() (harness/program.py)."""


def read(ctx):
    return ctx['program']['optimizer_ms_per_step']
