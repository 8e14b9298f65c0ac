"""Device milliseconds a step in the kernels launched inside the program's
train.forward span: the light's tables, the mesh, the render and the
losses of the training forward.

Read from the traced run's second pass, inside the program's
tracing.recording() (harness/program.py)."""


def read(ctx):
    return ctx['program']['forward_ms_per_step']
