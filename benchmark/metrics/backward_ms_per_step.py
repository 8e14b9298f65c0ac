"""Device milliseconds a step in the kernels launched inside the program's
train.backward span, those autograd launches from its own thread
included.

Read from the traced run's second pass, inside the program's
tracing.recording() (harness/program.py)."""


def read(ctx):
    return ctx['program']['backward_ms_per_step']
