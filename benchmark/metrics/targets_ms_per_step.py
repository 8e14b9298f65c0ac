"""Device milliseconds a step in the kernels launched inside the program's
dataset.target spans: DatasetMesh's renders of the batch's targets.

Read from the traced run's second pass, inside the program's
tracing.recording() (harness/program.py)."""


def read(ctx):
    return ctx['program']['targets_ms_per_step']
