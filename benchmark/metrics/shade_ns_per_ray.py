"""Device nanoseconds in the kernels launched inside the program's
render.shade spans (the training forward's and the targets') over the
shadow rays its counter shadow_rays counted: each env_shade call's
covered pixels times n_samples^2.

Read from the traced run's second pass, inside the program's
tracing.recording() (harness/program.py)."""


def read(ctx):
    return ctx['program']['shade_ns_per_ray']
