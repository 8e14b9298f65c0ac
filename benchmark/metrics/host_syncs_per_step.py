"""The times a step blocked the host on the card: the program's counter
host_syncs (each synchronizing call that CUDA's sync debug mode reports)
over the steps, less the harness's own (harness/program.py's
HARNESS_SYNCS).  Without CUDA there is no counter and nothing to read.

Read from the traced run's second pass, inside the program's
tracing.recording() (harness/program.py)."""


def read(ctx):
    return ctx['program']['host_syncs_per_step']
