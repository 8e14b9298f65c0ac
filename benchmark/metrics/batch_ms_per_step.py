"""Host milliseconds a step spends in the dataset layer: next(batches)
and train.prepare_batch, ended by a sync (with DatasetMesh this holds the
target renders)."""


def read(ctx):
    f = ctx['fetch_s']
    return 1e3 * sum(f) / len(f) if f else None
