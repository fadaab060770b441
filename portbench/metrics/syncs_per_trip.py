"""Device-to-host reads of loop conditions per batched trip (block loops,
``parallel/runtime.py``; ``RunInfo.n_syncs`` over ``n_inner_trips``)."""


def read(record):
    c = record["counters"]
    return c["syncs"] / c["trips"] if c["trips"] else None
