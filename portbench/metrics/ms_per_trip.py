"""Window milliseconds per batched trip (scheduler, ``core/batched.py``),
passes and host work included."""


def read(record):
    c = record["counters"]
    return 1e3 * record["window_s"] / c["trips"] if c["trips"] else None
