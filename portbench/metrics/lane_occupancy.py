"""Share of the lanes a trip evaluates whose gradient a chain needed
(scheduler, ``core/batched.py``): useful gradients over trips times
chains, in percent."""


def read(record):
    c = record["counters"]
    if not c["trips"]:
        return None
    return 100.0 * c["grads"] / (c["trips"] * record["chains"])
