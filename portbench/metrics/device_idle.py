"""Share of the traced slice in which no activity ran on the device
(kernels, copies, fills), in percent: 1 - busy over the slice's length."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
