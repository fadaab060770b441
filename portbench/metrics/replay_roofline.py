"""Kernel 1 (``csrc/replay.cu``, ``replay_kernel``, the deferred threefry
replay of the tier-2 pass) in the traced slice: its least time over its
mean launch time, in percent. A launch over C lanes reads and writes 40
bytes a lane (two keys in and out, two counts in); its operations are
latency, not rate, so the bytes bound it."""

from portbench.harness.peaks import bound_s, kernel_stats


def read(record):
    stats = kernel_stats(record, "replay_kernel")
    if stats is None:
        return None
    launches, secs = stats
    return 100.0 * bound_s(0.0, 40.0 * record["chains"]) / (secs / launches)
