"""Kernel 2 (``csrc/logreg.cu``, ``logreg_kernel``) in the traced slice:
its least time over its mean launch time, in percent. The least time of a
launch of B chains over N rows of D features is the larger of its two
products' operations, 4 B N D, at 67 TFLOP/s and its bytes (theta, x, y
read once, the value and gradient written once, float32) at 3.35 TB/s."""

from portbench.harness.peaks import bound_s, kernel_stats


def read(record):
    stats = kernel_stats(record, "logreg_kernel")
    if stats is None or "num_rows" not in record["config"]:
        return None
    n, d = int(record["config"]["num_rows"]), int(record["config"]["dim"])
    b = record["chains"]
    nbytes = 4.0 * (b * d + n * d + n + b + b * d)
    launches, secs = stats
    return 100.0 * bound_s(4.0 * b * n * d, nbytes) / (secs / launches)
