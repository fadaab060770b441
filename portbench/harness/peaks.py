"""Published peaks of one NVIDIA H100 (SXM, dense, at its 700 W limit).

NVIDIA's data sheet: float32 outside the tensor cores 67 TFLOP/s (TF32
495, bfloat16 and float16 989, fp8 1,979 TFLOP/s on the tensor cores,
which no measured kernel uses); 80 GB of HBM3 at 3.35 TB/s. A share of a
peak is stated against these, with the card's power limit beside it in
the run's log.
"""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, flops_peak: float = FP32_FLOPS) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over HBM's rate."""
    return max(flops / flops_peak, nbytes / HBM_BYTES_PER_S)


def kernel_stats(record: dict, pattern: str):
    """``(launches, seconds)`` of the traced device activities whose name
    holds ``pattern``; None without a trace or without such a launch."""
    trace = record.get("trace")
    if not trace:
        return None
    n = secs = 0
    for name, (count, total) in trace["kernels"].items():
        if pattern in name:
            n += count
            secs += total
    return (n, secs) if n else None
