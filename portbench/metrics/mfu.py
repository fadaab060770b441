"""The whole window's share of the card's float32 peak: the model's
operations per gradient (counted from shapes by ``models/<model>.py``)
times the useful gradients, over the window's seconds times 67 TFLOP/s,
in percent."""

from portbench.harness.peaks import FP32_FLOPS


def read(record):
    flops = record["flops_per_grad"] * record["counters"]["grads"]
    return 100.0 * flops / (record["window_s"] * FP32_FLOPS)
