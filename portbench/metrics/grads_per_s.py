"""Useful gradient evaluations (the per-chain counts the sampler keeps,
summed over chains and phases) over the window's seconds."""


def read(record):
    return record["counters"]["grads"] / record["window_s"]
