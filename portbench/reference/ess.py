"""Frozen NumPy copy of the multi-chain ESS and R-hat the benchmark reports.

The formulas are those of ``walnuts_tpu_torch/summary.py`` (Geyer's
initial-positive and initial-monotone sequence on cross-chain averaged
autocovariances, ``var_plus = W + var(chain means)``, the antithetic tail
and the floor ``tau >= 1 / log10(N)``), copied here so that a change to
the program cannot change the yardstick. Chains have equal length, so the
per-chain loop of the original becomes one FFT over a ``(S, C, D)`` array.
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np


def _good_size(n: int) -> int:
    """Smallest m >= n whose prime factors are all in {2, 3, 5}."""
    if n <= 2:
        return 2
    while True:
        m = n
        for f in (2, 3, 5):
            while m % f == 0:
                m //= f
        if m <= 1:
            return n
        n += 1


def ess(draws: np.ndarray) -> np.ndarray:
    """ESS of every dimension of ``draws`` ``(S, C, D)``: S draws of C
    chains. Returns ``(D,)`` float64."""
    x = np.asarray(draws, dtype=np.float64)
    s, k, d = x.shape
    n_total = s * k
    if n_total < 3:
        raise ValueError("chains must have at least 3 draws")
    chain_means = x.mean(axis=0)                      # (C, D)
    chain_vars = x.var(axis=0, ddof=1) if s > 1 else np.zeros((k, d))
    w = chain_vars.mean(axis=0)                       # (D,)
    var_plus = w.copy()
    if k > 1:
        var_plus = var_plus + chain_means.var(axis=0, ddof=1)
    # biased (1/S) autocovariance of every chain by FFT, averaged over chains
    centered = x - chain_means[None]
    freq = np.fft.fft(centered, n=2 * _good_size(s), axis=0)
    acov = np.fft.ifft(np.abs(freq) ** 2, axis=0).real[:s] / s
    macov = acov.mean(axis=1)                         # (S, D)

    rho = np.zeros((s, d))
    rho[0] = 1.0
    rho_even = np.ones(d)
    rho_odd = 1.0 - (w - macov[1]) / var_plus if s > 1 else np.zeros(d)
    if s > 1:
        rho[1] = rho_odd
    t = 1
    active = np.ones(d, dtype=bool)
    max_t = np.full(d, t, dtype=np.int64)
    last_even = rho_even.copy()
    while t < s - 4:
        active = active & ((rho_even + rho_odd) > 0.0)
        max_t[active] = t + 2
        if not active.any():
            break
        new_even = 1.0 - (w - macov[t + 1]) / var_plus
        new_odd = 1.0 - (w - macov[t + 2]) / var_plus
        store = active & ((new_even + new_odd) >= 0.0)
        rho[t + 1] = np.where(store, new_even, rho[t + 1])
        rho[t + 2] = np.where(store, new_odd, rho[t + 2])
        cap = active & (rho[t + 1] + rho[t + 2] > rho[t - 1] + rho[t])
        capped = (rho[t - 1] + rho[t]) / 2.0
        rho[t + 1] = np.where(cap, capped, rho[t + 1])
        rho[t + 2] = np.where(cap, capped, rho[t + 2])
        rho_even = np.where(active, new_even, rho_even)
        rho_odd = np.where(active, new_odd, rho_odd)
        last_even = np.where(active, new_even, last_even)
        t += 2
    max_t[active & ((rho_even + rho_odd) > 0.0)] = t
    max_t = np.minimum(max_t, t)
    cols = np.arange(d)
    tail_idx = np.minimum(max_t + 1, s - 1)
    tail_ok = (last_even > 0.0) & (max_t + 1 < s)
    tail = np.where(tail_ok, last_even, 0.0)
    rho[tail_idx, cols] = np.where(tail_ok, last_even, rho[tail_idx, cols])
    lag = np.arange(s)[:, None]
    head_sum = np.where(lag < max_t[None, :], rho, 0.0).sum(axis=0)
    tau = -1.0 + 2.0 * head_sum + tail
    tau = np.maximum(tau, 1.0 / np.log10(n_total))
    return n_total / tau


def r_hat(draws: np.ndarray) -> np.ndarray:
    """Chain-balanced R-hat of every dimension of ``(S, C, D)`` draws
    (S >= 3): ``sqrt(1 + var(chain means) / mean(chain variances))``."""
    x = np.asarray(draws, dtype=np.float64)
    return np.sqrt(1.0 + x.mean(axis=0).var(axis=0, ddof=1)
                   / x.var(axis=0, ddof=1).mean(axis=0))
