"""Posterior summary statistics and the ``Summarizer`` API.

A copy of ``walnuts_tpu/summary.py``, kept NumPy-only so that the PyTorch port
imports no JAX (``walnuts_tpu/__init__.py`` pulls JAX in through ``api``).
The reference module is the one to change; keep this copy in step.

Host-side (NumPy) reimplementation of the reference's analysis layer:
the statistics of ``include/walnutpie/summary.hpp`` behind the Python
surface of ``python/src/walnutpie/summary.py``. Chains may be ragged
(different lengths); every formula matches the reference:

  - autocovariance: FFT with 5-smooth padding, biased 1/N normalization
    per Geyer (1992) (summary.hpp:39-91);
  - quantiles: R type-7 / NumPy 'linear' (summary.hpp:484-514);
  - R-hat: equal chain weights, Margossian (2025) variance term,
    ``sqrt(1 + var(means) / mean(vars))`` (summary.hpp:594-619);
  - ESS: Geyer initial-positive + initial-monotone paired-lag sequence on
    cross-chain-averaged autocovariances, ``var_plus = W + var(means)``,
    antithetic tail, floor ``tau >= 1/log10(N)`` (summary.hpp:664-749);
  - MCSE: ``sd / sqrt(ESS)`` (summary.hpp:765-769).

The Geyer lag loop is vectorized across dimensions with an active-mask so
thousands-of-dimensional posteriors from 4096-chain runs summarize fast.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

ChainsLike = Union[Sequence[np.ndarray], np.ndarray]


def _as_chain_list(draws: ChainsLike) -> List[np.ndarray]:
    """Normalize input to a list of (N_k, D) float arrays.

    Accepts a list of per-chain matrices (possibly ragged) or a single
    (chains, N, D) array.
    """
    if isinstance(draws, np.ndarray) and draws.ndim == 3:
        chains = [np.asarray(draws[c], dtype=np.float64) for c in range(draws.shape[0])]
    else:
        chains = [np.asarray(c, dtype=np.float64) for c in draws]
    if len(chains) == 0:
        raise ValueError("chains cannot be empty.")
    dims = chains[0].shape[1] if chains[0].ndim == 2 else None
    for c in chains:
        if c.ndim != 2:
            raise ValueError("each chain must be a matrix with one row per draw.")
        if c.shape[0] == 0:
            raise ValueError("chains must have at least one draw.")
        if c.shape[1] != dims:
            raise ValueError("all chains must have same number of columns.")
    return chains


def fft_next_good_size(n: int) -> int:
    """Smallest m >= n whose prime factors are all in {2, 3, 5}
    (summary.hpp:39-52)."""
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


def _autocovariance_chain(chain: np.ndarray) -> np.ndarray:
    """Biased (1/N) autocovariance at all lags for one chain via FFT
    (summary.hpp:55-91)."""
    n = chain.shape[0]
    m2 = 2 * fft_next_good_size(n)
    centered = chain - chain.mean(axis=0, keepdims=True)
    freq = np.fft.fft(centered, n=m2, axis=0)
    ac = np.fft.ifft(np.abs(freq) ** 2, axis=0).real[:n]
    return ac / n


def autocovariance(draws: ChainsLike) -> np.ndarray:
    """Per-chain autocovariances stacked row-wise, shape (sum N_k, D)
    (summary.hpp:529-545)."""
    chains = _as_chain_list(draws)
    return np.concatenate([_autocovariance_chain(c) for c in chains], axis=0)


def mean(draws: ChainsLike) -> np.ndarray:
    """Posterior mean over all draws of all chains (summary.hpp:370-378)."""
    chains = _as_chain_list(draws)
    return np.concatenate(chains, axis=0).mean(axis=0)


def variance(draws: ChainsLike) -> np.ndarray:
    """Pooled sample variance (ddof=1) over all draws (summary.hpp:396-405)."""
    chains = _as_chain_list(draws)
    return np.concatenate(chains, axis=0).var(axis=0, ddof=1)


def standard_deviation(draws: ChainsLike) -> np.ndarray:
    """Pooled sample standard deviation (ddof=1) (summary.hpp:423-426)."""
    return np.sqrt(variance(draws))


def quantiles(draws: ChainsLike, probs) -> np.ndarray:
    """Empirical quantiles, R type-7 / NumPy 'linear' (summary.hpp:483-514).

    Returns shape (len(probs), D).
    """
    probs = np.atleast_1d(np.asarray(probs, dtype=np.float64))
    if np.any(~(probs >= 0)) or np.any(~(probs <= 1)):
        raise ValueError("probs must be in [0, 1]")
    chains = _as_chain_list(draws)
    stacked = np.concatenate(chains, axis=0)
    return np.quantile(stacked, probs, axis=0, method="linear")


def r_hat(draws: ChainsLike) -> np.ndarray:
    """Chain-balanced ragged R-hat (summary.hpp:593-619)."""
    chains = _as_chain_list(draws)
    if len(chains) < 2:
        raise ValueError("require at least two chains to compute R-hat")
    for c in chains:
        if c.shape[0] < 3:
            raise ValueError("each chain must have at least 3 draws")
    mu = np.stack([c.mean(axis=0) for c in chains])  # (K, D)
    sigma_sq = np.stack([c.var(axis=0, ddof=1) for c in chains])
    return np.sqrt(1.0 + mu.var(axis=0, ddof=1) / sigma_sq.mean(axis=0))


def effective_sample_size(draws: ChainsLike) -> np.ndarray:
    """Geyer-sequence ESS with cross-chain variance adjustment
    (summary.hpp:663-749), vectorized over dimensions."""
    chains = _as_chain_list(draws)
    n_total = sum(c.shape[0] for c in chains)
    if n_total < 3:
        raise ValueError("chains must have at least 3 draws")
    k = len(chains)
    d = chains[0].shape[1]
    min_len = min(c.shape[0] for c in chains)

    chain_means = np.stack([c.mean(axis=0) for c in chains])  # (K, D)
    chain_vars = np.stack([c.var(axis=0, ddof=1) for c in chains])
    w = chain_vars.mean(axis=0)  # (D,)
    var_plus = w.copy()
    if k > 1:
        var_plus = var_plus + chain_means.var(axis=0, ddof=1)

    # cross-chain mean autocovariance at each lag, truncated to min_len
    macov = np.zeros((min_len, d))
    for c in chains:
        macov += _autocovariance_chain(c)[:min_len]
    macov /= k

    rho = np.zeros((min_len, d))
    rho[0] = 1.0
    rho_even = np.ones(d)
    rho_odd = 1.0 - (w - macov[1]) / var_plus
    rho[1] = rho_odd

    t = 1
    active = np.ones(d, dtype=bool)
    max_t = np.full(d, t, dtype=np.int64)
    last_even = rho_even.copy()
    # Geyer's initial positive + initial monotone sequence on paired lags
    # (summary.hpp:716-732). All active dims share the lag index; a dim
    # freezes when its pair sum turns non-positive.
    while t < min_len - 4:
        active = active & ((rho_even + rho_odd) > 0.0)
        max_t[active] = t + 2
        if not active.any():
            break
        new_even = 1.0 - (w - macov[t + 1]) / var_plus
        new_odd = 1.0 - (w - macov[t + 2]) / var_plus
        store = active & ((new_even + new_odd) >= 0.0)
        rho[t + 1] = np.where(store, new_even, rho[t + 1])
        rho[t + 2] = np.where(store, new_odd, rho[t + 2])
        # initial positive -> initial monotone
        cap = active & (rho[t + 1] + rho[t + 2] > rho[t - 1] + rho[t])
        capped = (rho[t - 1] + rho[t]) / 2.0
        rho[t + 1] = np.where(cap, capped, rho[t + 1])
        rho[t + 2] = np.where(cap, capped, rho[t + 2])
        rho_even = np.where(active, new_even, rho_even)
        rho_odd = np.where(active, new_odd, rho_odd)
        last_even = np.where(active, new_even, last_even)
        t += 2
    # dims still active when the lag budget ran out stop at the current t
    max_t[active & ((rho_even + rho_odd) > 0.0)] = t
    max_t = np.minimum(max_t, t)

    # antithetic-tail correction (summary.hpp:735-741)
    cols = np.arange(d)
    tail_idx = np.minimum(max_t + 1, min_len - 1)
    tail_ok = (last_even > 0.0) & (max_t + 1 < min_len)
    tail = np.where(tail_ok, last_even, 0.0)
    rho[tail_idx, cols] = np.where(tail_ok, last_even, rho[tail_idx, cols])

    lag_idx = np.arange(min_len)[:, None]
    head_sum = np.where(lag_idx < max_t[None, :], rho, 0.0).sum(axis=0)
    tau_hat = -1.0 + 2.0 * head_sum + tail
    tau_hat = np.maximum(tau_hat, 1.0 / np.log10(n_total))
    return n_total / tau_hat


def monte_carlo_standard_error(draws: ChainsLike) -> np.ndarray:
    """MCSE = sd / sqrt(ESS) (summary.hpp:764-769)."""
    return standard_deviation(draws) / np.sqrt(effective_sample_size(draws))


#: Short aliases matching the reference Python package (summary.py:148-271).
ess = effective_sample_size
mcse = monte_carlo_standard_error


class Summarizer:
    """Holds multivariate MCMC draws and provides summary statistics.

    Mirrors ``walnutpie.Summarizer`` (python/src/walnutpie/summary.py:11-145):
    construct from a list of per-chain draw matrices (possibly ragged), then
    call ``mean`` / ``variance`` / ``standard_deviation`` / ``ess`` /
    ``r_hat`` / ``mcse`` (plus ``quantiles``, exposed directly here instead
    of only in C++).
    """

    def __init__(self, draws: ChainsLike):
        self._chains = _as_chain_list(draws)
        self._stacked = np.concatenate(self._chains, axis=0)
        self._num_draws, self._num_params = self._stacked.shape
        self._num_chains = len(self._chains)

    @property
    def num_chains(self) -> int:
        return self._num_chains

    @property
    def num_draws(self) -> int:
        return self._num_draws

    @property
    def num_params(self) -> int:
        return self._num_params

    def mean(self) -> np.ndarray:
        return self._stacked.mean(axis=0)

    def variance(self) -> np.ndarray:
        return self._stacked.var(axis=0, ddof=1)

    def standard_deviation(self) -> np.ndarray:
        return self._stacked.std(axis=0, ddof=1)

    def quantiles(self, probs) -> np.ndarray:
        return quantiles(self._chains, probs)

    def ess(self) -> np.ndarray:
        return effective_sample_size(self._chains)

    def r_hat(self) -> np.ndarray:
        return r_hat(self._chains)

    def mcse(self) -> np.ndarray:
        return monte_carlo_standard_error(self._chains)


__all__ = [
    "Summarizer",
    "autocovariance",
    "effective_sample_size",
    "ess",
    "fft_next_good_size",
    "mcse",
    "mean",
    "monte_carlo_standard_error",
    "quantiles",
    "r_hat",
    "standard_deviation",
    "variance",
]
