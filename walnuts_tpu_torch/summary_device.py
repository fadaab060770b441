"""On-device posterior diagnostics for large runs.

Counterpart of ``walnuts_tpu/summary_device.py``: the estimators of the
host summary (``walnuts_tpu_torch.summary``) for draws that stay on the
device, equal chain lengths only (a ``(chains, N, D)`` tensor, what the
block loops produce):

  - batched FFT autocovariance (biased 1/N, 2x 5-smooth padding), by
    ``torch.fft``;
  - chain-balanced R-hat;
  - Geyer ESS with the initial-positive + initial-monotone paired-lag
    sequence, cross-chain averaged autocovariances, ``var_plus``, the
    antithetic tail and the ``1/log10(N)`` tau floor, vectorized over
    dimensions: a loop over lag pairs whose masks and selections stay on
    the device (no host read per lag);
  - MCSE, and ESS over dimension chunks for very wide posteriors.

Results match the host implementation to float tolerance (tested).
"""

from __future__ import annotations

import math

import torch

from walnuts_tpu_torch.summary import fft_next_good_size


def autocovariance_device(draws: torch.Tensor) -> torch.Tensor:
    """Per-chain autocovariances: (C, N, D) -> (C, N, D)."""
    n = draws.shape[1]
    m2 = 2 * fft_next_good_size(n)
    centered = draws - torch.mean(draws, dim=1, keepdim=True)
    freq = torch.fft.fft(centered, n=m2, dim=1)
    ac = torch.fft.ifft(torch.abs(freq) ** 2, dim=1).real[:, :n, :]
    return ac / n


def r_hat_device(draws: torch.Tensor) -> torch.Tensor:
    """Chain-balanced R-hat: (C, N, D) -> (D,)."""
    mu = torch.mean(draws, dim=1)
    sigma_sq = torch.var(draws, dim=1, correction=1)
    return torch.sqrt(1.0 + torch.var(mu, dim=0, correction=1)
                      / torch.mean(sigma_sq, dim=0))


def effective_sample_size_device(draws: torch.Tensor) -> torch.Tensor:
    """Geyer ESS: (C, N, D) -> (D,). Matches the host implementation."""
    c, n, d = draws.shape
    n_total = c * n
    chain_means = torch.mean(draws, dim=1)
    w = torch.mean(torch.var(draws, dim=1, correction=1), dim=0)  # (D,)
    var_plus = w
    if c > 1:
        var_plus = var_plus + torch.var(chain_means, dim=0, correction=1)
    macov = torch.mean(autocovariance_device(draws), dim=0)  # (N, D)

    rho = torch.zeros((n, d), dtype=draws.dtype, device=draws.device)
    rho[0] = 1.0
    rho_even = torch.ones((d,), dtype=draws.dtype, device=draws.device)
    rho_odd = 1.0 - (w - macov[1]) / var_plus
    rho[1] = rho_odd
    active = torch.ones((d,), dtype=torch.bool, device=draws.device)
    max_t = torch.ones((d,), dtype=torch.int64, device=draws.device)
    last_even = rho_even
    n_pairs = max((n - 4) // 2, 0)  # t = 1, 3, ... while t < n - 4
    for p in range(n_pairs):
        t = 1 + 2 * p
        active = active & ((rho_even + rho_odd) > 0.0)
        max_t = torch.where(active, t + 2, max_t)
        new_even = 1.0 - (w - macov[t + 1]) / var_plus
        new_odd = 1.0 - (w - macov[t + 2]) / var_plus
        store = active & ((new_even + new_odd) >= 0.0)
        r1 = torch.where(store, new_even, rho[t + 1])
        r2 = torch.where(store, new_odd, rho[t + 2])
        cap = active & (r1 + r2 > rho[t - 1] + rho[t])
        capped = (rho[t - 1] + rho[t]) / 2.0
        rho[t + 1] = torch.where(cap, capped, r1)
        rho[t + 2] = torch.where(cap, capped, r2)
        rho_even = torch.where(active, new_even, rho_even)
        rho_odd = torch.where(active, new_odd, rho_odd)
        last_even = torch.where(active, new_even, last_even)
    t_end = 1 + 2 * n_pairs
    max_t = torch.where(active & ((rho_even + rho_odd) > 0.0), t_end, max_t)
    max_t = torch.clamp(max_t, max=t_end)

    # antithetic tail
    tail_ok = (last_even > 0.0) & (max_t + 1 < n)
    tail = torch.where(tail_ok, last_even, torch.zeros_like(last_even))
    lag_idx = torch.arange(n, device=draws.device)[:, None]
    head_sum = torch.sum(torch.where(lag_idx < max_t[None, :], rho,
                                     torch.zeros_like(rho)), dim=0)
    tau_hat = -1.0 + 2.0 * head_sum + tail
    tau_hat = torch.clamp(tau_hat, min=1.0 / math.log10(n_total))
    return n_total / tau_hat


def mcse_device(draws: torch.Tensor) -> torch.Tensor:
    """MCSE = pooled sd / sqrt(ESS), on the device."""
    c, n, d = draws.shape
    sd = torch.std(draws.reshape(c * n, d), dim=0, correction=1)
    return sd / torch.sqrt(effective_sample_size_device(draws))


def effective_sample_size_device_chunked(draws: torch.Tensor,
                                         chunk: int = 64) -> torch.Tensor:
    """Geyer ESS over dimension chunks: the FFT's complex intermediate is
    (C, 2 pad(N), chunk), not (C, 2 pad(N), D), while the draw cube stays
    where it is (a (C, N, D) view, e.g. ``draws.movedim(0, 1)`` of the
    block loops' (N, C, D) tensor, is accepted)."""
    d = draws.shape[2]
    return torch.cat([effective_sample_size_device(draws[:, :, lo:lo + chunk])
                      for lo in range(0, d, chunk)])


__all__ = [
    "autocovariance_device",
    "effective_sample_size_device",
    "effective_sample_size_device_chunked",
    "mcse_device",
    "r_hat_device",
]
