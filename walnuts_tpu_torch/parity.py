"""Tight fixed-window ESS-per-gradient parity statistics.

A NumPy copy of ``walnuts_tpu/parity.py``, so that the PyTorch port
imports no JAX; the reference module is the one to change, keep this copy
in step. The pooled-ESS ratio used for cross-implementation parity carries
30-40 % seed noise at bench shapes; these statistics compare the same
quantity (sampling efficiency per gradient) through estimators whose
standard errors shrink with the chain count.
"""

from __future__ import annotations

import numpy as np

#: fixed autocorrelation window; dim-0 rho_k decays smoothly over this
#: range on the bench posteriors (funnel log-scale / SV mu)
LAGS = 24


def chain_autocorr_stats(draws_c: np.ndarray, lags: int = LAGS):
    """Per-chain rho_1..rho_lags of dim 0. ``draws_c``: (C, N, >=1).

    Liveness = the chain actually moved (any successive difference
    nonzero), not var > 0: a constant float64 series at huge |x| has
    var ~ (eps |x|)^2 > 0 from the mean subtraction's rounding, while a
    float32-origin constant sums exactly to var == 0.
    """
    x = draws_c[:, :, 0]
    C, N = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    var = (xc * xc).mean(axis=1)
    live = np.any(np.diff(x, axis=1) != 0.0, axis=1)
    rho = np.empty((C, lags))
    for k in range(1, lags + 1):
        rho[:, k - 1] = (xc[:, :-k] * xc[:, k:]).sum(axis=1) / (
            N * np.where(var > 0, var, 1.0)
        )
    return rho[live], live, x[live]


def tight_summary(rho_live: np.ndarray, x_live: np.ndarray,
                  sg_per_chain_draw: float) -> dict:
    """Fixed-window ESS fraction + delta-method CI + ESS/grad.

    ``rho_live``: (C_live, lags) per-chain autocorrelations;
    ``x_live``: (C_live, N) dim-0 draws; ``sg_per_chain_draw``: sampling
    gradients per chain-draw under the chosen accounting.
    """
    C = rho_live.shape[0]
    rb = rho_live.mean(axis=0)
    se = rho_live.std(axis=0, ddof=1) / np.sqrt(C)
    tail = 1.0 + 2.0 * rb.sum()
    ess_frac = 1.0 / tail
    # delta method: var(ess_frac) = (2/tail^2)^2 * var(sum rho_bar)
    s = rho_live.sum(axis=1)
    ess_frac_se = (2.0 / tail**2) * s.std(ddof=1) / np.sqrt(C)
    return {
        "chains_live": int(C),
        "rho_bar": rb.round(5).tolist(),
        "rho_bar_se": se.round(6).tolist(),
        "ess_frac": float(ess_frac),
        "ess_frac_se": float(ess_frac_se),
        "dim0_mean": float(x_live.mean()),
        "dim0_mean_se": float(x_live.mean(axis=1).std(ddof=1) / np.sqrt(C)),
        "dim0_var": float(x_live.var()),
        "dim0_var_se": float(x_live.var(axis=1).std(ddof=1) / np.sqrt(C)),
        "grads_per_chain_draw": float(sg_per_chain_draw),
        "ess_per_grad_tight": float(ess_frac / sg_per_chain_draw),
        "ess_per_grad_tight_se": float(ess_frac_se / sg_per_chain_draw),
    }


def tight_ratio(a: dict, b: dict):
    """Ratio of two tight summaries' ESS/grad with propagated SE."""
    r = a["ess_per_grad_tight"] / b["ess_per_grad_tight"]
    rel = np.hypot(
        a["ess_per_grad_tight_se"] / a["ess_per_grad_tight"],
        b["ess_per_grad_tight_se"] / b["ess_per_grad_tight"],
    )
    return float(r), float(r * rel)


__all__ = ["LAGS", "chain_autocorr_stats", "tight_summary", "tight_ratio"]
