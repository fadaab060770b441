"""The span algebra shared by the WALNUTS transitions, batched over chains.

Counterpart of the shared part of ``walnuts_tpu/core/transition.py``
(index constants, ``span_from_point``, ``span_uturn``, ``span_combine``,
``FailStats``). The per-draw classic transition built on it is not ported
yet (ROADMAP.md Queue 1); the batched scheduler in ``core/batched.py``
uses the constants and ``FailStats``.

A span packs five ``(C, D)`` rows into ``(C, 5, D)`` and four scalars into
``(C, 4)``: rows theta_bk, rho_bk, theta_fw, rho_fw, theta_sel; scalars
logp_bk (joint), logp_fw (joint), logp_sel (position), logw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from walnuts_tpu_torch.ops.math import log_sum_exp

_PH_FWD = 0
_PH_REV = 1

_THETA_BK, _RHO_BK = 0, 1
_THETA_FW, _RHO_FW = 2, 3
_THETA_SEL = 4
_SPAN_ROWS = 5
_LOGP_BK, _LOGP_FW, _LOGP_SEL, _LOGW = 0, 1, 2, 3


def span_from_point(theta, rho, logp_pos, logp_joint):
    """Single-state spans: ``(C, 5, D)`` rows and ``(C, 4)`` scalars."""
    v = torch.stack([theta, rho, theta, rho, theta], dim=1)
    s = torch.stack([logp_joint, logp_joint, logp_pos, logp_joint], dim=1)
    return v, s


def span_uturn(older_v, newer_v, forward, inv_mass) -> torch.Tensor:
    """U-turn test between adjacent spans (walnuts.hpp:192-201): ``older``
    was built first; ``forward`` (C,) is the direction of travel."""
    f = forward[:, None]
    bk_theta = torch.where(f, older_v[:, _THETA_BK], newer_v[:, _THETA_BK])
    bk_rho = torch.where(f, older_v[:, _RHO_BK], newer_v[:, _RHO_BK])
    fw_theta = torch.where(f, newer_v[:, _THETA_FW], older_v[:, _THETA_FW])
    fw_rho = torch.where(f, newer_v[:, _RHO_FW], older_v[:, _RHO_FW])
    delta = inv_mass * (fw_theta - bk_theta)
    return (torch.sum(fw_rho * delta, -1) < 0) | (torch.sum(bk_rho * delta, -1) < 0)


def span_combine(unif, older_v, older_s, newer_v, newer_s, forward,
                 barker: bool):
    """Merge two spans with progressive selection (walnuts.hpp:368-387):
    Barker inside subtrees, Metropolis at the top level."""
    logw_total = log_sum_exp(older_s[:, _LOGW], newer_s[:, _LOGW])
    log_denom = logw_total if barker else older_s[:, _LOGW]
    take_new = torch.log(unif) < (newer_s[:, _LOGW] - log_denom)
    f3 = forward[:, None, None]
    t3 = take_new[:, None, None]
    v = torch.cat([
        torch.where(f3, older_v[:, :2], newer_v[:, :2]),
        torch.where(f3, newer_v[:, 2:4], older_v[:, 2:4]),
        torch.where(t3, newer_v[:, 4:5], older_v[:, 4:5]),
    ], dim=1)
    s = torch.stack([
        torch.where(forward, older_s[:, _LOGP_BK], newer_s[:, _LOGP_BK]),
        torch.where(forward, newer_s[:, _LOGP_FW], older_s[:, _LOGP_FW]),
        torch.where(take_new, newer_s[:, _LOGP_SEL], older_s[:, _LOGP_SEL]),
        logw_total,
    ], dim=1)
    return v, s


class FailStats(NamedTuple):
    """Per-chain failure counters, int32 ``(C,)`` each: macro steps that
    spent every halving (``n_halve_fail``), attempts ending on a
    non-finite log density (``n_nonfinite``), transitions that hit the
    doubling budget (``n_depth_exhausted``)."""

    n_halve_fail: torch.Tensor
    n_nonfinite: torch.Tensor
    n_depth_exhausted: torch.Tensor

    @staticmethod
    def zeros(num_chains: int, device) -> "FailStats":
        z = lambda: torch.zeros((num_chains,), dtype=torch.int32, device=device)
        return FailStats(z(), z(), z())


__all__ = ["FailStats", "span_combine", "span_from_point", "span_uturn"]
