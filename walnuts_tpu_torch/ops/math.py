"""Core math primitives, batched over a leading chain axis.

Counterpart of ``walnuts_tpu/ops/math.py``. Positions, momenta and
gradients are ``(C, D)``; log densities and step sizes are ``(C,)``. Model
failures are value-level, as in the reference: a NaN log density becomes
``-inf`` and non-finite gradient entries become zero, so a bad proposal is
rejected and sampling continues.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

#: target: theta (C, D) -> log density (C,)
LogDensityFn = Callable[[torch.Tensor], torch.Tensor]
#: fused target: theta (C, D) -> (log density (C,), gradient (C, D))
LogpGradFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def log_sum_exp(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Elementwise stable ``log(exp(x1) + exp(x2))``: NaN inputs give NaN,
    matched infinities give that infinity, ``-inf`` is the identity."""
    m = torch.maximum(x1, x2)
    mn = torch.minimum(x1, x2)
    safe = m + torch.log1p(torch.exp(mn - m))
    out = torch.where(torch.isinf(m), m, safe)
    return torch.where(torch.isnan(x1) | torch.isnan(x2),
                       torch.full_like(out, float("nan")), out)


def logp_momentum(rho: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    """``-0.5 * sum(inv_mass * rho**2)`` over the last axis."""
    return -0.5 * torch.sum(inv_mass * torch.square(rho), dim=-1)


def sanitize_logp_grad(logp: torch.Tensor, grad: torch.Tensor):
    """NaN or ``+inf`` log density -> ``-inf``; non-finite gradient -> 0."""
    bad = torch.isnan(logp) | (logp == float("inf"))
    logp = torch.where(bad, torch.full_like(logp, float("-inf")), logp)
    grad = torch.where(torch.isfinite(grad), grad, torch.zeros_like(grad))
    return logp, grad


def make_logp_grad(logp_fn: LogDensityFn) -> LogpGradFn:
    """Sanitized value and gradient of a batched log density by autograd.

    Chains are independent, so one backward pass of the batch SUM gives
    every chain's gradient (the sum's backward seeds each chain with 1).
    """

    def logp_grad(theta: torch.Tensor):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            lp = logp_fn(th)
            (grad,) = torch.autograd.grad(lp.sum(), th)
        return sanitize_logp_grad(lp.detach(), grad)

    return logp_grad


def leapfrog_step(logp_grad: LogpGradFn, inv_mass, step, theta, rho, grad):
    """One leapfrog micro step per chain; ``step`` is ``(C, 1)`` (signed).

        rho   += step/2 * grad
        theta += step * inv_mass .* rho
        logp, grad = logp_grad(theta)
        rho   += step/2 * grad
    """
    half = 0.5 * step
    rho_half = rho + half * grad
    theta_next = theta + step * inv_mass * rho_half
    logp_next, grad_next = logp_grad(theta_next)
    rho_next = rho_half + half * grad_next
    return theta_next, rho_next, grad_next, logp_next


def leapfrog_error(logp_grad: LogpGradFn, theta, rho, inv_mass, step,
                   logp0=None, grad0=None) -> torch.Tensor:
    """Signed change of the joint log density across one leapfrog step per
    chain (``step`` is ``(C,)``). ``logp0``/``grad0`` at ``theta`` may be
    passed in when already known."""
    if logp0 is None:
        logp0, grad0 = logp_grad(theta)
    h0 = logp0 + logp_momentum(rho, inv_mass)
    _, rho1, _, logp1 = leapfrog_step(logp_grad, inv_mass, step[:, None],
                                      theta, rho, grad0)
    return logp1 + logp_momentum(rho1, inv_mass) - h0


def adapt_step_size(key, logp_grad: LogpGradFn, theta, mass, step,
                    max_doublings: int = 64) -> torch.Tensor:
    """Coarse initial step-size search per chain (the reference's
    ``adapt_step_size``): one momentum per chain, then double while the
    one-step acceptance exceeds 0.9 and shrink by ``sqrt(1/2)`` until it
    exceeds 0.6, each phase capped at ``max_doublings``. ``key`` (C, 2),
    ``theta``/``mass`` (C, D), ``step`` (C,). Lanes that stopped keep
    their step; the loops run while any lane continues."""
    from walnuts_tpu_torch.ops import prng

    dtype = theta.dtype
    inv_mass = 1.0 / mass
    z = prng.normal(key, theta.shape[1:], dtype)
    rho = z * torch.sqrt(mass)
    log_09 = torch.log(torch.tensor(0.9, dtype=dtype, device=theta.device))
    log_06 = torch.log(torch.tensor(0.6, dtype=dtype, device=theta.device))
    inv_sqrt2 = torch.sqrt(torch.tensor(0.5, dtype=dtype, device=theta.device))
    logp0, grad0 = logp_grad(theta)

    def err(s):
        return leapfrog_error(logp_grad, theta, rho, inv_mass, s, logp0, grad0)

    step = step.to(dtype)
    it = torch.zeros_like(step, dtype=torch.int32)
    go = (err(step) > log_09) & (it < max_doublings)
    while bool(go.any()):
        step = torch.where(go, step * 2.0, step)
        it = it + go.to(torch.int32)
        go = (err(step) > log_09) & (it < max_doublings)
    it = torch.zeros_like(it)
    go = (err(step) < log_06) & (it < max_doublings)
    while bool(go.any()):
        step = torch.where(go, step * inv_sqrt2, step)
        it = it + go.to(torch.int32)
        go = (err(step) < log_06) & (it < max_doublings)
    return step


def count_trailing_zeros(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero bits of a positive int32 tensor: the exponent of its
    lowest set bit (exact through float64's ``frexp``)."""
    low_bit = x & -x
    _, exponent = torch.frexp(low_bit.to(torch.float64))
    return (exponent - 1).to(torch.int32)


__all__ = [
    "LogDensityFn",
    "LogpGradFn",
    "adapt_step_size",
    "count_trailing_zeros",
    "leapfrog_error",
    "leapfrog_step",
    "log_sum_exp",
    "logp_momentum",
    "make_logp_grad",
    "sanitize_logp_grad",
]
