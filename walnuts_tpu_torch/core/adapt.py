"""Warmup adaptation state, batched over a leading chain axis.

Counterpart of ``walnuts_tpu/core/adapt.py``: Adam on the log step size,
discounted Welford moments, the Fisher-divergence diagonal mass estimator
and the min-micro-step estimator. Each state is a NamedTuple whose fields
carry the chain axis first — scalars per chain are ``(C,)`` and
per-coordinate fields ``(C, D)`` — with the same field names as the
reference's (vmapped) states, so ``walnuts_tpu_torch.convert`` maps one
onto the other. Updates are pure functions, as in the reference.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def _col(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-chain ``(C,)`` tensor against ``like`` ``(C, ...)``."""
    return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))


class AdamState(NamedTuple):
    """Adam on the log step size (adam.hpp:35-109); every field ``(C,)``."""

    log_step: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    b1_pow: torch.Tensor
    b2_pow: torch.Tensor
    target_accept: torch.Tensor
    lr: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    eps: torch.Tensor
    lr_decay: torch.Tensor


def adam_init(step_size_init: torch.Tensor, target_accept=0.8, lr=0.05,
              b1=0.8, b2=0.9, eps=1e-4, lr_decay=0.5) -> AdamState:
    """Adam state per chain from a ``(C,)`` initial step size."""
    f = lambda x: torch.full_like(step_size_init, x)
    return AdamState(
        log_step=torch.log(step_size_init),
        m=f(0.0), v=f(0.0), t=f(0.0), b1_pow=f(1.0), b2_pow=f(1.0),
        target_accept=f(target_accept), lr=f(lr), b1=f(b1), b2=f(b2),
        eps=f(eps), lr_decay=f(lr_decay),
    )


def adam_update(state: AdamState, accept: torch.Tensor) -> AdamState:
    """One Adam observation of an acceptance probability (adam.hpp:70-86)."""
    t = state.t + 1.0
    b1_pow = state.b1_pow * state.b1
    b2_pow = state.b2_pow * state.b2
    grad = state.target_accept - accept
    m = state.b1 * state.m + (1.0 - state.b1) * grad
    v = state.b2 * state.v + (1.0 - state.b2) * grad * grad
    m_hat = m / (1.0 - b1_pow)
    v_hat = v / (1.0 - b2_pow)
    lr_t = state.lr / torch.pow(t, state.lr_decay)
    log_step = state.log_step - lr_t * m_hat / (torch.sqrt(v_hat) + state.eps)
    return state._replace(log_step=log_step, m=m, v=v, t=t, b1_pow=b1_pow,
                          b2_pow=b2_pow)


def adam_step_size(state: AdamState) -> torch.Tensor:
    return torch.exp(state.log_step)


class OnlineMomentsState(NamedTuple):
    """Exponentially discounted Welford moments (online_moments.hpp):
    ``weight`` ``(C,)``, ``mean`` and ``sum_sq_dev`` ``(C, D)``."""

    weight: torch.Tensor
    mean: torch.Tensor
    sum_sq_dev: torch.Tensor


def online_moments_init(init_weight, init_mean: torch.Tensor,
                        init_variance: torch.Tensor) -> OnlineMomentsState:
    w = torch.full(init_mean.shape[:1], float(init_weight),
                   dtype=init_mean.dtype, device=init_mean.device)
    return OnlineMomentsState(weight=w, mean=init_mean,
                              sum_sq_dev=_col(w, init_mean) * init_variance)


def online_moments_observe(state: OnlineMomentsState, discount: torch.Tensor,
                           y: torch.Tensor) -> OnlineMomentsState:
    """Discount the past by ``discount`` ``(C,)``, then fold in ``y``
    ``(C, D)`` with weight 1. Each product is rounded on its own (no FMA),
    as the reference's batched warmup pass computes it."""
    weight = discount * state.weight + 1.0
    delta = y - state.mean
    mean = state.mean + delta / _col(weight, y)
    sum_sq_dev = _col(discount, y) * state.sum_sq_dev + delta * (y - mean)
    return OnlineMomentsState(weight=weight, mean=mean, sum_sq_dev=sum_sq_dev)


def online_moments_variance(state: OnlineMomentsState) -> torch.Tensor:
    """MLE variance, or ones where nothing has been observed."""
    w = _col(state.weight, state.sum_sq_dev)
    var = state.sum_sq_dev / w
    return torch.where(w > 0, var, torch.ones_like(var))


class MassEstimatorState(NamedTuple):
    """Fisher-divergence diagonal mass estimator
    (adaptive_walnuts.hpp:25-105): ``inv_mass = sqrt(var(draws) /
    var(scores))`` with discount ``1 - 1/(init_count + t)``."""

    draws: OnlineMomentsState
    scores: OnlineMomentsState
    init_count: torch.Tensor


def mass_estimator_init(init_mass: torch.Tensor,
                        mass_init_count) -> MassEstimatorState:
    """``init_mass`` ``(C, D)`` is the MASS diagonal: score variance starts
    at M and draw variance at 1/M."""
    zero = torch.zeros_like(init_mass)
    return MassEstimatorState(
        draws=online_moments_init(mass_init_count, zero, 1.0 / init_mass),
        scores=online_moments_init(mass_init_count, zero, init_mass),
        init_count=torch.full(init_mass.shape[:1], float(mass_init_count),
                              dtype=init_mass.dtype, device=init_mass.device),
    )


def mass_estimator_observe(state: MassEstimatorState, theta, grad,
                           iteration: torch.Tensor) -> MassEstimatorState:
    discount = 1.0 - 1.0 / (state.init_count + iteration.to(state.init_count.dtype))
    return state._replace(
        draws=online_moments_observe(state.draws, discount, theta),
        scores=online_moments_observe(state.scores, discount, grad),
    )


def mass_estimator_inv_mass(state: MassEstimatorState) -> torch.Tensor:
    """The inverse-mass diagonal ``(C, D)``. A 0/0 quotient (both variances
    underflowed: a frozen coordinate) falls back to 1, and the result is
    clamped to ``[sqrt(tiny), 1/sqrt(tiny)]`` so that momenta
    ``z / sqrt(inv_mass)`` and their squares stay finite (the reference's
    reasons, core/adapt.py:178-209)."""
    inv = torch.sqrt(online_moments_variance(state.draws)
                     / online_moments_variance(state.scores))
    inv = torch.where(torch.isnan(inv), torch.ones_like(inv), inv)
    # sqrt(tiny) is a power of two (2^-63, 2^-511), exact as a Python float:
    # a tensor made from a host number would be a copy that waits for the
    # stream, which a CUDA graph's capture refuses
    tiny = math.sqrt(torch.finfo(inv.dtype).tiny)
    return torch.clamp(inv, tiny, 1.0 / tiny)


class MinMicroState(NamedTuple):
    """Minimum micro-step-count estimator (adaptive_walnuts.hpp:119-164);
    every field ``(C,)``, ``floor`` int32."""

    total_macro_steps: torch.Tensor
    count: torch.Tensor
    target: torch.Tensor
    floor: torch.Tensor


def min_micro_init(num_chains: int, target_macro_steps, min_micro_steps,
                   dtype, device) -> MinMicroState:
    f = lambda x, dt=dtype: torch.full((num_chains,), x, dtype=dt, device=device)
    return MinMicroState(total_macro_steps=f(2.0), count=f(1.0),
                         target=f(float(target_macro_steps)),
                         floor=f(int(min_micro_steps), torch.int32))


def min_micro_observe(state: MinMicroState, macro_steps) -> MinMicroState:
    return state._replace(
        total_macro_steps=state.total_macro_steps
        + macro_steps.to(state.count.dtype),
        count=state.count + 1.0,
    )


def min_micro_estimate(state: MinMicroState) -> torch.Tensor:
    mean_macro = state.total_macro_steps / state.count
    # std::lround: half away from zero; values are positive here
    est = torch.floor(mean_macro / state.target + 0.5).to(torch.int32)
    return torch.maximum(state.floor, est)


def nutpie_init_mass(grad: torch.Tensor, mass_smoothing) -> torch.Tensor:
    """Nutpie gradient-based mass initialization (config.hpp:360-382):
    ``mass = (1 - s) * |grad| + s``."""
    return (1.0 - mass_smoothing) * torch.abs(grad) + mass_smoothing


def tree_where(pred: torch.Tensor, new, old):
    """Per-chain select over a NamedTuple of chain-batched tensors
    (nested NamedTuples included)."""
    if isinstance(old, tuple):
        return type(old)(*(tree_where(pred, n, o) for n, o in zip(new, old)))
    return torch.where(_col(pred, old), new, old)


__all__ = [
    "AdamState",
    "MassEstimatorState",
    "MinMicroState",
    "OnlineMomentsState",
    "adam_init",
    "adam_step_size",
    "adam_update",
    "mass_estimator_init",
    "mass_estimator_inv_mass",
    "mass_estimator_observe",
    "min_micro_estimate",
    "min_micro_init",
    "min_micro_observe",
    "nutpie_init_mass",
    "online_moments_init",
    "online_moments_observe",
    "online_moments_variance",
    "tree_where",
]
