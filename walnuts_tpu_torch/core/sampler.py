"""Chain-batched warmup and sampling states and the classic step functions.

Counterpart of ``walnuts_tpu/core/sampler.py``: the carries
``WarmupState`` / ``SampleState``, the frozen tuning ``FrozenParams`` and
their constructors, each with a leading chain axis on every field (the
reference vmaps per-chain constructors), and the per-draw step functions
of the classic path, ``make_warmup_step`` and ``make_sample_step``, which
advance every chain by one transition in lock step. The batched scheduler
(``core/batched.py``) advances the same states a block at a time.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
from walnuts_tpu_torch.core.adapt import (
    AdamState,
    MassEstimatorState,
    MinMicroState,
    adam_init,
    adam_step_size,
    mass_estimator_init,
    mass_estimator_inv_mass,
    mass_estimator_observe,
    min_micro_estimate,
    min_micro_init,
    min_micro_observe,
)
from walnuts_tpu_torch.core.transition import (
    FailStats,
    TransitionResult,
    TripCounts,
    make_transition,
)
from walnuts_tpu_torch.ops.math import LogpGradFn


class WarmupState(NamedTuple):
    """Carry of the adaptive warmup: key (C, 2) int32, theta (C, D)."""

    key: torch.Tensor
    theta: torch.Tensor
    adam: AdamState
    mass: MassEstimatorState
    min_micro: MinMicroState
    iteration: torch.Tensor  # int32 (C,)
    n_grads: torch.Tensor    # int32 (C,), cumulative gradient evaluations
    fails: FailStats


class WarmupOutput(NamedTuple):
    """What one warmup iteration emits (the ``on_warmup`` payload,
    handlers.hpp:73-89), and what the host counted while it ran."""

    theta: torch.Tensor
    logp: torch.Tensor
    step_size: torch.Tensor
    inv_mass: torch.Tensor
    depth: torch.Tensor
    counts: TripCounts = TripCounts()


class FrozenParams(NamedTuple):
    """Tuning frozen at the end of warmup (adaptive_walnuts.hpp:263-271)."""

    step_size: torch.Tensor  # (C,)
    inv_mass: torch.Tensor   # (C, D)
    min_micro: torch.Tensor  # int32 (C,)


class SampleState(NamedTuple):
    """Carry of fixed-parameter sampling, with the running Welford of the
    draw log densities that feeds the R-hat early stop."""

    key: torch.Tensor
    theta: torch.Tensor
    n_grads: torch.Tensor
    fails: FailStats
    lp_count: torch.Tensor
    lp_mean: torch.Tensor
    lp_m2: torch.Tensor


def init_warmup_state(key, theta, init_mass, step_size,
                      warmup_cfg: WarmupConfig,
                      sampling_cfg: SamplingConfig) -> WarmupState:
    """Warmup carry for every chain: ``key`` (C, 2), ``theta`` and the MASS
    diagonal ``init_mass`` (C, D), ``step_size`` (C,)."""
    c = theta.shape[0]
    dtype, dev = theta.dtype, theta.device
    return WarmupState(
        key=key,
        theta=theta,
        adam=adam_init(
            step_size.to(dtype),
            target_accept=warmup_cfg.step_accept_rate_target,
            lr=warmup_cfg.step_learning_rate,
            b1=warmup_cfg.step_gradient_decay,
            b2=warmup_cfg.step_sq_gradient_decay,
            eps=warmup_cfg.step_stabilization,
            lr_decay=warmup_cfg.step_learn_rate_decay,
        ),
        mass=mass_estimator_init(init_mass.to(dtype), warmup_cfg.mass_init_count),
        min_micro=min_micro_init(c, warmup_cfg.max_macro_steps_target,
                                 sampling_cfg.min_micro_steps, dtype, dev),
        iteration=torch.zeros((c,), dtype=torch.int32, device=dev),
        n_grads=torch.zeros((c,), dtype=torch.int32, device=dev),
        fails=FailStats.zeros(c, dev),
    )


def _add_fails(a: FailStats, b: FailStats) -> FailStats:
    return FailStats(*(x + y for x, y in zip(a, b)))


def make_warmup_step(
    logp_grad: LogpGradFn, sampling_cfg: SamplingConfig, integrator=None,
) -> Callable[[WarmupState], Tuple[WarmupState, WarmupOutput]]:
    """One continuous-warmup iteration of every chain
    (adaptive_walnuts.hpp:234-251): read the current mass, step and
    min-micro estimates, run one transition with Adam observing every
    coarsest macro-step attempt, then feed the selected draw and its score
    back into the estimators with the ``1 - 1/(count0 + t)`` discount."""
    transition = make_transition(
        logp_grad,
        max_depth=sampling_cfg.max_trajectory_doublings,
        max_step_halvings=sampling_cfg.max_step_halvings,
        adapt_step_size=True,
        integrator=integrator,
    )
    max_error = sampling_cfg.max_hamiltonian_error

    def warmup_step(state: WarmupState) -> Tuple[WarmupState, WarmupOutput]:
        inv_mass = mass_estimator_inv_mass(state.mass)
        step = adam_step_size(state.adam)
        min_micro = min_micro_estimate(state.min_micro)
        res = transition(state.key, state.theta, step, inv_mass, min_micro,
                         max_error, state.adam)
        mass = mass_estimator_observe(state.mass, res.theta, res.grad,
                                      state.iteration)
        mm = min_micro_observe(state.min_micro,
                               torch.ones_like(res.depth) << res.depth)
        new_state = WarmupState(
            key=res.key, theta=res.theta, adam=res.adam, mass=mass,
            min_micro=mm, iteration=state.iteration + 1,
            n_grads=state.n_grads + res.n_grads,
            fails=_add_fails(state.fails, res.fails),
        )
        out = WarmupOutput(theta=res.theta, logp=res.logp,
                           step_size=adam_step_size(res.adam),
                           inv_mass=inv_mass, depth=res.depth,
                           counts=res.counts)
        return new_state, out

    return warmup_step


def freeze_params(state: WarmupState) -> FrozenParams:
    return FrozenParams(
        step_size=adam_step_size(state.adam),
        inv_mass=mass_estimator_inv_mass(state.mass),
        min_micro=min_micro_estimate(state.min_micro),
    )


def init_sample_state(state: WarmupState) -> SampleState:
    zero = torch.zeros(state.theta.shape[:1], dtype=state.theta.dtype,
                       device=state.theta.device)
    return SampleState(key=state.key, theta=state.theta,
                       n_grads=state.n_grads, fails=state.fails,
                       lp_count=zero, lp_mean=zero.clone(), lp_m2=zero.clone())


def make_sample_step(
    logp_grad: LogpGradFn, sampling_cfg: SamplingConfig, integrator=None,
) -> Callable[[SampleState, FrozenParams], Tuple[SampleState, TransitionResult]]:
    """One fixed-parameter WALNUTS draw of every chain
    (``WalnutsSampler::operator()``, walnuts.hpp:682-692), plus the running
    log-density Welford that feeds the R-hat early stop."""
    transition = make_transition(
        logp_grad,
        max_depth=sampling_cfg.max_trajectory_doublings,
        max_step_halvings=sampling_cfg.max_step_halvings,
        adapt_step_size=False,
        integrator=integrator,
    )
    max_error = sampling_cfg.max_hamiltonian_error

    def sample_step(state: SampleState, params: FrozenParams
                    ) -> Tuple[SampleState, TransitionResult]:
        dummy_adam = adam_init(params.step_size.to(state.theta.dtype))
        res = transition(state.key, state.theta, params.step_size,
                         params.inv_mass, params.min_micro, max_error,
                         dummy_adam)
        count = state.lp_count + 1.0
        delta = res.logp - state.lp_mean
        mean = state.lp_mean + delta / count
        m2 = state.lp_m2 + delta * (res.logp - mean)
        new_state = SampleState(
            key=res.key, theta=res.theta,
            n_grads=state.n_grads + res.n_grads,
            fails=_add_fails(state.fails, res.fails),
            lp_count=count, lp_mean=mean, lp_m2=m2,
        )
        return new_state, res

    return sample_step


__all__ = [
    "FrozenParams",
    "SampleState",
    "WarmupOutput",
    "WarmupState",
    "freeze_params",
    "init_sample_state",
    "init_warmup_state",
    "make_sample_step",
    "make_warmup_step",
]
