"""Chain-batched warmup and sampling states.

Counterpart of the state part of ``walnuts_tpu/core/sampler.py``: the
carries ``WarmupState`` / ``SampleState``, the frozen tuning
``FrozenParams``, and their constructors, each with a leading chain axis
on every field (the reference vmaps per-chain constructors). The per-draw
classic step functions are not ported yet (ROADMAP.md Queue 1); the
batched scheduler (``core/batched.py``) advances these states.
"""

from __future__ import annotations

from typing import NamedTuple

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
    min_micro_estimate,
    min_micro_init,
)
from walnuts_tpu_torch.core.transition import FailStats


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


__all__ = [
    "FrozenParams",
    "SampleState",
    "WarmupState",
    "freeze_params",
    "init_sample_state",
    "init_warmup_state",
]
