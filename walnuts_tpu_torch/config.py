"""Configuration objects for the WALNUTS TPU framework.

A copy of ``walnuts_tpu/config.py``, kept NumPy-only so that the PyTorch port
imports no JAX (``walnuts_tpu/__init__.py`` pulls JAX in through ``api``).
The reference module is the one to change; keep this copy in step.

Single source of truth for all tuning parameters. The reference spreads the
configuration surface over three tiers (C++ fluent setters in
``include/walnutpie/config.hpp``, ~30 flattened scalars over the C ABI in
``python/src/walnutpie/walnutpy.cpp:134-149``, and Python kwargs in
``python/src/walnutpie/pyfunc.py:45-82``); here it collapses into frozen
dataclasses with validation at construction, which are also valid JAX
static arguments (hashable, immutable).

Defaults mirror the reference defaults exactly:
  - warmup defaults:   include/walnutpie/config.hpp:626-640
  - sampling defaults: include/walnutpie/config.hpp:947-953
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


def _check_finite_positive(value: float, name: str) -> None:
    if not (math.isfinite(value) and value > 0):
        raise ValueError(f"{name} must be finite and positive; found {name} = {value}")


def _check_nonnegative(value: float, name: str) -> None:
    if not (math.isfinite(value) and value >= 0):
        raise ValueError(f"{name} must be finite and non-negative; found {name} = {value}")


def _check_positive_int(value: int, name: str) -> None:
    if not (isinstance(value, int) and value > 0):
        raise ValueError(f"{name} must be a positive integer; found {name} = {value}")


def _check_nonnegative_int(value: int, name: str) -> None:
    if not (isinstance(value, int) and value >= 0):
        raise ValueError(f"{name} must be a non-negative integer; found {name} = {value}")


def _check_probability(value: float, name: str) -> None:
    if not (0.0 < value < 1.0):
        raise ValueError(f"{name} must be in (0, 1); found {name} = {value}")


@dataclass(frozen=True)
class SamplingConfig:
    """Configuration of the core WALNUTS sampler and the sampling run.

    Mirrors ``walnutpie::SamplingConfig`` (config.hpp:885-954).

    Attributes:
      min_iter: minimum number of sampling iterations (>= 0).
      max_iter: maximum number of sampling iterations (>= min_iter).
      max_trajectory_doublings: maximum NUTS tree depth (positive).
      max_step_halvings: maximum number of within-orbit step halvings
        (positive).
      min_micro_steps: minimum number of leapfrog micro steps per macro
        step (positive).
      max_hamiltonian_error: maximum |Delta H| allowed at macro steps
        (finite, positive).
      rhat_converge_tol: cross-chain R-hat threshold for early stopping
        of sampling (> 1).
      block_size: iterations per jitted convergence block (the TPU-native
        analog of the reference controller's polling cadence,
        sampler.hpp:121).
    """

    min_iter: int = 50
    max_iter: int = 1000
    max_trajectory_doublings: int = 5
    max_step_halvings: int = 5
    min_micro_steps: int = 1
    max_hamiltonian_error: float = 0.5
    rhat_converge_tol: float = 1.01
    block_size: int = 25

    def __post_init__(self) -> None:
        _check_nonnegative_int(self.min_iter, "min_iter")
        _check_nonnegative_int(self.max_iter, "max_iter")
        if self.max_iter < self.min_iter:
            raise ValueError(
                "max_iter must be >= min_iter; found "
                f"min_iter = {self.min_iter}, max_iter = {self.max_iter}"
            )
        _check_positive_int(self.max_trajectory_doublings, "max_trajectory_doublings")
        _check_positive_int(self.max_step_halvings, "max_step_halvings")
        _check_positive_int(self.min_micro_steps, "min_micro_steps")
        _check_finite_positive(self.max_hamiltonian_error, "max_hamiltonian_error")
        if not (math.isfinite(self.rhat_converge_tol) and self.rhat_converge_tol > 1.0):
            raise ValueError(
                "rhat_converge_tol must be finite and > 1; found "
                f"rhat_converge_tol = {self.rhat_converge_tol}"
            )
        _check_positive_int(self.block_size, "block_size")


@dataclass(frozen=True)
class WarmupConfig:
    """Configuration of the continuous (Nutpie-style) warmup.

    Mirrors ``walnutpie::WarmupConfig`` (config.hpp:513-641); defaults from
    config.hpp:626-640.

    Attributes:
      min_iter: minimum number of warmup iterations.
      max_iter: maximum number of warmup iterations.
      step_size_converge_tol: relative convergence tolerance of per-chain
        step sizes vs the cross-chain geometric mean.
      mass_converge_tol: relative L2 convergence tolerance of per-chain
        inverse mass matrices vs the cross-chain geometric mean.
      mass_init_count: pseudo-observation count of the initial mass matrix
        in the discounted Welford estimators.
      mass_additive_smoothing: additive smoothing for the Nutpie gradient
        based mass-matrix initialization.
      max_macro_steps_target: target expected number of macro steps per
        trajectory, controlled via the minimum micro-step count.
      step_size_init: initial step size before the heuristic search.
      step_accept_rate_target: Adam target acceptance rate.
      step_learning_rate: Adam learning rate on log step size.
      step_gradient_decay: Adam beta1.
      step_sq_gradient_decay: Adam beta2.
      step_stabilization: Adam epsilon.
      step_learn_rate_decay: Adam learning-rate decay exponent (lr / t^decay).
      block_size: iterations per jitted convergence block. This is the
        TPU-native analog of the reference's ``publish_stride``/poll cadence
        (adapt.hpp:124-126): chains run in lockstep blocks and the
        convergence reduction happens between blocks instead of through a
        lock-free mailbox.
    """

    min_iter: int = 50
    max_iter: int = 1000
    step_size_converge_tol: float = 0.1
    mass_converge_tol: float = 1.0
    mass_init_count: float = 4.0
    mass_additive_smoothing: float = 1e-5
    max_macro_steps_target: float = 15.0
    step_size_init: float = 1.0
    step_accept_rate_target: float = 0.8
    step_learning_rate: float = 0.05
    step_gradient_decay: float = 0.8
    step_sq_gradient_decay: float = 0.9
    step_stabilization: float = 1e-4
    step_learn_rate_decay: float = 0.5
    block_size: int = 25

    def __post_init__(self) -> None:
        _check_nonnegative_int(self.min_iter, "min_iter")
        _check_nonnegative_int(self.max_iter, "max_iter")
        if self.max_iter < self.min_iter:
            raise ValueError(
                "max_iter must be >= min_iter; found "
                f"min_iter = {self.min_iter}, max_iter = {self.max_iter}"
            )
        _check_finite_positive(self.step_size_converge_tol, "step_size_converge_tol")
        _check_finite_positive(self.mass_converge_tol, "mass_converge_tol")
        _check_finite_positive(self.mass_init_count, "mass_init_count")
        _check_nonnegative(self.mass_additive_smoothing, "mass_additive_smoothing")
        _check_finite_positive(self.max_macro_steps_target, "max_macro_steps_target")
        _check_finite_positive(self.step_size_init, "step_size_init")
        _check_probability(self.step_accept_rate_target, "step_accept_rate_target")
        _check_finite_positive(self.step_learning_rate, "step_learning_rate")
        _check_finite_positive(self.step_gradient_decay, "step_gradient_decay")
        _check_finite_positive(self.step_sq_gradient_decay, "step_sq_gradient_decay")
        _check_nonnegative(self.step_stabilization, "step_stabilization")
        _check_nonnegative(self.step_learn_rate_decay, "step_learn_rate_decay")
        _check_positive_int(self.block_size, "block_size")


@dataclass(frozen=True)
class InitConfig:
    """Initialization configuration.

    Mirrors ``walnutpie::InitConfig`` / ``InitChainConfig``
    (config.hpp:25-185) plus the Python-level knobs from pyfunc.py:53-58.
    Per-chain arrays (positions, masses, step sizes) are built by the
    runtime from these knobs plus the PRNG key; explicit per-chain values
    flow through the ``walnuts`` API directly as arrays.

    Attributes:
      init_radius: standard deviation of the zero-centered normal used for
        random position initialization (pyfunc.py:109-110).
      step_size_init: initial step size before the heuristic search.
      adapt_init_step: run the coarse grow/shrink step-size search
        (util.hpp:285-303) before warmup.
    """

    init_radius: float = 2.0
    step_size_init: float = 1.0
    adapt_init_step: bool = True

    def __post_init__(self) -> None:
        _check_finite_positive(self.init_radius, "init_radius")
        _check_finite_positive(self.step_size_init, "step_size_init")


@dataclass(frozen=True)
class WalnutsConfig:
    """Top-level configuration bundling init, warmup, and sampling.

    Mirrors ``walnutpie::WalnutsConfig`` (config.hpp:1089-1137). Drives
    the end-to-end API via :meth:`to_kwargs`::

        cfg = WalnutsConfig(sampling=SamplingConfig(max_iter=2000))
        draws = walnuts(logp, num_params=d, **cfg.to_kwargs())
    """

    init: InitConfig = dataclasses.field(default_factory=InitConfig)
    warmup: WarmupConfig = dataclasses.field(default_factory=WarmupConfig)
    sampling: SamplingConfig = dataclasses.field(default_factory=SamplingConfig)

    def to_kwargs(self) -> dict:
        """Flatten into the keyword arguments of :func:`walnuts_tpu.walnuts`
        (the single-tier analog of the C ABI's config flattening,
        walnutpy.cpp:134-149).

        ``block_size`` comes from the sampling config; ``step_size_init``
        from the init config (the warmup config's copy is the same knob,
        config.hpp:563).
        """
        w, s, i = self.warmup, self.sampling, self.init
        return {
            "init_radius": i.init_radius,
            "step_size_init": i.step_size_init,
            "adapt_init_step": i.adapt_init_step,
            "min_warmup_iter": w.min_iter,
            "max_warmup_iter": w.max_iter,
            "step_size_converge_tol": w.step_size_converge_tol,
            "mass_converge_tol": w.mass_converge_tol,
            "mass_init_count": w.mass_init_count,
            "mass_additive_smoothing": w.mass_additive_smoothing,
            "max_macro_steps_target": w.max_macro_steps_target,
            "step_accept_rate_target": w.step_accept_rate_target,
            "step_learning_rate": w.step_learning_rate,
            "step_gradient_decay": w.step_gradient_decay,
            "step_sq_gradient_decay": w.step_sq_gradient_decay,
            "step_stabilization": w.step_stabilization,
            "step_learn_rate_decay": w.step_learn_rate_decay,
            "min_sampling_iter": s.min_iter,
            "max_sampling_iter": s.max_iter,
            "max_trajectory_doublings": s.max_trajectory_doublings,
            "max_step_halvings": s.max_step_halvings,
            "min_micro_steps": s.min_micro_steps,
            "max_hamiltonian_error": s.max_hamiltonian_error,
            "rhat_converge_tol": s.rhat_converge_tol,
            "block_size": s.block_size,
        }


__all__ = [
    "InitConfig",
    "SamplingConfig",
    "WalnutsConfig",
    "WarmupConfig",
]
