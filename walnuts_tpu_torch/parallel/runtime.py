"""Block loops of warmup and sampling, on one device.

Counterpart of ``walnuts_tpu/parallel/runtime.py`` for one device, with
both schedulers: the batched-native one (``batched=True``, the default)
and the classic per-draw one (``batched=False``), where a block is ``n``
calls of the step function of ``core/sampler.py`` (the reference's
``lax.scan`` over the vmapped step) and an attempt integrator may replace
the inner leapfrog loop. Chains advance in blocks of ``block_size``
iterations; between blocks the cross-chain convergence checks run (the
geometric-mean test of the adapted tuning during warmup, the log-density
R-hat during sampling) and may stop the phase early, at the same
iterations as the reference (``_next_boundary``). Sampling draws are
written in place into ONE preallocated device tensor, and reach the host
only when the caller asks for them.

Not ported yet (ROADMAP.md): a device mesh, ``batched_groups > 1``, the
classic path's ``flatten`` and ``chain_groups``, checkpointing, ``thin``
and ``keep_dims``. The reference's automatic block-size cap
(``_BlockBudget``) exists to keep one jitted TPU program under a worker's
time limit; eager blocks here have no such limit, so it is not ported.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
from walnuts_tpu_torch.core.adapt import mass_estimator_inv_mass
from walnuts_tpu_torch.core.batched import (
    make_batched_sample_block,
    make_batched_warmup_block,
)
from walnuts_tpu_torch.core.sampler import (
    FrozenParams,
    SampleState,
    WarmupState,
    make_sample_step,
    make_warmup_step,
)
from walnuts_tpu_torch.core.transition import FailStats, TripCounts
from walnuts_tpu_torch.ops.math import LogpGradFn


@dataclass
class RunInfo:
    """Realized iteration counts and instrumentation of a run.

    The reference's fields (iterations, per-chain ``n_grads`` and failure
    counters, the R-hat trace, convergence and interrupt flags), plus what
    the eager scheduler can count on the host: batched gradient
    evaluations (``n_inner_trips``), tier-2 passes (``n_outer_trips``),
    device-to-host reads of loop conditions (``n_syncs``) and blocks run,
    each per phase, and the wall seconds of each phase (host clock, ending
    on a device synchronize). On the classic path ``n_outer_trips`` counts
    attempts and ``n_inner_trips`` the model evaluations the host asked for:
    masked leapfrog steps, or integrator calls when an integrator runs the
    attempt (``core.transition.TripCounts``).
    """

    warmup_iters: int = 0
    sampling_iters: int = 0
    n_grads: Optional[np.ndarray] = None
    n_halve_fail: Optional[np.ndarray] = None
    n_nonfinite: Optional[np.ndarray] = None
    n_depth_exhausted: Optional[np.ndarray] = None
    rhat_trace: List[float] = field(default_factory=list)
    converged_warmup: bool = False
    converged_sampling: bool = False
    interrupted: bool = False
    n_inner_trips: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    n_outer_trips: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    n_syncs: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    n_blocks: dict = field(default_factory=lambda: {"warmup": 0, "sampling": 0})
    seconds: dict = field(default_factory=lambda: {"warmup": 0.0, "sampling": 0.0})

    def _count(self, phase: str, res) -> None:
        self.n_inner_trips[phase] += res.n_inner_trips
        self.n_outer_trips[phase] += res.n_outer_trips
        self.n_syncs[phase] += res.n_syncs
        self.n_blocks[phase] += 1

    def _fails(self, fails: FailStats) -> None:
        self.n_halve_fail = fails.n_halve_fail.cpu().numpy()
        self.n_nonfinite = fails.n_nonfinite.cpu().numpy()
        self.n_depth_exhausted = fails.n_depth_exhausted.cpu().numpy()


def _warmup_convergence_stats(state: WarmupState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max relative L2 distance of the per-chain mass diagonal from the
    cross-chain geometric mean, and max signed relative difference of the
    step size from its geometric mean (adapt.hpp:203-225)."""
    inv_mass = mass_estimator_inv_mass(state.mass)  # (C, D)
    log_mass = -torch.log(inv_mass)
    geo_mass = torch.exp(torch.mean(log_mass, dim=0))
    mass = torch.exp(log_mass)
    rel_mass = torch.linalg.vector_norm((mass - geo_mass) / geo_mass, dim=1)
    log_step = state.adam.log_step
    geo_step = torch.exp(torch.mean(log_step))
    rel_step = (torch.exp(log_step) - geo_step) / geo_step
    return torch.max(rel_mass), torch.max(rel_step)


def _sampling_rhat(state: SampleState) -> torch.Tensor:
    """Split-free R-hat of the draw log densities (sampler.hpp:142-145):
    ``sqrt(1 + var(chain means) / mean(chain vars))``, sample variances."""
    variances = state.lp_m2 / torch.clamp_min(state.lp_count - 1.0, 1.0)
    var_of_means = torch.var(state.lp_mean, correction=1)
    return torch.sqrt(1.0 + var_of_means / torch.mean(variances))


def _next_boundary(it: int, min_iter: int, block_size: int,
                   max_iter: int) -> int:
    """Next early-stop check point after iteration ``it``: ``min_iter``,
    then every ``block_size``, clamped to ``max_iter``."""
    if it < min_iter:
        b = min_iter
    else:
        b = it + block_size - ((it - min_iter) % block_size)
    return min(b, max_iter)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _refuse_batched_integrator(batched: bool, integrator) -> None:
    if batched and integrator is not None:
        # never silently drop a user-built integrator: the batched
        # scheduler integrates inside its own trip loop
        raise ValueError(
            "batched is incompatible with a custom integrator "
            "(pass batched=False to use it)")


def run_warmup(
    logp_grad: LogpGradFn,
    state: WarmupState,
    warmup_cfg: WarmupConfig,
    sampling_cfg: SamplingConfig,
    *,
    save_warmup: bool = False,
    progress=None,
    info: Optional[RunInfo] = None,
    batched: bool = True,
    integrator=None,
    runahead: int = 4,
    tier2_every: int = 6,
) -> Tuple[WarmupState, Optional[torch.Tensor], Optional[torch.Tensor], RunInfo]:
    """Adaptive warmup with block-synchronous early stopping.

    ``state`` is a chain-batched ``WarmupState``. Returns the final state,
    with ``save_warmup`` the warmup draws ``(iters, C, D)`` and log
    densities ``(iters, C)`` on the state's device, and the run info.
    A ``KeyboardInterrupt`` between blocks ends warmup early and keeps the
    adaptation reached so far.

    ``batched=True`` is the asynchronous batched-native warmup
    (``runahead``, ``tier2_every``). ``batched=False`` is the classic
    warmup: every iteration is one transition of all chains in lock step,
    adapted at the draw boundary, and ``integrator`` (see
    ``ops.integrator``) may run each attempt's leapfrog steps. An
    integrator with ``batched=True`` raises ``ValueError``.
    """
    _refuse_batched_integrator(batched, integrator)
    if batched:
        warmup_block = make_batched_warmup_block(
            logp_grad, sampling_cfg, runahead=runahead, tier2_every=tier2_every)
    else:
        warmup_step = make_warmup_step(logp_grad, sampling_cfg,
                                       integrator=integrator)

        def warmup_block(ws: WarmupState, n: int, out=None):
            counts = TripCounts()
            for i in range(n):
                ws, o = warmup_step(ws)
                counts += o.counts
                if out is not None:
                    out[0][i].copy_(o.theta)
                    out[1][i].copy_(o.logp)
            return ws, counts
    info = info or RunInfo()
    dev = state.theta.device
    C, D = state.theta.shape
    draws = logps = None
    if save_warmup:
        draws = torch.empty((warmup_cfg.max_iter, C, D), dtype=state.theta.dtype,
                            device=dev)
        logps = torch.empty((warmup_cfg.max_iter, C), dtype=state.theta.dtype,
                            device=dev)

    def check() -> bool:
        mrm, mrs = _warmup_convergence_stats(state)
        return bool((mrm <= warmup_cfg.mass_converge_tol)
                    & (mrs <= warmup_cfg.step_size_converge_tol))

    t0 = time.perf_counter()
    it = 0
    converged = False
    if warmup_cfg.min_iter == 0 and warmup_cfg.max_iter > 0:
        converged = check()
    try:
        while it < warmup_cfg.max_iter and not converged:
            next_check = _next_boundary(it, warmup_cfg.min_iter,
                                        warmup_cfg.block_size,
                                        warmup_cfg.max_iter)
            n = min(warmup_cfg.block_size, next_check - it)
            out = (draws[it:it + n], logps[it:it + n]) if save_warmup else None
            state, res = warmup_block(state, n, out)
            info._count("warmup", res)
            it += n
            if progress is not None:
                progress("warmup", it)
            if it == next_check and it >= warmup_cfg.min_iter:
                converged = check()
    except KeyboardInterrupt:
        info.interrupted = True
    _sync(dev)
    info.seconds["warmup"] += time.perf_counter() - t0
    info.warmup_iters = it
    info.converged_warmup = converged
    info._fails(state.fails)
    if save_warmup:
        draws, logps = draws[:it], logps[:it]
    return state, draws, logps, info


def run_sampling(
    logp_grad: LogpGradFn,
    state: SampleState,
    params: FrozenParams,
    sampling_cfg: SamplingConfig,
    *,
    info: Optional[RunInfo] = None,
    progress=None,
    on_r_hat=None,
    batched: bool = True,
    integrator=None,
    runahead: int = 8,
    tier2_every: int = 6,
    pallas_pass: bool = False,
    pass_tile: Optional[int] = None,
) -> Tuple[SampleState, torch.Tensor, torch.Tensor, RunInfo]:
    """Fixed-parameter sampling with R-hat early stopping.

    Returns the final state, the draws ``(iters, C, D)`` and their log
    densities ``(iters, C)`` — slices of one tensor preallocated on the
    state's device for ``max_iter`` draws and filled in place block by
    block — and the run info.

    ``batched=False`` is the classic sampler: every iteration is one
    transition of all chains in lock step (each pass of its attempt loop
    waits for the slowest chain), with the per-draw Welford update, and
    ``integrator`` (see ``ops.integrator``) may run each attempt's leapfrog
    steps. Per lane its draws are the batched scheduler's; ``n_grads`` is
    one higher per draw (every transition re-evaluates its start point).
    An integrator with ``batched=True`` raises ``ValueError``.

    ``pallas_pass=True`` runs each tier-2 pass as one launch of the fused
    pass kernel (CUDA tensors; the plain version on the CPU) with
    ``pass_tile`` chains per CUDA block; the chains are the unfused
    pass's. Off by default, as in the reference; batched only.
    """
    _refuse_batched_integrator(batched, integrator)
    if batched:
        start_blk, sample_blk = make_batched_sample_block(
            logp_grad,
            sampling_cfg.max_trajectory_doublings,
            sampling_cfg.max_step_halvings,
            runahead=runahead,
            tier2_every=tier2_every,
            pallas_pass=pallas_pass,
            pass_tile=pass_tile,
        )

        def run_block(state: SampleState, n: int, out):
            st = start_blk(state.key, state.theta, state.n_grads, state.fails,
                           params.step_size, params.inv_mass, params.min_micro)
            res = sample_blk(st, params.step_size, params.inv_mass,
                             params.min_micro, max_error, n, out=out)
            # Chan et al. merge of the block's per-lane log-density stats
            # into the running Welford (the classic per-draw statistics)
            lps = res.logps.T  # (C, n)
            cnt_b = float(n)
            mean_b = torch.mean(lps, dim=1)
            m2_b = torch.sum((lps - mean_b[:, None]) ** 2, dim=1)
            tot = state.lp_count + cnt_b
            delta = mean_b - state.lp_mean
            state = state._replace(
                key=res.key,
                theta=res.draws[-1],
                # + 1: the block-entry gradient start_blk evaluated
                n_grads=state.n_grads + res.n_grads_delta + 1,
                fails=FailStats(*(a + b for a, b in zip(state.fails,
                                                        res.fails_delta))),
                lp_count=tot,
                lp_mean=state.lp_mean + delta * cnt_b / tot,
                lp_m2=state.lp_m2 + m2_b + delta**2 * state.lp_count * cnt_b / tot,
            )
            return state, res
    else:
        if pallas_pass:
            raise ValueError("pallas_pass requires batched=True (the classic "
                             "path has no tier-2 pass)")
        sample_step = make_sample_step(logp_grad, sampling_cfg,
                                       integrator=integrator)

        def run_block(state: SampleState, n: int, out):
            counts = TripCounts()
            for i in range(n):
                state, res = sample_step(state, params)
                counts += res.counts
                out[0][i].copy_(res.theta)
                out[1][i].copy_(res.logp)
            return state, counts

    info = info or RunInfo()
    dev = state.theta.device
    C, D = state.theta.shape
    dtype = state.theta.dtype
    draws = torch.empty((sampling_cfg.max_iter, C, D), dtype=dtype, device=dev)
    logps = torch.empty((sampling_cfg.max_iter, C), dtype=dtype, device=dev)
    max_error = torch.tensor(sampling_cfg.max_hamiltonian_error, dtype=dtype,
                             device=dev)

    t0 = time.perf_counter()
    it = 0
    converged = False
    try:
        while it < sampling_cfg.max_iter and not converged:
            next_check = _next_boundary(it, sampling_cfg.min_iter,
                                        sampling_cfg.block_size,
                                        sampling_cfg.max_iter)
            n = min(sampling_cfg.block_size, next_check - it)
            state, res = run_block(state, n, (draws[it:it + n], logps[it:it + n]))
            info._count("sampling", res)
            it += n
            if progress is not None:
                progress("sampling", it)
            if it == next_check and it >= max(sampling_cfg.min_iter, 2):
                r = float(_sampling_rhat(state))
                info.rhat_trace.append(r)
                if on_r_hat is not None:
                    on_r_hat(r)
                converged = r <= sampling_cfg.rhat_converge_tol
    except KeyboardInterrupt:
        info.interrupted = True
    _sync(dev)
    info.seconds["sampling"] += time.perf_counter() - t0
    info.sampling_iters = it
    info.converged_sampling = converged
    info.n_grads = state.n_grads.cpu().numpy()
    info._fails(state.fails)
    return state, draws[:it], logps[:it], info


__all__ = ["RunInfo", "run_sampling", "run_warmup"]
