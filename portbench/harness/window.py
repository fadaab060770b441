"""The measured window: the phases ``walnuts()`` runs, driven directly.

The initial state is the one ``walnuts()`` computes from the initial
points it is given (its keys, the Nutpie mass from the initial gradient,
the per-chain step-size search). The window calls
``parallel.runtime.run_warmup`` and then ``run_sampling`` with
``batched=True`` and the keywords ``walnuts()`` passes by default (warmup:
tier-2 every 12, run-ahead 4; sampling: tier-2 every 6, run-ahead 8, the
draws kept on the device), no wall-time cap on a block
(``block_budget=0``), and whatever else the traffic file adds
(``warmup_kw``, ``sampling_kw``).

The warmup is fixed (``"iterations": W``: its minimum and maximum are both
W). The sampling is open: its minimum and maximum are ``max_iter``, beyond
what the window reaches, so R-hat does not end it; it ends at the first
block boundary after the window's seconds, through ``progress`` raising
``KeyboardInterrupt``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

#: walnuts()'s keywords for the batched scheduler's phases
WARMUP_KW = {"batched": True, "runahead": 4, "tier2_every": 12, "block_budget": 0}
SAMPLING_KW = {"batched": True, "runahead": 8, "tier2_every": 6,
               "device_draws": True, "block_budget": 0}


def _map(fn, tree):
    if isinstance(tree, tuple):
        parts = [_map(fn, t) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return fn(tree)


def clone_state(tree):
    return _map(lambda t: t.clone(), tree)


def _configs(traffic: dict, warmup: tuple, sampling: tuple):
    """``WarmupConfig`` and ``SamplingConfig`` of ``(iterations, block)``
    each."""
    from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig

    sampler = traffic.get("sampler", {})
    wcfg = WarmupConfig(min_iter=warmup[0], max_iter=warmup[0], block_size=warmup[1])
    scfg = SamplingConfig(
        min_iter=sampling[0], max_iter=sampling[0], block_size=sampling[1],
        max_trajectory_doublings=int(sampler.get("max_trajectory_doublings", 5)),
        max_step_halvings=int(sampler.get("max_step_halvings", 8)),
    )
    return wcfg, scfg


def initial_state(logp_grad, theta0: torch.Tensor, seed: int, traffic: dict):
    """``walnuts()``'s initial ``WarmupState`` for chains ``1..C`` of
    ``seed`` from the initial points ``theta0`` ``(C, D)``, as
    ``walnuts(inits=...)`` takes them: the Nutpie mass with smoothing
    1e-5, step 1 adapted per chain."""
    from walnuts_tpu_torch.core.adapt import nutpie_init_mass
    from walnuts_tpu_torch.core.sampler import init_warmup_state
    from walnuts_tpu_torch.ops import prng
    from walnuts_tpu_torch.ops.math import adapt_step_size

    chains, dtype, device = theta0.shape[0], theta0.dtype, theta0.device
    wcfg, scfg = _configs(traffic, (1, 1), (1, 1))
    base = prng.key(int(seed), device)
    ids = np.arange(1, chains + 1)
    keys = prng.fold_in(base, torch.as_tensor(ids, device=device))
    grads = logp_grad(theta0)[1]
    mass = nutpie_init_mass(grads, torch.tensor(wcfg.mass_additive_smoothing,
                                                dtype=dtype, device=device))
    step0 = torch.full((chains,), wcfg.step_size_init, dtype=dtype, device=device)
    step_keys = prng.fold_in(base, torch.as_tensor(ids + chains, device=device))
    step0 = adapt_step_size(step_keys, logp_grad, theta0, mass, step0)
    return init_warmup_state(keys, theta0, mass, step0, wcfg, scfg)


@dataclass
class Window:
    """What the window produced and counted."""

    seconds: float = 0.0
    warmup_s: float = 0.0
    sampling_s: float = 0.0
    warmup_iters: int = 0
    sampling_iters: int = 0
    grads: int = 0              # useful gradients, every chain, both phases
    warmup_grads: int = 0       # of those, the warmup's
    nonfinite: int = 0          # attempts ending on a non-finite log density
    trips: int = 0
    passes: int = 0
    syncs: int = 0
    blocks: int = 0
    state: object = None        # the last SampleState
    params: object = None       # the tuning warmup froze
    draws: Optional[torch.Tensor] = None   # (S, C, D) sampling draws
    logps: Optional[torch.Tensor] = None
    reached_max: bool = False


def run_phases(logp_grad, state, traffic: dict, warmup: tuple, sampling: tuple,
               progress=None):
    """The warmup and the sampling, ``(iterations, block)`` each, from the
    ``WarmupState`` ``state``. Returns ``(state, params, draws, logps,
    info, warmup_grads)``."""
    from walnuts_tpu_torch.core.sampler import freeze_params, init_sample_state
    from walnuts_tpu_torch.parallel.runtime import RunInfo, run_sampling, run_warmup

    wcfg, scfg = _configs(traffic, warmup, sampling)
    info = RunInfo()
    state, _, _, info = run_warmup(
        logp_grad, state, wcfg, scfg, progress=progress, info=info,
        **{**WARMUP_KW, **traffic.get("warmup_kw", {})})
    warmup_grads = int(state.n_grads.sum())
    params = freeze_params(state)
    state, draws, logps, info = run_sampling(
        logp_grad, init_sample_state(state), params, scfg, info=info,
        progress=progress, **{**SAMPLING_KW, **traffic.get("sampling_kw", {})})
    return state, params, draws, logps, info, warmup_grads


def _phases(traffic: dict):
    w, s = traffic["warmup"], traffic["sampling"]
    return ((int(w["iterations"]), int(w["block"])),
            (int(s["max_iter"]), int(s["block"])))


def warm_up(logp_grad, state, traffic: dict, device) -> None:
    """Set-up's run of the cell's own shapes on a copy of the state:
    ``traffic["warm"]``'s warmup and sampling iterations, each phase in one
    block."""
    spec = traffic["warm"]
    cw, cs = int(spec["warmup"]), int(spec["sampling"])
    run_phases(logp_grad, clone_state(state), traffic, (cw, cw), (cs, cs))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(logp_grad, state, traffic: dict, seconds: float, device) -> Window:
    """The window: the traffic's warmup and then its sampling from
    ``state``, until the sampling's first block boundary after
    ``seconds``."""
    warmup, sampling = _phases(traffic)
    grads0 = int(state.n_grads.sum())
    nonfinite0 = int(state.fails.n_nonfinite.sum())
    deadline = [None]

    def progress(phase: str, it: int) -> None:
        if phase == "sampling" and time.perf_counter() >= deadline[0]:
            raise KeyboardInterrupt

    t0 = time.perf_counter()
    deadline[0] = t0 + seconds
    state, params, draws, logps, info, warmup_grads = run_phases(
        logp_grad, state, traffic, warmup, sampling, progress=progress)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    return Window(
        seconds=t1 - t0,
        warmup_s=info.seconds["warmup"],
        sampling_s=info.seconds["sampling"],
        warmup_iters=info.warmup_iters,
        sampling_iters=info.sampling_iters,
        grads=int(state.n_grads.sum()) - grads0,
        warmup_grads=warmup_grads - grads0,
        nonfinite=int(info.n_nonfinite.sum()) - nonfinite0,
        trips=sum(info.n_inner_trips.values()),
        passes=sum(info.n_outer_trips.values()),
        syncs=sum(info.n_syncs.values()),
        blocks=sum(info.n_blocks.values()),
        state=state, params=params, draws=draws, logps=logps,
        reached_max=info.sampling_iters >= sampling[0],
    )


def traced_slice(logp_grad, win: Window, traffic: dict, tracer) -> None:
    """After the window: ``traffic["trace_blocks"]`` more sampling blocks of
    the window's size, from a copy of its last state, under ``tracer``.
    The profiler is warmed here too (a process's first profile costs
    seconds), so that nothing of it runs before or inside the window."""
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    block = int(traffic["sampling"]["block"])
    n = block * int(traffic["trace_blocks"])
    _, scfg = _configs(traffic, (1, 1), (n, block))
    state = clone_state(win.state)
    tracer.warm()
    tracer.start()
    run_sampling(logp_grad, state, win.params, scfg,
                 **{**SAMPLING_KW, **traffic.get("sampling_kw", {})})
    tracer.stop()
