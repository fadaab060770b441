"""End-to-end sampling API of the PyTorch port.

Counterpart of ``walnuts_tpu/api.py::walnuts`` on one device: by default
the batched-native scheduler (asynchronous adaptive warmup, then
sampling), with ``batched=False`` or an ``integrator`` the classic
per-draw path. The model is a batched PyTorch function ``theta (C, D) ->
log density (C,)`` differentiated by autograd, or with ``fused=True`` a
function ``theta (C, D) -> (log density (C,), gradient (C, D))`` such as
``ops.logreg_fused.logistic_regression_fused``.

The device is explicit: everything runs on ``device`` (default
``"cuda"``), and nothing moves to another device by itself. The seed's
keys and every draw's randomness follow the JAX package's threefry stream,
so a run can be compared chain by chain with the reference.
"""

from __future__ import annotations

import numbers
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
from walnuts_tpu_torch.core.adapt import nutpie_init_mass
from walnuts_tpu_torch.core.sampler import (
    freeze_params,
    init_sample_state,
    init_warmup_state,
)
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.math import (
    adapt_step_size,
    make_logp_grad,
    sanitize_logp_grad,
)
from walnuts_tpu_torch.parallel.runtime import RunInfo, run_sampling, run_warmup
from walnuts_tpu_torch.utils.output import (
    WalnutsOutputArray,
    WarmupInfo,
    prepare_seed,
)

# options of the reference's walnuts() outside this port: the values that
# select the ported behaviour, and what a user must know otherwise
_NOT_PORTED = {
    "mesh": ((None,), "multi-device chain sharding (ROADMAP.md Queue 1, multi-GPU)"),
    "batched_groups": ((1,), "cost-sorted chain groups (ROADMAP.md Queue 1)"),
    "model_dtype": ((None,), "precision islands (ROADMAP.md Queue 1)"),
    "checkpoint_dir": ((None,), "checkpoint and resume (ROADMAP.md Queue 1)"),
    "thin": ((1,), "thinning (ROADMAP.md Queue 1)"),
    "keep_dims": ((None,), "dimension subsets (ROADMAP.md Queue 1)"),
    "bf16_ends": ((False,), "bfloat16 merge-stack endpoints (ROADMAP.md Queue 1)"),
    "flatten": ((False,), "the flattened classic scheduler (ROADMAP.md Queue 1)"),
    "chain_groups": ((1,), "classic chain groups (ROADMAP.md Queue 1)"),
    "profile_dir": ((None,), "profiler traces (ROADMAP.md Queue 1)"),
    "min_latched": ((0,), "tier-2 pass deferral (ROADMAP.md Queue 1)"),
    "defer_splits": ((True,), "per-trip key splits; the port always defers "
                              "them (ROADMAP.md Queue 1)"),
}


def _is_ported(value, allowed) -> bool:
    """``value`` is one of ``allowed`` (``None``/bools by identity, ints
    by value)."""
    return any(value is a or (isinstance(a, int) and not isinstance(a, bool)
                              and isinstance(value, numbers.Integral)
                              and not isinstance(value, bool) and value == a)
               for a in allowed)


def walnuts(
    logp: Callable,
    *,
    num_params: Optional[int] = None,
    inits: Optional[np.ndarray] = None,
    num_chains: int = 4,
    seed: Optional[int] = None,
    id: int = 1,
    init_radius: float = 2.0,
    init_inv_metric: Optional[np.ndarray] = None,
    average_masses: bool = False,
    save_inv_metric: bool = False,
    min_warmup_iter: int = 50,
    max_warmup_iter: int = 1000,
    min_sampling_iter: int = 50,
    max_sampling_iter: int = 1000,
    max_trajectory_doublings: int = 5,
    max_step_halvings: int = 5,
    min_micro_steps: int = 1,
    max_hamiltonian_error: float = 0.5,
    step_size_converge_tol: float = 0.1,
    mass_converge_tol: float = 1.0,
    rhat_converge_tol: float = 1.01,
    mass_init_count: float = 4.0,
    mass_additive_smoothing: float = 1e-5,
    max_macro_steps_target: float = 15.0,
    step_size_init: float = 1.0,
    step_accept_rate_target: float = 0.8,
    step_learning_rate: float = 0.05,
    step_gradient_decay: float = 0.8,
    step_sq_gradient_decay: float = 0.9,
    step_stabilization: float = 1e-4,
    step_learn_rate_decay: float = 0.5,
    save_warmup: bool = False,
    refresh: int = 0,
    dtype: Optional[torch.dtype] = None,
    device="cuda",
    adapt_init_step: bool = True,
    block_size: int = 25,
    return_info: bool = False,
    fused: bool = False,
    batched: Optional[bool] = None,
    integrator=None,
    runahead: int = 8,
    tier2_every: int = 6,
    warmup_tier2_every: Optional[int] = None,
    **unported,
) -> Union[List[WalnutsOutputArray], Tuple[List[WalnutsOutputArray], RunInfo]]:
    """Sample from a batched PyTorch log density with adaptive WALNUTS.

    Parameters follow the reference's ``walnuts`` (and through it the
    reference library's ``walnuts_pyfunc``). Port-specific:

    - ``device``: where the chains live and every kernel runs
      (default ``"cuda"``; pass ``"cpu"`` to run the plain versions).
    - ``dtype``: the sampler's float dtype (default ``torch.float32``).
    - ``fused``: ``logp`` already returns ``(log density, gradient)``.
    - ``batched``: the batched-native scheduler (True) or the classic
      per-draw path (False), whose draws are the same per chain. ``None``
      picks the batched scheduler unless an ``integrator`` is given.
    - ``integrator``: an attempt integrator for the classic path, e.g.
      ``ops.integrator.make_fused_integrator(models.kernels.funnel_vg(d))``
      (one kernel launch per attempt on CUDA tensors). With
      ``batched=True`` it raises ``ValueError``.
    - ``runahead``/``tier2_every``: sampling's run-ahead depth and tier-2
      cadence; ``warmup_tier2_every`` (default 12) is warmup's cadence;
      warmup's run-ahead is 4, as in the reference.

    Options of the reference that the port does not have yet raise
    ``NotImplementedError`` when set to anything but their default.

    Returns per-chain draw arrays ``(draws, dim)`` (NumPy, with
    ``.warmup`` carrying the adapted step size and, optionally, the
    inverse metric and warmup draws), and with ``return_info`` the
    :class:`RunInfo`.
    """
    for name, value in unported.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"walnuts() got an unexpected keyword argument '{name}'")
        allowed, what = _NOT_PORTED[name]
        if not _is_ported(value, allowed):
            raise NotImplementedError(
                f"walnuts({name}={value!r}): {what} is not ported to "
                f"walnuts_tpu_torch yet"
            )
    dtype = dtype or torch.float32
    device = torch.device(device)
    if batched is None:
        # the batched scheduler emits the classic path's draws, so this is
        # a pure scheduling default; an integrator runs on the classic path
        batched = integrator is None
    if num_chains < 1:
        raise ValueError(
            f"num_chains must be positive; found num_chains = {num_chains}")
    if num_params is None:
        if inits is None:
            raise ValueError("must specify at least one of num_params or inits")
        init_shape = np.shape(inits)
        num_params = init_shape[1] if len(init_shape) == 2 else init_shape[0]
    if num_params <= 0:
        raise ValueError(
            f"num_params must be positive; found num_params = {num_params}")

    seed = prepare_seed(seed)
    base_key = prng.key(seed, device)
    chain_ids = np.arange(id, id + num_chains)
    chain_keys = prng.fold_in(base_key, torch.as_tensor(chain_ids, device=device))

    if fused:
        def logp_grad(theta):
            return sanitize_logp_grad(*logp(theta))
    else:
        logp_grad = make_logp_grad(logp)

    # --- initial positions ---
    if inits is not None:
        inits = np.asarray(inits, dtype=np.float64)
        if inits.shape == (num_params,):
            inits = np.repeat(inits[np.newaxis], num_chains, axis=0)
        elif inits.shape != (num_chains, num_params):
            raise ValueError(
                f"Invalid inits size. Expected a {(num_params,)} "
                f"or {(num_chains, num_params)} matrix.")
        theta0 = torch.as_tensor(inits, dtype=dtype, device=device)
    else:
        init_key = prng.fold_in(base_key, 0xFFFFFFFF)
        theta0 = init_radius * prng.normal(init_key, (num_chains, num_params),
                                           dtype)

    # --- initial mass: explicit inverse metric or the Nutpie gradient rule
    if init_inv_metric is not None:
        inv_metric = np.asarray(init_inv_metric, dtype=np.float64)
        if inv_metric.shape == (num_params,):
            inv_metric = np.repeat(inv_metric[np.newaxis], num_chains, axis=0)
        elif inv_metric.shape != (num_chains, num_params):
            raise ValueError(
                f"Invalid init_inv_metric size. Expected {(num_params,)} "
                f"or {(num_chains, num_params)}.")
        if not np.all(np.isfinite(inv_metric)) or np.any(inv_metric <= 0):
            raise ValueError("init_inv_metric must be finite and positive")
        init_mass = torch.as_tensor(1.0 / inv_metric, dtype=dtype, device=device)
    else:
        grads = logp_grad(theta0)[1]
        init_mass = nutpie_init_mass(
            grads, torch.tensor(mass_additive_smoothing, dtype=dtype,
                                device=device))
        if average_masses:
            geo = torch.exp(torch.mean(torch.log(init_mass), dim=0))
            init_mass = geo.expand_as(init_mass).clone()

    # --- initial step sizes, optionally adapted per chain ---
    step_init_arr = np.asarray(step_size_init, dtype=np.float64)
    if step_init_arr.ndim == 0:
        step0 = torch.full((num_chains,), float(step_init_arr), dtype=dtype,
                           device=device)
    elif step_init_arr.shape == (num_chains,):
        if not np.all(np.isfinite(step_init_arr)) or np.any(step_init_arr <= 0):
            raise ValueError("step_size_init must be finite and positive")
        step0 = torch.as_tensor(step_init_arr, dtype=dtype, device=device)
    else:
        raise ValueError(
            f"step_size_init must be a scalar or shape ({num_chains},); "
            f"got shape {step_init_arr.shape}")
    if adapt_init_step:
        step_keys = prng.fold_in(
            base_key, torch.as_tensor(chain_ids + num_chains, device=device))
        step0 = adapt_step_size(step_keys, logp_grad, theta0, init_mass, step0)

    warmup_cfg = WarmupConfig(
        min_iter=min_warmup_iter,
        max_iter=max_warmup_iter,
        step_size_converge_tol=step_size_converge_tol,
        mass_converge_tol=mass_converge_tol,
        mass_init_count=mass_init_count,
        mass_additive_smoothing=mass_additive_smoothing,
        max_macro_steps_target=max_macro_steps_target,
        step_size_init=float(np.mean(step_init_arr)),
        step_accept_rate_target=step_accept_rate_target,
        step_learning_rate=step_learning_rate,
        step_gradient_decay=step_gradient_decay,
        step_sq_gradient_decay=step_sq_gradient_decay,
        step_stabilization=step_stabilization,
        step_learn_rate_decay=step_learn_rate_decay,
        block_size=block_size,
    )
    sampling_cfg = SamplingConfig(
        min_iter=min_sampling_iter,
        max_iter=max_sampling_iter,
        max_trajectory_doublings=max_trajectory_doublings,
        max_step_halvings=max_step_halvings,
        min_micro_steps=min_micro_steps,
        max_hamiltonian_error=max_hamiltonian_error,
        rhat_converge_tol=rhat_converge_tol,
        block_size=block_size,
    )

    progress = on_r_hat = None
    if refresh > 0:
        def progress(phase: str, iteration: int) -> None:
            if iteration % refresh == 0 or iteration == 0:
                tag = "(Warmup)" if phase == "warmup" else "(Sampling)"
                if num_chains <= 32:
                    for cid in chain_ids:
                        print(f"Chain [{cid}]: Iteration {iteration}\t{tag}")
                else:
                    print(f"All chains: Iteration {iteration} {tag}")

        def on_r_hat(value: float) -> None:
            print(f"R-hat: {value:.4f}")

    wstate = init_warmup_state(chain_keys, theta0, init_mass, step0,
                               warmup_cfg, sampling_cfg)
    wstate, warmup_draws, warmup_logps, info = run_warmup(
        logp_grad, wstate, warmup_cfg, sampling_cfg,
        save_warmup=save_warmup, progress=progress, batched=batched,
        integrator=integrator,
        tier2_every=12 if warmup_tier2_every is None else warmup_tier2_every,
    )
    params = freeze_params(wstate)
    if info.interrupted:
        draws = np.zeros((0, num_chains, num_params))
    else:
        sstate = init_sample_state(wstate)
        _, draws_t, _, info = run_sampling(
            logp_grad, sstate, params, sampling_cfg, info=info,
            progress=progress, on_r_hat=on_r_hat, batched=batched,
            integrator=integrator, runahead=runahead,
            tier2_every=tier2_every,
        )
        draws = draws_t.cpu().numpy()
    if warmup_draws is not None:
        warmup_draws = warmup_draws.cpu().numpy()
        warmup_logps = warmup_logps.cpu().numpy()

    step_sizes = params.step_size.cpu().numpy()
    inv_metric_out = params.inv_mass.cpu().numpy() if save_inv_metric else None
    outputs: List[WalnutsOutputArray] = []
    for c in range(num_chains):
        wi = WarmupInfo(
            stepsize=float(step_sizes[c]),
            inv_metric=inv_metric_out[c] if inv_metric_out is not None else None,
            warmup_draws=warmup_draws[:, c, :] if warmup_draws is not None else None,
            warmup_logps=warmup_logps[:, c] if warmup_logps is not None else None,
        )
        outputs.append(WalnutsOutputArray(draws[:, c, :], wi))
    if return_info:
        return outputs, info
    return outputs


__all__ = ["walnuts"]
