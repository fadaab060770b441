"""End-to-end sampling API of the PyTorch port.

Counterpart of ``walnuts_tpu/api.py``, with every keyword of the
reference's ``walnuts``. It runs by default the batched-native scheduler
(asynchronous adaptive warmup, then sampling), with ``batched=False``, an
``integrator``, ``flatten`` or ``chain_groups`` the classic per-draw path,
with checkpoint and resume (``checkpoint_dir``) and a profiler trace
(``profile_dir``). The model is a batched PyTorch function
``theta (C, D) -> log density (C,)`` differentiated by autograd, or with
``fused=True`` a function ``theta (C, D) -> (log density (C,), gradient
(C, D))`` such as ``ops.logreg_fused.logistic_regression_fused``.
``walnuts_pyfunc`` samples a model evaluated on the host (a Python
callable or a C function on NumPy rows) through ``host_model``, one
batched round trip per model evaluation, as ``models.stan`` does for a
compiled Stan model.

The device is explicit: everything runs on ``device`` (default
``"cuda"``), and nothing moves to another device by itself. With a chain
``mesh`` (a one-dimensional ``torch.distributed`` ``DeviceMesh`` named
``"chains"``; ``parallel/runtime.py``) every rank calls ``walnuts`` with
the same arguments, runs its shard of the chains on its own device, and
gets the whole result. The seed's
keys and every draw's randomness follow the JAX package's threefry stream,
so a run can be compared chain by chain with the reference.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import time
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
from walnuts_tpu_torch.parallel.checkpoint import BlockCheckpointer
from walnuts_tpu_torch.parallel.runtime import (
    RunInfo,
    _refuse_chain_groups,
    _refuse_groups,
    _refuse_mesh,
    _refuse_schedulers,
    _refuse_thin,
    _whole,
    chain_sharding,
    run_sampling,
    run_warmup,
    shard_chains,
)
from walnuts_tpu_torch.utils.output import (
    WalnutsOutputArray,
    WarmupInfo,
    prepare_seed,
)

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
    model_dtype: Optional[torch.dtype] = None,
    device="cuda",
    mesh=None,
    adapt_init_step: bool = True,
    block_size: int = 25,
    return_info: bool = False,
    profile_dir: Optional[str] = None,
    fused: bool = False,
    chain_groups: int = 1,
    integrator=None,
    bf16_ends: bool = False,
    flatten: bool = False,
    batched: Optional[bool] = None,
    batched_groups: int = 1,
    runahead: int = 8,
    tier2_every: int = 6,
    warmup_tier2_every: Optional[int] = None,
    min_latched: int = 0,
    defer_splits: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep_last_n: Optional[int] = None,
    resume: bool = True,
    thin: int = 1,
    keep_dims=None,
) -> Union[List[WalnutsOutputArray], Tuple[List[WalnutsOutputArray], RunInfo]]:
    """Sample from a batched PyTorch log density with adaptive WALNUTS.

    Parameters follow the reference's ``walnuts`` (and through it the
    reference library's ``walnuts_pyfunc``). Port-specific:

    - ``device``: where the chains live and every kernel runs
      (default ``"cuda"``; pass ``"cpu"`` to run the plain versions).
    - ``mesh``: a one-dimensional ``torch.distributed.device_mesh.DeviceMesh``
      whose dimension is named ``"chains"`` (e.g.
      ``init_device_mesh("cuda", (N,), mesh_dim_names=("chains",))`` in
      each of N processes): every rank calls ``walnuts`` with the same
      arguments, samples its contiguous shard of the chains on the mesh's
      device (a ``device`` that disagrees raises ``ValueError``), and
      returns every chain, as without a mesh: a chain's keys, initial
      point and step size are the ones it gets without a mesh, and only the
      cross-chain statistics cross ranks (``parallel/runtime.py``).
      ``num_chains`` must divide by the mesh size; ``batched_groups > 1``
      requires ``mesh=None``; ``refresh`` prints on rank 0 only.
    - ``dtype``: the sampler's float dtype (default ``torch.float32``).
    - ``model_dtype``: evaluate the model in this dtype while positions,
      momenta and adaptation stay in ``dtype``. A narrower model has its
      value and gradient cast up; a wider one keeps its value wide (the
      scheduler carries its log-density fields in the value's dtype) and
      returns its gradient in ``dtype``.
    - ``fused``: ``logp`` already returns ``(log density, gradient)``.
    - ``batched``: the batched-native scheduler (True) or the classic
      per-draw path (False), whose draws are the same per chain. ``None``
      picks the batched scheduler unless an ``integrator``, ``flatten`` or
      ``chain_groups > 1`` is given.
    - ``integrator``: an attempt integrator for the classic path, e.g.
      ``ops.integrator.make_fused_integrator(models.kernels.funnel_vg(d))``
      (one kernel launch per attempt on CUDA tensors). With
      ``batched=True`` it raises ``ValueError``.
    - ``chain_groups``: the classic sampler sorts the chains by their
      adapted cost and advances that many groups one after the other, so
      that a slow chain stalls its own group only (``mesh=None``; must
      divide ``num_chains``). ``flatten``: the classic sampler's run-ahead
      flattened form (a chain that finishes a trajectory starts the next
      at once); the same draws per chain. With ``chain_groups > 1`` it is
      dropped, as in the reference; either with ``batched=True`` or
      ``checkpoint_dir`` raises ``ValueError``.
    - ``bf16_ends``: keep the merge stack's endpoints in bfloat16 and round
      both operands of every U-turn test to bfloat16 (both schedulers;
      warmup's classic transitions too). A valid sampler whose trajectory
      lengths shift slightly; draws and integration keep full precision.
    - ``runahead``/``tier2_every``: sampling's run-ahead depth and tier-2
      cadence; ``warmup_tier2_every`` (default 12) is warmup's cadence;
      warmup's run-ahead is 4, as in the reference. ``min_latched``: a
      sampling pass due at the ``tier2_every`` mark waits until that many
      lanes have latched a leaf; ``defer_splits=False``: split the keys in
      every trip instead of in the pass's replay. Both are scheduling
      only: the draws do not change.
    - ``batched_groups``: sort the chains by cost every block and run
      that many groups one after the other, in warmup and sampling
      (batched only; must divide ``num_chains``).
    - ``thin``: keep every ``thin``-th sampling draw (must divide
      ``block_size``); ``keep_dims``: keep only these dimensions of each
      draw. The sampler itself advances every iteration in every dimension.
    - ``profile_dir``: trace the whole run with ``torch.profiler`` (host
      operations and, on a CUDA device, kernels) and write it there as a
      Chrome trace, ``walnuts-<time>-<pid>.pt.trace.json``.
    - ``checkpoint_dir``: persist the run state every ``checkpoint_every``
      blocks (``parallel.checkpoint.BlockCheckpointer``); a later call with
      the same arguments resumes from the latest checkpoint, mid-warmup or
      mid-sampling, and returns the draws of the uninterrupted run bit for
      bit (the keys are part of the state). ``resume=False`` starts over;
      a checkpoint written under other run arguments (seed, counts, dtype,
      ...) is refused with a warning and the run starts over.
      ``checkpoint_keep_last_n`` compacts each phase's older block files
      into one (no draw is dropped).

    The draws stay on ``device`` through sampling (the runtime's
    ``device_draws=True``) and come to the host once, at the end.

    Returns per-chain draw arrays ``(draws, dim)`` (NumPy, with
    ``.warmup`` carrying the adapted step size and, optionally, the
    inverse metric and warmup draws), and with ``return_info`` the
    :class:`RunInfo`.
    """
    dtype = dtype or torch.float32
    device = torch.device(device)
    shard = chain_sharding(mesh)
    if shard is not None:
        if device.type != shard.device.type or device.index not in (
                None, shard.device.index):
            raise ValueError(f"device {device} disagrees with the mesh's device "
                             f"{shard.device} on rank {shard.rank}")
        device = shard.device
    if batched is None:
        # the batched scheduler emits the classic path's draws, so this is
        # a pure scheduling default; an integrator, flatten and chain groups
        # run on the classic path
        batched = integrator is None and not flatten and chain_groups == 1
    # as in the reference: flatten is dropped under chain groups
    flatten = flatten and chain_groups == 1
    if num_chains < 1:
        raise ValueError(
            f"num_chains must be positive; found num_chains = {num_chains}")
    # the reference raises these at the first block; before any work here
    _refuse_schedulers(batched, flatten, chain_groups, checkpoint_dir)
    _refuse_groups(batched, batched_groups, num_chains)
    _refuse_mesh(shard, batched_groups, num_chains)
    _refuse_chain_groups(shard, chain_groups, num_chains)
    _refuse_thin(thin, block_size)
    if num_params is None:
        if inits is None:
            raise ValueError("must specify at least one of num_params or inits")
        init_shape = np.shape(inits)
        num_params = init_shape[1] if len(init_shape) == 2 else init_shape[0]
    if num_params <= 0:
        raise ValueError(
            f"num_params must be positive; found num_params = {num_params}")

    # under a mesh every rank draws the keys and initial points of the
    # whole chain axis and computes the initial masses and step sizes of
    # its own rows; those are gathered into the whole initial state, which
    # the runtime shards again
    rows = slice(None) if shard is None else shard.rows(num_chains)
    user_seed = seed  # None: not reproducible, so any checkpoint may resume
    seed = prepare_seed(seed)
    base_key = prng.key(seed, device)
    chain_ids = np.arange(id, id + num_chains)
    chain_keys = prng.fold_in(base_key, torch.as_tensor(chain_ids, device=device))

    if model_dtype is not None and model_dtype != dtype:
        # precision islands: the model runs in model_dtype; its value is
        # cast to the wider of the two dtypes and its gradient to dtype
        # (autograd casts it back through the input's cast)
        user_logp, value_dtype = logp, torch.promote_types(dtype, model_dtype)
        if fused:
            def logp(theta):
                lp, grad = user_logp(theta.to(model_dtype))
                return lp.to(value_dtype), grad.to(dtype)
        else:
            def logp(theta):
                return user_logp(theta.to(model_dtype)).to(value_dtype)

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
        grads = logp_grad(theta0[rows])[1]
        init_mass = _whole(nutpie_init_mass(
            grads, torch.tensor(mass_additive_smoothing, dtype=dtype,
                                device=device)), shard)
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
        step0 = _whole(adapt_step_size(step_keys[rows], logp_grad, theta0[rows],
                                       init_mass[rows], step0[rows]), shard)

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
    if refresh > 0 and (shard is None or shard.rank == 0):
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

    ckpt = resume_meta = None
    if checkpoint_dir is not None:
        # every argument that changes the draws; resume refuses a
        # checkpoint written under others
        fingerprint = {
            "seed": None if user_seed is None else int(seed),
            "num_chains": int(num_chains),
            "num_params": int(num_params),
            "warmup_iter": [int(min_warmup_iter), int(max_warmup_iter)],
            "sampling_iter": [int(min_sampling_iter), int(max_sampling_iter)],
            "thin": int(thin),
            "keep_dims": None if keep_dims is None else [int(k) for k in keep_dims],
            "dtype": str(dtype).removeprefix("torch."),
            "block_size": int(block_size),
        }
        ckpt = BlockCheckpointer(checkpoint_dir, every=checkpoint_every,
                                 keep_last_n=checkpoint_keep_last_n,
                                 fingerprint=fingerprint, mesh=mesh)
        if resume:
            resume_meta = ckpt.latest()
        if resume_meta is None:
            ckpt.reset()  # drop the blocks of an earlier run

    with _profiled(profile_dir, device):
        # the warmup state is also the template of a restore
        wstate = init_warmup_state(chain_keys, theta0, init_mass, step0,
                                   warmup_cfg, sampling_cfg)
        start_sampling = 0
        warmup_draws = warmup_logps = None
        if resume_meta is not None and resume_meta["phase"] == "sampling":
            # stopped mid-sampling: skip warmup, restore the frozen state
            sstate, params, info = ckpt.restore(init_sample_state(wstate),
                                                freeze_params(wstate))
            start_sampling = resume_meta["it"]
            if save_warmup:
                warmup_draws, warmup_logps = ckpt.saved_blocks(
                    "warmup", info.warmup_iters + 1)
        else:
            start_warmup, warmup_info = 0, None
            if resume_meta is not None and resume_meta["phase"] == "warmup":
                # the restored RunInfo keeps the counters (and the
                # converged flag) of the whole run
                wstate, _, warmup_info = ckpt.restore(wstate)
                start_warmup = resume_meta["it"]
            wstate, warmup_t, warmup_lp_t, info = run_warmup(
                logp_grad, wstate, warmup_cfg, sampling_cfg,
                save_warmup=save_warmup, progress=progress, batched=batched,
                integrator=integrator, bf16_ends=bf16_ends,
                tier2_every=12 if warmup_tier2_every is None else warmup_tier2_every,
                batched_groups=batched_groups, checkpoint=ckpt,
                start_it=start_warmup, info=warmup_info, mesh=mesh,
            )
            if warmup_t is not None:
                warmup_draws = warmup_t.cpu().numpy()
                warmup_logps = warmup_lp_t.cpu().numpy()
            if ckpt is not None and start_warmup and save_warmup:
                prev_d, prev_l = ckpt.saved_blocks("warmup", start_warmup)
                if prev_d is not None:
                    warmup_draws = np.concatenate([prev_d, warmup_draws])
                    warmup_logps = np.concatenate([prev_l, warmup_logps])
            params = freeze_params(wstate)
            sstate = None if info.interrupted else init_sample_state(wstate)
            if ckpt is not None and not info.interrupted:
                # the phase change is durable: a crash before the first
                # sampling block resumes here, not in warmup (the
                # checkpointer takes this rank's chains)
                ckpt.save("sampling", 0, shard_chains(sstate, mesh), info,
                          params=shard_chains(params, mesh))

        if info.interrupted:
            out_dim = num_params if keep_dims is None else len(keep_dims)
            draws = np.zeros((0, num_chains, out_dim))
        else:
            _, draws_t, _, info = run_sampling(
                logp_grad, sstate, params, sampling_cfg, info=info,
                progress=progress, on_r_hat=on_r_hat, batched=batched,
                integrator=integrator, bf16_ends=bf16_ends,
                chain_groups=chain_groups, flatten=flatten,
                runahead=runahead, tier2_every=tier2_every,
                min_latched=min_latched, defer_splits=defer_splits,
                batched_groups=batched_groups, thin=thin, keep_dims=keep_dims,
                checkpoint=ckpt, start_it=start_sampling, mesh=mesh,
                device_draws=True,
            )
            draws = draws_t.cpu().numpy()
            if ckpt is not None and start_sampling:
                prev_d, _ = ckpt.saved_blocks("sampling", start_sampling)
                if prev_d is not None:
                    # sampling_iters already counts from 0: run_sampling
                    # started at start_sampling
                    draws = np.concatenate([prev_d, draws])

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


@contextlib.contextmanager
def _profiled(profile_dir: Optional[str], device: torch.device):
    """``torch.profiler`` over the body (CPU operations and, on a CUDA
    device, kernels), written to ``profile_dir`` as a Chrome trace; a
    no-op for None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield  # the run ends on a device synchronize (parallel/runtime.py)
    name = f"walnuts-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(profile_dir, name))


def host_model(evaluate: Callable[[np.ndarray, np.ndarray, np.ndarray], None]):
    """A batched ``fused=True`` model of a function evaluated on the host.

    ``evaluate(theta, logp, grad)`` reads ``theta`` (C', D) float64 and
    writes ``logp`` (C',) and ``grad`` (C', D), float64 C-contiguous. The
    model copies ``theta`` to the host once per call and the results back
    once, to ``theta``'s device and dtype. ``C'`` is the chain count the
    scheduler evaluates (a group's under ``batched_groups``).
    """

    def logp_grad(theta: torch.Tensor):
        C, D = theta.shape
        th = np.ascontiguousarray(theta.detach().to("cpu", torch.float64).numpy())
        buf = np.empty(C * D + C)  # the gradient, then the log density
        evaluate(th, buf[C * D:], buf[:C * D].reshape(C, D))
        out = torch.from_numpy(buf).to(theta.device, theta.dtype)
        return out[C * D:], out[:C * D].view(C, D)

    return logp_grad


def walnuts_pyfunc(logp, **kwargs):
    """Sample a model evaluated on the host, as the reference library's
    ``walnuts_pyfunc`` (and the JAX package's) accepts it:

    - a Python callable ``theta -> (logp, grad)`` on NumPy float64 rows;
    - anything with a ``.ctypes`` attribute, e.g. a numba ``@cfunc`` of the
      ``RawLogpFunc`` signature ``int(size_t n, const double* theta,
      double* grad, double* lp, void* data)``, called directly;
    - a ``(ctypes_cfunc, data)`` tuple of the same C signature, ``data``
      (a ctypes object or None) passed by reference as the last argument.

    Each model evaluation copies the chains' positions to the host once,
    evaluates the rows one after the other, and copies the results back
    once (``host_model``). A raising callable or a nonzero C return code
    gives that row ``logp = -inf`` and a zero gradient. The other keyword
    arguments are ``walnuts``'s (``device`` defaults to ``"cuda"``, the
    sampler's ``dtype`` to float32).
    """
    cfunc = data_ref = None
    if hasattr(logp, "ctypes"):
        cfunc = logp.ctypes
    elif isinstance(logp, tuple):
        cfunc, data = logp
        data_ref = ctypes.byref(data) if data is not None else None

    if cfunc is not None:
        c_double_p = ctypes.POINTER(ctypes.c_double)

        def eval_row(row: np.ndarray, grad_out: np.ndarray) -> float:
            lp = ctypes.c_double()
            rc = cfunc(row.size, row.ctypes.data_as(c_double_p),
                       grad_out.ctypes.data_as(c_double_p), ctypes.byref(lp),
                       data_ref)
            if rc != 0:  # an error code rejects the proposal
                grad_out[:] = 0.0
                return -np.inf
            return lp.value
    else:
        def eval_row(row: np.ndarray, grad_out: np.ndarray) -> float:
            try:
                lp, grad = logp(row)
                grad_out[:] = np.asarray(grad, dtype=np.float64)
                return float(lp)
            except Exception:
                # the reference's NoExceptLogpGrad trap (util.hpp:336-346)
                grad_out[:] = 0.0
                return -np.inf

    def evaluate(theta: np.ndarray, lps: np.ndarray, grads: np.ndarray) -> None:
        for i in range(theta.shape[0]):
            lps[i] = eval_row(theta[i], grads[i])

    return walnuts(host_model(evaluate), fused=True, **kwargs)


__all__ = ["host_model", "walnuts", "walnuts_pyfunc"]
