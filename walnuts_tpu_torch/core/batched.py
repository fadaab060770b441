"""Batched-native WALNUTS scheduling: warmup and sampling blocks.

Counterpart of ``walnuts_tpu/core/batched.py`` (read its module docstring
for the scheduler's design). The chain axis is explicit: every lane field
has a leading ``(C,)``. Per lane the Markov chain is the reference's — the
same halving / reversibility state machine in the integration trip, the
same tier-2 pass (merge cascade, reservoir, top-level Metropolis, restart)
every ``tier2_every`` trips, the same deferred key-split replay and the
same keys — so draws, keys and counters can be compared lane by lane.

What changes in PyTorch:

* Loop control. The reference nests three data-dependent device loops (a
  scan over the R draws, a while on ``any(draws_done <= r)``, and the trip
  while on ``any(active & ~leaf_done)`` with the K cadence). Here they are
  Python loops; each ``any`` is one device-to-host read ("sync"), one per
  trip and one per tier-2 pass. ``BatchedBlockResult.n_syncs`` counts them.
* Banking. The reference banks finished draws in a B-deep ring and emits
  slot ``r mod B`` at scan step r (its scan cannot write a draw-count-deep
  output in place). Here a completing lane writes its draw straight into
  the block's output at its draw index, in place; ``runahead`` B still
  caps how far a lane may run ahead of the slowest (``cap``). The emitted
  draws are the same: a slot is never overwritten before it is emitted.
* The pass on the card. Its ~1200 small operations would each cost the
  host a launch while the device idles, so on CUDA tensors each shape's
  pass is captured once as a CUDA graph and replayed
  (``ops.fused_pass.GraphedPass``): the lane state is copied into the
  graph's input buffers, and the block's outputs are banked eagerly. The
  arithmetic is ``leaf_apply``'s, so the draws are the eager pass's bit
  for bit; CPU tensors run the eager pass. ``n_pass_replays`` and
  ``n_pass_captures`` count the replays and captures.
* Options: every one of the reference's factory. ``pallas_pass=True``
  runs each sampling pass as one launch of the fused-pass kernel
  (``ops.fused_pass``); the pass's arithmetic (``ops.fused_pass.leaf_apply``)
  is shared by both routes. ``bf16_ends`` keeps the merge stack in
  bfloat16 and rounds the U-turn operands in the pass. ``min_latched``
  defers a pass due at the K-trip mark while fewer lanes have latched:
  the trip loop's read then returns two counts, still one sync.
  ``defer_splits=False`` splits the key of every lane that ends an
  attempt in the trip, through a one-round call of
  ``ops.prng.replay_split_chain`` (kernel 1 on the card), which is the
  split bit for bit. ``pallas_replay`` is accepted for the reference's
  signature: the deferred replay is ``ops.prng.replay_split_chain`` for
  either value (its tensor's device picks the plain version or the CUDA
  kernel), and both give the reference's subkeys. ``fresh_cur`` and
  ``bounded_sweeps`` are accepted the same way: in the reference they
  reshape a compiled program (a stale-cursor bit instead of the cursor's
  write; sweeps bounded by the batch's largest merge count), and each is
  bitwise its default route, which is what an eager pass computes for
  either value. The pass is the default's for every value of both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from walnuts_tpu_torch.core.adapt import (
    AdamState,
    adam_init,
    adam_step_size,
    adam_update,
    mass_estimator_inv_mass,
    min_micro_estimate,
    tree_where,
)
from walnuts_tpu_torch.core.transition import _PH_FWD, _PH_REV, FailStats
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.fused_pass import (
    GraphedPass,
    bank_draws,
    fresh_trajectory,
    fused_pass,
    leaf_apply,
    own_storage,
)
from walnuts_tpu_torch.ops.math import LogpGradFn, leapfrog_step, logp_momentum


class LaneState(NamedTuple):
    """Per-lane state, leading chain axis on every field; rows are
    ``(C, D)``, the merge stack ``(C, max_depth - 1, 2, D)``."""

    # persistent orbit state (touched once per leaf, in tier 2)
    key: torch.Tensor          # (C, 2) int32 key data
    depth: torch.Tensor
    out_depth: torch.Tensor
    acc_th_bk: torch.Tensor
    acc_rho_bk: torch.Tensor
    acc_th_fw: torch.Tensor
    acc_rho_fw: torch.Tensor
    acc_th_sel: torch.Tensor
    acc_jt_bk: torch.Tensor
    acc_jt_fw: torch.Tensor
    acc_lp_sel: torch.Tensor
    acc_logw: torch.Tensor
    acc_grad_bk: torch.Tensor
    acc_grad_sel: torch.Tensor
    acc_grad_fw: torch.Tensor
    forward: torch.Tensor
    leaf_idx: torch.Tensor
    n_leaves: torch.Tensor
    stack_e: torch.Tensor
    run_sel: torch.Tensor
    run_sel_logp: torch.Tensor
    run_sel_grad: torch.Tensor
    run_logw: torch.Tensor
    ms_th: torch.Tensor        # leaf-start position / momentum / gradient
    ms_rho: torch.Tensor
    ms_grad: torch.Tensor
    ms_joint: torch.Tensor
    # attempt machine (advanced inside the integration trip)
    halvings: torch.Tensor
    dt: torch.Tensor           # signed micro step size
    steps_done: torch.Tensor
    steps_total: torch.Tensor
    phase: torch.Tensor
    cur_th: torch.Tensor       # cursor
    cur_rho: torch.Tensor
    cur_grad: torch.Tensor
    lp_cur: torch.Tensor
    fwd_th: torch.Tensor       # saved forward endpoint
    fwd_rho: torch.Tensor
    fwd_grad: torch.Tensor
    fwd_logp_pos: torch.Tensor
    fwd_joint: torch.Tensor
    # leaf outcome latches (set by the trip, read by tier 2)
    leaf_done: torch.Tensor
    leaf_ok: torch.Tensor
    ku: torch.Tensor           # (C, 2) key data of the leaf-completing subkey
    # deferred splits: attempt ends since the last pass, and the 1-based
    # end index of the leaf-completing attempt (0 = none)
    n_ends: torch.Tensor
    leaf_end_at: torch.Tensor
    # step-size adaptation (warmup; a frozen dummy when sampling)
    adam: AdamState
    n_grads: torch.Tensor
    fails: FailStats
    draws_done: torch.Tensor


class BatchedBlockResult(NamedTuple):
    draws: torch.Tensor        # (R, C, D)
    logps: torch.Tensor        # (R, C)
    depths: torch.Tensor       # (R, C)
    key: torch.Tensor          # (C, 2) end-of-block keys
    n_grads_delta: torch.Tensor
    fails_delta: FailStats
    n_inner_trips: int         # batched gradient evaluations
    n_outer_trips: int         # tier-2 passes
    n_syncs: int               # device-to-host reads of loop conditions
    n_pass_replays: int = 0    # passes a GraphedPass ran (replays on the card)
    n_pass_captures: int = 0   # CUDA graphs captured


def _r(pred: torch.Tensor) -> torch.Tensor:
    """A per-lane ``(C,)`` predicate as a row mask ``(C, 1)``."""
    return pred[:, None]


def _graph_passes(device: torch.device) -> bool:
    """Whether the unfused pass runs as ``ops.fused_pass.GraphedPass``: on
    the card, where each of a pass's ~1200 operations would otherwise cost
    the host a launch while the device waits."""
    return device.type == "cuda"


def make_batched_sample_block(
    logp_grad: LogpGradFn,
    max_depth: int,
    max_step_halvings: int,
    runahead: int = 8,
    tier2_every: int = 6,
    adapt_step_size: bool = False,
    bf16_ends: bool = False,
    min_latched: int = 0,
    defer_splits: bool = True,
    pallas_replay: bool = False,
    fresh_cur: bool = False,
    adapt_full: bool = False,
    bounded_sweeps: Optional[bool] = None,
    pallas_pass: bool = False,
    pass_tile: Optional[int] = None,
):
    """Build ``(start_block, sample_block)`` for batched-native sampling
    (the reference's factory of the same name, with its options).

    - ``start_block(key, theta, n_grads, fails, step, inv_mass,
      min_micro)`` evaluates one batched gradient (counted) and returns the
      initial ``LaneState``.
    - ``sample_block(state, step, inv_mass, min_micro, max_error,
      num_draws, out=None)`` advances every lane by exactly ``num_draws``
      draws. ``out = (draws (R, C, D), logps (R, C))`` are written in
      place when given (views of a run's preallocated draw tensor).

    ``runahead`` is B (how many draws a lane may run ahead), ``tier2_every``
    is K (trips per tier-2 pass; 0 = a pass whenever no lane can run).
    ``min_latched`` is T: with K > 0, a pass due at the K-trip mark waits
    while fewer than T of the lanes that may run have latched a leaf and a
    lane can still run. ``adapt_step_size`` makes Adam observe the coarsest
    attempt of every leaf inside the trip. ``bf16_ends``,
    ``defer_splits``, ``pallas_replay``, ``fresh_cur`` and
    ``bounded_sweeps`` are described in the module docstring: the last
    three are accepted and leave the pass as it is; every option but
    ``bf16_ends`` is scheduling only (same draws, keys and counters), and
    ``bf16_ends`` gives the classic path's ``bf16_ends`` draws. ``adapt_full`` makes the block asynchronous adaptive warmup (the
    estimators are applied in the tier-2 pass); then
    ``sample_block.adapt(state, aux, max_error, num_draws, out=None)``
    returns ``(BatchedBlockResult, LaneState, aux')`` with ``aux = (mass,
    mm_est, iteration, inv_mass, step, min_micro)``.

    ``pallas_pass=True`` runs every tier-2 pass of the sampling block as
    one call of ``ops.fused_pass.fused_pass``: the CUDA kernel for CUDA
    tensors (``pass_tile`` chains per CUDA block, default 8), its plain
    version for CPU tensors. The draws are the unfused pass's. It covers
    the default sampling configuration only, as in the reference: with
    ``adapt_full``, ``adapt_step_size``, ``bf16_ends``, ``fresh_cur``,
    ``pallas_replay`` or ``defer_splits=False`` it raises ``ValueError``,
    so the kernel is never handed a configuration it does not compute.
    """
    if pallas_pass and (adapt_full or fresh_cur or bf16_ends or adapt_step_size
                        or pallas_replay or not defer_splits):
        raise ValueError(
            "pallas_pass=True covers the default sampling configuration "
            "only (defer_splits, no adapt_full/fresh_cur/bf16_ends/"
            "adapt_step_size/pallas_replay); other configurations use the "
            "unfused tier-2 pass")
    n_slots = max(max_depth - 1, 1)
    B = max(int(runahead), 1)
    K = int(tier2_every)
    T = int(min_latched)

    def _lane_state(key, theta, logp0, grad0, step, inv_mass, min_micro,
                    adam, n_grads, fails):
        """Batched LaneState from a start point with known logp/grad."""
        C, D = theta.shape
        dev = theta.device
        knew, rho0, joint0, forward0, dt0 = fresh_trajectory(
            key, theta, logp0, step, inv_mass)
        i32 = lambda v: torch.full((C,), v, dtype=torch.int32, device=dev)
        false = lambda: torch.zeros((C,), dtype=torch.bool, device=dev)
        st = LaneState(
            key=knew, depth=i32(1), out_depth=i32(max_depth + 1),
            acc_th_bk=theta, acc_rho_bk=rho0, acc_th_fw=theta,
            acc_rho_fw=rho0, acc_th_sel=theta,
            acc_jt_bk=joint0, acc_jt_fw=joint0, acc_lp_sel=logp0,
            acc_logw=joint0,
            acc_grad_bk=grad0, acc_grad_sel=grad0, acc_grad_fw=grad0,
            forward=forward0, leaf_idx=i32(0), n_leaves=i32(1),
            stack_e=torch.zeros((C, n_slots, 2, D), dtype=(
                torch.bfloat16 if bf16_ends else theta.dtype), device=dev),
            run_sel=theta, run_sel_logp=logp0, run_sel_grad=grad0,
            run_logw=torch.full_like(logp0, float("-inf")),
            ms_th=theta, ms_rho=rho0, ms_grad=grad0, ms_joint=joint0,
            halvings=i32(0), dt=dt0, steps_done=i32(0),
            steps_total=min_micro.to(torch.int32), phase=i32(_PH_FWD),
            cur_th=theta, cur_rho=rho0, cur_grad=grad0, lp_cur=logp0,
            # never read before a passing forward attempt writes them
            fwd_th=theta, fwd_rho=rho0, fwd_grad=grad0, fwd_logp_pos=logp0,
            fwd_joint=joint0,
            leaf_done=false(), leaf_ok=false(), ku=knew,
            n_ends=i32(0), leaf_end_at=i32(0),
            adam=adam, n_grads=n_grads, fails=fails, draws_done=i32(0),
        )
        # the fused pass writes in place: no field may share storage
        return own_storage(st) if pallas_pass else st

    def start_block(key, theta, n_grads, fails, step, inv_mass, min_micro,
                    adam=None):
        if adam is None:  # sampling: a frozen dummy
            adam = adam_init(step.to(theta.dtype))
        # the block-entry gradient is fresh and counted
        logp0, grad0 = logp_grad(theta)
        return _lane_state(key, theta, logp0, grad0, step, inv_mass,
                           min_micro, adam, n_grads + 1, fails)

    # ------------------------------------------------------------------
    # integration trip: one batched gradient + the attempt machine
    # ------------------------------------------------------------------
    def inner_trip(s: LaneState, active, step, inv_mass, min_micro,
                   max_error):
        run = active & ~s.leaf_done
        th, rho, gr, lp = leapfrog_step(logp_grad, inv_mass, _r(s.dt),
                                        s.cur_th, s.cur_rho, s.cur_grad)
        run1 = _r(run)
        cur_th = torch.where(run1, th, s.cur_th)
        cur_rho = torch.where(run1, rho, s.cur_rho)
        cur_grad = torch.where(run1, gr, s.cur_grad)
        lp_cur = torch.where(run, lp, s.lp_cur)
        run_i = run.to(torch.int32)
        steps_done = s.steps_done + run_i
        n_grads = s.n_grads + run_i

        att_done = run & (steps_done >= s.steps_total)
        joint_n = lp_cur + logp_momentum(cur_rho, inv_mass)
        if defer_splits:
            # count attempt ends; tier 2 replays the splits
            n_ends = s.n_ends + att_done.to(torch.int32)

        in_fwd = s.phase == _PH_FWD
        f_done = att_done & in_fwd
        f_err = torch.abs(s.ms_joint - joint_n)
        f_ok = f_err <= max_error  # NaN -> False -> halve / fail

        if adapt_step_size:
            # Adam observes exp(-|dH|) of each leaf's coarsest attempt
            accept = torch.exp(-f_err).to(s.dt.dtype)
            accept = torch.where(torch.isnan(accept), torch.zeros_like(accept),
                                 accept)
            observe = f_done & (s.halvings == 0)
            adam = tree_where(observe, adam_update(s.adam, accept), s.adam)
        else:
            adam = s.adam

        need_rev = s.steps_total >= 2 * min_micro
        start_rev = f_done & f_ok & need_rev
        leaf_ok_now = f_done & f_ok & ~need_rev
        more_h = (s.halvings + 1) < max_step_halvings
        restart = f_done & ~f_ok & more_h
        halve_exh = f_done & ~f_ok & ~more_h

        r_done = att_done & ~in_fwd
        r_err = torch.abs(joint_n - s.fwd_joint)
        r_within = r_err <= max_error
        more_rev = s.steps_total >= 2 * min_micro
        next_rev = r_done & ~r_within & more_rev
        leaf_ok_now = leaf_ok_now | (r_done & ~r_within & ~more_rev)
        leaf_fail_now = halve_exh | (r_done & r_within)

        set_fwd = f_done & f_ok
        sf1 = _r(set_fwd)
        fwd_th = torch.where(sf1, cur_th, s.fwd_th)
        fwd_rho = torch.where(sf1, cur_rho, s.fwd_rho)
        fwd_grad = torch.where(sf1, cur_grad, s.fwd_grad)
        fwd_logp_pos = torch.where(set_fwd, lp_cur, s.fwd_logp_pos)
        fwd_joint = torch.where(set_fwd, joint_n, s.fwd_joint)

        latch = leaf_ok_now | leaf_fail_now
        key, ku = s.key, s.ku
        if defer_splits:
            leaf_end_at = torch.where(latch, n_ends, s.leaf_end_at)
        else:
            # split every ending lane's key now, the leaf's subkey latched
            # as ku: one round of the replay, bitwise the split
            n_ends, leaf_end_at = s.n_ends, s.leaf_end_at
            key, ku = prng.replay_split_chain(
                s.key, s.ku, att_done.to(torch.int32),
                (att_done & latch).to(torch.int32))
        leaf_done = s.leaf_done | latch
        leaf_ok = torch.where(latch, leaf_ok_now, s.leaf_ok)

        fails = FailStats(
            n_halve_fail=s.fails.n_halve_fail + halve_exh.to(torch.int32),
            n_nonfinite=s.fails.n_nonfinite
            + (att_done & ~torch.isfinite(lp_cur)).to(torch.int32),
            n_depth_exhausted=s.fails.n_depth_exhausted,
        )

        # next-attempt setup (reads the pre-update steps_total / dt)
        to_rev = start_rev | next_rev
        halvings = torch.where(restart, s.halvings + 1, s.halvings)
        steps_total = torch.where(
            restart, s.steps_total * 2,
            torch.where(to_rev, s.steps_total // 2, s.steps_total))
        dt = torch.where(restart, s.dt * 0.5,
                         torch.where(to_rev, s.dt * 2.0, s.dt))
        steps_done = torch.where(restart | to_rev,
                                 torch.zeros_like(steps_done), steps_done)
        phase = torch.where(to_rev, torch.full_like(s.phase, _PH_REV), s.phase)
        # the reversed cursor is the forward endpoint, momentum negated
        tr1, rs1 = _r(to_rev), _r(restart)
        cur_th = torch.where(tr1, fwd_th, torch.where(rs1, s.ms_th, cur_th))
        cur_rho = torch.where(tr1, -fwd_rho,
                              torch.where(rs1, s.ms_rho, cur_rho))
        cur_grad = torch.where(tr1, fwd_grad,
                               torch.where(rs1, s.ms_grad, cur_grad))

        return s._replace(
            key=key, ku=ku,
            cur_th=cur_th, cur_rho=cur_rho, cur_grad=cur_grad, lp_cur=lp_cur,
            fwd_th=fwd_th, fwd_rho=fwd_rho, fwd_grad=fwd_grad,
            fwd_logp_pos=fwd_logp_pos, fwd_joint=fwd_joint,
            halvings=halvings, dt=dt, steps_done=steps_done,
            steps_total=steps_total, phase=phase,
            leaf_done=leaf_done, leaf_ok=leaf_ok,
            n_ends=n_ends, leaf_end_at=leaf_end_at, adam=adam,
            n_grads=n_grads, fails=fails,
        )

    # a GraphedPass for each key of the pass's arguments (max_depth,
    # bf16_ends and defer_splits are the factory's), freed with the factory
    graphs = {}

    def _pass_graph(args, R: int, replay) -> GraphedPass:
        key = GraphedPass.key(args, R)
        if key not in graphs:
            graphs[key] = GraphedPass(args, R, max_depth=max_depth,
                                      replay=replay, bf16_ends=bf16_ends)
        return graphs[key]

    def _run(state: LaneState, aux, step, inv_mass, min_micro, max_error,
             num_draws: int, out):
        """The block loop shared by sampling (``aux`` None) and warmup."""
        R = int(num_draws)
        C, D = state.run_sel.shape
        dev = state.run_sel.device
        if out is None:
            draws = torch.empty((R, C, D), dtype=state.run_sel.dtype, device=dev)
            logps = torch.empty((R, C), dtype=state.ms_joint.dtype, device=dev)
        else:
            draws, logps = out
        depths = torch.empty((R, C), dtype=torch.int32, device=dev)
        # a copy: the fused pass updates n_depth_exhausted in place
        n_grads0, fails0 = state.n_grads, FailStats(*(f.clone() for f in state.fails))
        n_inner = n_outer = n_syncs = n_replays = 0
        graph = captures0 = None
        replay = prng.replay_split_chain if defer_splits else None
        for r in range(R):
            cap = min(R, r + B)
            while True:
                n_syncs += 1
                if not bool((state.draws_done <= r).any()):
                    break
                if aux is not None:
                    mass, mm_est, iteration, inv_mass, step, min_micro = aux
                active = state.draws_done < cap
                n0 = n_inner
                while K <= 0 or T > 0 or n_inner - n0 < K:
                    n_syncs += 1
                    if T > 0 and K > 0:
                        # one read: the lanes that can run, and those latched
                        runnable, latched = torch.stack([
                            (active & ~state.leaf_done).sum(),
                            (active & state.leaf_done).sum()]).tolist()
                        if not runnable or (n_inner - n0 >= K and latched >= T):
                            break
                    elif not bool((active & ~state.leaf_done).any()):
                        break
                    state = inner_trip(state, active, step, inv_mass,
                                       min_micro, max_error)
                    n_inner += 1
                n_outer += 1
                if pallas_pass:  # one launch: the pass and banking, in place
                    fused_pass(state, step, inv_mass, min_micro, cap, R,
                               max_depth, (draws, logps, depths),
                               pass_tile=pass_tile)
                    continue
                args = (state, active, step, inv_mass, min_micro,
                        None if aux is None else aux[:3])
                if graph is None and _graph_passes(dev):
                    graph = _pass_graph(args, R, replay)
                    captures0 = graph.captures
                if graph is not None:
                    applied = graph.run(args)
                    n_replays += 1
                else:
                    applied = leaf_apply(*args[:5], R, max_depth=max_depth,
                                         replay=replay, aux=args[5],
                                         bf16_ends=bf16_ends)
                state, complete, sel_theta, sel_logp, out_depth, bank_idx, aux = applied
                # bank completed draws in place at their draw index
                bank_draws((draws, logps, depths), complete, sel_theta,
                           sel_logp, out_depth, bank_idx)
        if graph is not None:  # the next replay overwrites the graph's outputs
            state, aux = graph.detach((state, aux))
        res = BatchedBlockResult(
            draws=draws, logps=logps, depths=depths, key=state.key,
            # the block's own work: excludes start_block's evaluation
            n_grads_delta=state.n_grads - n_grads0,
            fails_delta=FailStats(*(a - b for a, b in zip(state.fails, fails0))),
            n_inner_trips=n_inner, n_outer_trips=n_outer, n_syncs=n_syncs,
            n_pass_replays=n_replays,
            n_pass_captures=0 if graph is None else graph.captures - captures0,
        )
        return res, state, aux

    def sample_block(state: LaneState, step, inv_mass, min_micro, max_error,
                     num_draws: int, out=None) -> BatchedBlockResult:
        dtype = state.run_sel.dtype
        max_error = torch.as_tensor(max_error, dtype=dtype, device=step.device)
        res, _, _ = _run(state, None, step.to(dtype), inv_mass,
                         min_micro.to(torch.int32), max_error, num_draws, out)
        return res

    def sample_block_adapt(state: LaneState, aux, max_error, num_draws: int,
                           out=None):
        """Asynchronous adaptive-warmup block: lanes adapt and restart
        individually inside the tier-2 pass (no cross-lane draw barrier).
        Returns ``(BatchedBlockResult, final LaneState, aux')``."""
        max_error = torch.as_tensor(max_error, dtype=state.run_sel.dtype,
                                    device=state.run_sel.device)
        return _run(state, aux, None, None, None, max_error, num_draws, out)

    sample_block.start_block_cached = _lane_state
    sample_block.adapt = sample_block_adapt if adapt_full else None
    return start_block, sample_block


def make_batched_warmup_block(logp_grad: LogpGradFn, sampling_cfg,
                              pallas_replay: bool = False, runahead: int = 4,
                              tier2_every: int = 6,
                              bounded_sweeps: Optional[bool] = None):
    """Asynchronous adaptive warmup block (the reference's function of the
    same name): each lane adapts from its own draws at its own draw
    boundary and restarts at once, with ``runahead`` draws of run-ahead.
    ``pallas_replay`` and ``bounded_sweeps`` as in
    :func:`make_batched_sample_block`.

    Returns ``warmup_block(state: WarmupState, n, out=None) -> (state',
    BatchedBlockResult)``; ``out`` as in ``sample_block``, or a function
    of the log density's dtype that returns it.
    """
    from walnuts_tpu_torch.core.sampler import WarmupState

    _, sample_block = make_batched_sample_block(
        logp_grad,
        sampling_cfg.max_trajectory_doublings,
        sampling_cfg.max_step_halvings,
        runahead=runahead,
        tier2_every=tier2_every,
        adapt_step_size=True,
        pallas_replay=pallas_replay,
        adapt_full=True,
        bounded_sweeps=bounded_sweeps,
    )
    block_adapt = sample_block.adapt
    max_error = sampling_cfg.max_hamiltonian_error

    def warmup_block(ws: WarmupState, n: int, out=None):
        # one fresh evaluation per block (counted); within the block the
        # selected state's logp/grad ride the lane state
        logp0, grad0 = logp_grad(ws.theta)
        if callable(out):
            out = out(logp0.dtype)
        inv_mass = mass_estimator_inv_mass(ws.mass)
        step = adam_step_size(ws.adam)
        min_micro = min_micro_estimate(ws.min_micro)
        st = sample_block.start_block_cached(
            ws.key, ws.theta, logp0, grad0, step, inv_mass, min_micro,
            ws.adam, ws.n_grads + 1, ws.fails,
        )
        aux = (ws.mass, ws.min_micro, ws.iteration, inv_mass, step, min_micro)
        res, st, aux = block_adapt(st, aux, max_error, int(n), out)
        mass, mm_est, iteration = aux[:3]
        ws = WarmupState(
            key=res.key, theta=res.draws[-1], adam=st.adam, mass=mass,
            min_micro=mm_est, iteration=iteration, n_grads=st.n_grads,
            fails=st.fails,
        )
        return ws, res

    return warmup_block


__all__ = [
    "BatchedBlockResult",
    "LaneState",
    "make_batched_sample_block",
    "make_batched_warmup_block",
]
