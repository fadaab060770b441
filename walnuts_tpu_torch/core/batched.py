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
* Options. Only the reference's default scheduler is ported: deferred key
  splits with one replay entry point (``ops.prng.replay_split_chain``,
  whose tensor's device picks the plain version or the CUDA kernel), the
  static form of the tier-2 sweeps, no ``bf16_ends`` / ``fresh_cur`` /
  ``min_latched`` / fused pass.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from walnuts_tpu_torch.core.adapt import (
    AdamState,
    adam_init,
    adam_step_size,
    adam_update,
    mass_estimator_inv_mass,
    mass_estimator_observe,
    min_micro_estimate,
    min_micro_observe,
    tree_where,
)
from walnuts_tpu_torch.core.transition import _PH_FWD, _PH_REV, FailStats
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.math import (
    LogpGradFn,
    count_trailing_zeros,
    leapfrog_step,
    log_sum_exp,
    logp_momentum,
)


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


def _r(pred: torch.Tensor) -> torch.Tensor:
    """A per-lane ``(C,)`` predicate as a row mask ``(C, 1)``."""
    return pred[:, None]


def make_batched_sample_block(
    logp_grad: LogpGradFn,
    max_depth: int,
    max_step_halvings: int,
    runahead: int = 8,
    tier2_every: int = 6,
    adapt_full: bool = False,
):
    """Build ``(start_block, sample_block)`` for batched-native sampling
    (the reference's factory of the same name, default configuration).

    - ``start_block(key, theta, n_grads, fails, step, inv_mass,
      min_micro)`` evaluates one batched gradient (counted) and returns the
      initial ``LaneState``.
    - ``sample_block(state, step, inv_mass, min_micro, max_error,
      num_draws, out=None)`` advances every lane by exactly ``num_draws``
      draws. ``out = (draws (R, C, D), logps (R, C))`` are written in
      place when given (views of a run's preallocated draw tensor).

    ``runahead`` is B (how many draws a lane may run ahead), ``tier2_every``
    is K (trips per tier-2 pass; 0 = a pass whenever no lane can run).
    ``adapt_full`` makes the block asynchronous adaptive warmup (Adam
    observes inside the trip, the estimators in the tier-2 pass); then
    ``sample_block.adapt(state, aux, max_error, num_draws, out=None)``
    returns ``(BatchedBlockResult, LaneState, aux')`` with ``aux = (mass,
    mm_est, iteration, inv_mass, step, min_micro)``.
    """
    n_slots = max(max_depth - 1, 1)
    B = max(int(runahead), 1)
    K = int(tier2_every)

    def _fresh_trajectory(key, theta, logp0, step, inv_mass):
        """One 3-way key split, momentum ~ N(0, M) and the direction bit
        per lane (``transition_w`` entry, walnuts.hpp:528-535)."""
        dtype = theta.dtype
        ks = prng.split(key, 3)
        # subkeys 1 (momentum) and 2 (direction) hashed in one threefry:
        # the direction bit is the uniform of subkey 2's counter 0
        x0, x1 = prng.counter_bits(ks[:, 1:], theta.shape[1:])
        z = prng.normal_from_bits(x0[:, 0], x1[:, 0], dtype)
        rho0 = z / torch.sqrt(inv_mass)
        joint0 = logp0 + logp_momentum(rho0, inv_mass)
        forward0 = prng.uniform_from_bits(x0[:, 1, 0], x1[:, 1, 0], dtype) < 0.5
        dt0 = torch.where(forward0, step, -step)
        return ks[:, 0].contiguous(), rho0, joint0, forward0, dt0

    def _lane_state(key, theta, logp0, grad0, step, inv_mass, min_micro,
                    adam, n_grads, fails):
        """Batched LaneState from a start point with known logp/grad."""
        C, D = theta.shape
        dev = theta.device
        knew, rho0, joint0, forward0, dt0 = _fresh_trajectory(
            key, theta, logp0, step, inv_mass)
        i32 = lambda v: torch.full((C,), v, dtype=torch.int32, device=dev)
        false = lambda: torch.zeros((C,), dtype=torch.bool, device=dev)
        return LaneState(
            key=knew, depth=i32(1), out_depth=i32(max_depth + 1),
            acc_th_bk=theta, acc_rho_bk=rho0, acc_th_fw=theta,
            acc_rho_fw=rho0, acc_th_sel=theta,
            acc_jt_bk=joint0, acc_jt_fw=joint0, acc_lp_sel=logp0,
            acc_logw=joint0,
            acc_grad_bk=grad0, acc_grad_sel=grad0, acc_grad_fw=grad0,
            forward=forward0, leaf_idx=i32(0), n_leaves=i32(1),
            stack_e=torch.zeros((C, n_slots, 2, D), dtype=theta.dtype,
                                device=dev),
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
        # deferred splits: count attempt ends; tier 2 replays the splits
        n_ends = s.n_ends + att_done.to(torch.int32)

        in_fwd = s.phase == _PH_FWD
        f_done = att_done & in_fwd
        f_err = torch.abs(s.ms_joint - joint_n)
        f_ok = f_err <= max_error  # NaN -> False -> halve / fail

        if adapt_full:
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
        leaf_end_at = torch.where(latch, n_ends, s.leaf_end_at)
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
            cur_th=cur_th, cur_rho=cur_rho, cur_grad=cur_grad, lp_cur=lp_cur,
            fwd_th=fwd_th, fwd_rho=fwd_rho, fwd_grad=fwd_grad,
            fwd_logp_pos=fwd_logp_pos, fwd_joint=fwd_joint,
            halvings=halvings, dt=dt, steps_done=steps_done,
            steps_total=steps_total, phase=phase,
            leaf_done=leaf_done, leaf_ok=leaf_ok,
            n_ends=n_ends, leaf_end_at=leaf_end_at, adam=adam,
            n_grads=n_grads, fails=fails,
        )

    # ------------------------------------------------------------------
    # tier 2: leaf-level orbit bookkeeping for every latched lane, plus
    # the deferred-split replay, banking values and trajectory restart
    # ------------------------------------------------------------------
    def leaf_apply(s: LaneState, active, step, inv_mass, min_micro,
                   block_draws: int, aux=None):
        jdtype = s.ms_joint.dtype
        dev = s.run_sel.device
        pend = active & s.leaf_done
        fwd_th, fwd_rho, fwd_grad = s.fwd_th, s.fwd_rho, s.fwd_grad
        fwd_joint, fwd_logp_pos = s.fwd_joint, s.fwd_logp_pos
        leaf_ok = pend & s.leaf_ok
        leaf_fail = pend & ~s.leaf_ok

        sgn = torch.where(s.forward, 1.0, -1.0).to(s.run_sel.dtype)

        def uturn_end(old_th, old_rho):
            delta = _r(sgn) * inv_mass * (fwd_th - old_th)
            return ((torch.sum(fwd_rho * delta, -1) < 0)
                    | (torch.sum(old_rho * delta, -1) < 0))

        # merge cascade: sub-U-turn checks against the stacked older-side
        # endpoints (build_span, walnuts.hpp:490-494); a leaf's merge count
        # is the trailing-zero count of its 1-based index
        n_merges = count_trailing_zeros(s.leaf_idx + 1)
        cur_end = torch.stack([fwd_th, fwd_rho], dim=1)
        ok = torch.ones_like(leaf_ok)
        for i in range(n_slots):
            do = leaf_ok & (i < n_merges) & ok
            slot = s.stack_e[:, i]
            ut = uturn_end(slot[:, 0], slot[:, 1])
            cur_end = torch.where(do[:, None, None], slot, cur_end)
            ok = ok & ~(do & ut)
        sub_uturn = leaf_ok & ~ok
        leaf_ok = leaf_ok & ok

        # deferred key-split replay: the plain version or the CUDA kernel
        key_r, ku = prng.replay_split_chain(s.key, s.ku, s.n_ends,
                                            s.leaf_end_at)
        s = s._replace(key=key_r, ku=ku,
                       n_ends=torch.zeros_like(s.n_ends),
                       leaf_end_at=torch.zeros_like(s.leaf_end_at))
        # the three leaf uniforms, from the resolving leaf's subkey
        unifs = prng.uniform(ku, (3,), s.run_sel.dtype)

        new_leaf_idx = s.leaf_idx + 1
        subtree_done = leaf_ok & (new_leaf_idx >= s.n_leaves)
        push = leaf_ok & ~subtree_done
        # stack push: lane i writes slot n_merges[i]
        slots = torch.arange(n_slots, device=dev, dtype=torch.int32)
        write_mask = push[:, None] & (n_merges[:, None] == slots[None, :])
        stack_e = torch.where(write_mask[:, :, None, None], cur_end[:, None],
                              s.stack_e)

        # reservoir (streaming Barker)
        run_logw_new = log_sum_exp(s.run_logw, fwd_joint)
        take_leaf = torch.log(unifs[:, 0]) < fwd_joint - run_logw_new
        upd = leaf_ok & take_leaf

        # top-level Metropolis + combined U-turn on subtree completion
        fw1 = _r(s.forward)
        acc_old_th = torch.where(fw1, s.acc_th_bk, s.acc_th_fw)
        acc_old_rho = torch.where(fw1, s.acc_rho_bk, s.acc_rho_fw)
        ut_top = uturn_end(acc_old_th, acc_old_rho)
        take_new = torch.log(unifs[:, 1]) < run_logw_new - s.acc_logw
        upd_fw = subtree_done & s.forward
        upd_bk = subtree_done & ~s.forward
        take = subtree_done & take_new
        end_uturn = subtree_done & ut_top
        new_depth = s.depth + 1
        deeper = subtree_done & ~ut_top & (new_depth <= max_depth)
        exhausted = subtree_done & ~ut_top & (new_depth > max_depth)

        fail = leaf_fail | sub_uturn
        complete = fail | end_uturn | exhausted
        out_depth = torch.where(
            fail | end_uturn, s.depth,
            torch.where(exhausted, torch.full_like(s.depth, max_depth + 1),
                        s.out_depth))

        # run-selection values after this leaf (pre-restart)
        run_sel_v = torch.where(_r(upd), fwd_th, s.run_sel)
        run_sel_logp_v = torch.where(upd, fwd_logp_pos, s.run_sel_logp)
        run_sel_grad_v = torch.where(_r(upd), fwd_grad, s.run_sel_grad)

        # emitted draw values (the selected state of the combined orbit)
        sel_theta = torch.where(_r(take), run_sel_v, s.acc_th_sel)
        sel_logp = torch.where(take, run_sel_logp_v, s.acc_lp_sel)
        sel_grad = torch.where(_r(take), run_sel_grad_v, s.acc_grad_sel)

        new_draws_done = s.draws_done + complete.to(torch.int32)
        # restart on completion, except at the block end: the lane's key
        # must equal the end-of-draw key so the next block continues the
        # same per-chain stream
        restart = complete & (new_draws_done < block_draws)
        r1 = _r(restart)

        if adapt_full:
            # per-lane warmup adaptation at the lane's own draw boundary
            # (AdaptiveWalnuts::operator(), adaptive_walnuts.hpp:234-251)
            mass, mm_est, iteration = aux
            mass = tree_where(
                complete,
                mass_estimator_observe(mass, sel_theta, sel_grad, iteration),
                mass)
            mm_est = tree_where(
                complete,
                min_micro_observe(mm_est, torch.ones_like(out_depth) << out_depth),
                mm_est)
            iteration = iteration + complete.to(torch.int32)
            step_next = torch.where(restart, adam_step_size(s.adam), step)
            inv_mass_next = torch.where(r1, mass_estimator_inv_mass(mass),
                                        inv_mass)
            min_micro_next = torch.where(restart, min_micro_estimate(mm_est),
                                         min_micro)
            aux = (mass, mm_est, iteration, inv_mass_next, step_next,
                   min_micro_next)
        else:
            step_next, inv_mass_next, min_micro_next = step, inv_mass, min_micro

        knew, rho0, joint0, forward0, dt0 = _fresh_trajectory(
            s.key, sel_theta, sel_logp, step_next, inv_mass_next)

        cont_m = pend & ~complete

        # single-pass merged field writes (restart / continue / unchanged)
        new_dir = torch.where(restart, forward0,
                              torch.where(deeper, unifs[:, 2] < 0.5, s.forward))
        nd1, ufw1, ubk1, tk1 = _r(new_dir), _r(upd_fw), _r(upd_bk), _r(take)
        acc_grad_fw = torch.where(r1, sel_grad,
                                  torch.where(ufw1, fwd_grad, s.acc_grad_fw))
        acc_grad_bk = torch.where(r1, sel_grad,
                                  torch.where(ubk1, fwd_grad, s.acc_grad_bk))
        acc_grad_sel = torch.where(r1, sel_grad,
                                   torch.where(tk1, sel_grad, s.acc_grad_sel))
        acc_th_bk = torch.where(r1, sel_theta,
                                torch.where(ubk1, fwd_th, s.acc_th_bk))
        acc_rho_bk = torch.where(r1, rho0,
                                 torch.where(ubk1, fwd_rho, s.acc_rho_bk))
        acc_th_fw = torch.where(r1, sel_theta,
                                torch.where(ufw1, fwd_th, s.acc_th_fw))
        acc_rho_fw = torch.where(r1, rho0,
                                 torch.where(ufw1, fwd_rho, s.acc_rho_fw))
        acc_th_sel = torch.where(r1, sel_theta,
                                 torch.where(tk1, sel_theta, s.acc_th_sel))
        acc_jt_bk = torch.where(restart, joint0,
                                torch.where(upd_bk, fwd_joint, s.acc_jt_bk))
        acc_jt_fw = torch.where(restart, joint0,
                                torch.where(upd_fw, fwd_joint, s.acc_jt_fw))
        acc_lp_sel = torch.where(restart, sel_logp,
                                 torch.where(take, sel_logp, s.acc_lp_sel))
        acc_logw = torch.where(
            restart, joint0,
            torch.where(subtree_done, log_sum_exp(s.acc_logw, run_logw_new),
                        s.acc_logw))

        # leaf start for continuing lanes: the orbit endpoint in the new
        # direction on a new doubling, this leaf's endpoint on a push
        acc_end_th = torch.where(nd1, acc_th_fw, acc_th_bk)
        acc_end_rho = torch.where(nd1, acc_rho_fw, acc_rho_bk)
        acc_end_grad = torch.where(nd1, acc_grad_fw, acc_grad_bk)
        acc_end_joint = torch.where(new_dir, acc_jt_fw, acc_jt_bk)
        d1m, p1m = _r(deeper), _r(push)
        ms_th = torch.where(r1, sel_theta, torch.where(
            d1m, acc_end_th, torch.where(p1m, fwd_th, s.ms_th)))
        ms_rho = torch.where(r1, rho0, torch.where(
            d1m, acc_end_rho, torch.where(p1m, fwd_rho, s.ms_rho)))
        ms_grad = torch.where(r1, sel_grad, torch.where(
            d1m, acc_end_grad, torch.where(p1m, fwd_grad, s.ms_grad)))
        ms_joint = torch.where(restart, joint0, torch.where(
            deeper, acc_end_joint, torch.where(push, fwd_joint, s.ms_joint)))
        rc = restart | cont_m
        rc1m = _r(rc)
        zero_i = torch.zeros_like(s.depth)
        one_i = torch.ones_like(s.depth)

        s = s._replace(
            key=torch.where(r1, knew, s.key),
            depth=torch.where(restart, one_i,
                              torch.where(deeper, new_depth, s.depth)),
            out_depth=torch.where(restart,
                                  torch.full_like(out_depth, max_depth + 1),
                                  out_depth),
            acc_th_bk=acc_th_bk, acc_rho_bk=acc_rho_bk,
            acc_th_fw=acc_th_fw, acc_rho_fw=acc_rho_fw,
            acc_th_sel=acc_th_sel,
            acc_jt_bk=acc_jt_bk, acc_jt_fw=acc_jt_fw,
            acc_lp_sel=acc_lp_sel, acc_logw=acc_logw,
            acc_grad_bk=acc_grad_bk, acc_grad_fw=acc_grad_fw,
            acc_grad_sel=acc_grad_sel,
            forward=new_dir,
            leaf_idx=torch.where(restart | deeper, zero_i,
                                 torch.where(leaf_ok, new_leaf_idx, s.leaf_idx)),
            n_leaves=torch.where(restart, one_i, torch.where(
                deeper, one_i << (new_depth - 1), s.n_leaves)),
            stack_e=stack_e,
            run_sel=torch.where(r1, sel_theta, run_sel_v),
            run_sel_logp=torch.where(restart, sel_logp, run_sel_logp_v),
            run_sel_grad=torch.where(r1, sel_grad, run_sel_grad_v),
            run_logw=torch.where(
                restart | deeper,
                torch.full_like(s.run_logw, float("-inf"), dtype=jdtype),
                torch.where(leaf_ok, run_logw_new, s.run_logw)),
            ms_th=ms_th, ms_rho=ms_rho, ms_grad=ms_grad, ms_joint=ms_joint,
            halvings=torch.where(rc, zero_i, s.halvings),
            dt=torch.where(restart, dt0, torch.where(
                cont_m, torch.where(new_dir, step, -step), s.dt)),
            steps_done=torch.where(rc, zero_i, s.steps_done),
            # restarting lanes take the (possibly just adapted) next-draw
            # min_micro; continuing lanes keep the current draw's
            steps_total=torch.where(restart, min_micro_next, torch.where(
                cont_m, min_micro, s.steps_total)),
            phase=torch.where(rc, torch.full_like(s.phase, _PH_FWD), s.phase),
            cur_th=torch.where(rc1m, ms_th, s.cur_th),
            cur_rho=torch.where(rc1m, ms_rho, s.cur_rho),
            cur_grad=torch.where(rc1m, ms_grad, s.cur_grad),
            lp_cur=torch.where(restart, sel_logp, s.lp_cur),
            leaf_done=s.leaf_done & ~pend,
            leaf_ok=s.leaf_ok & ~pend,
            fails=s.fails._replace(
                n_depth_exhausted=s.fails.n_depth_exhausted
                + exhausted.to(torch.int32)),
            draws_done=new_draws_done,
        )
        return s, complete, sel_theta, sel_logp, out_depth, new_draws_done - 1, aux

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
        lanes = torch.arange(C, device=dev)
        n_grads0, fails0 = state.n_grads, state.fails
        n_inner = n_outer = n_syncs = 0
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
                while K <= 0 or n_inner - n0 < K:
                    n_syncs += 1
                    if not bool((active & ~state.leaf_done).any()):
                        break
                    state = inner_trip(state, active, step, inv_mass,
                                       min_micro, max_error)
                    n_inner += 1
                n_outer += 1
                state, complete, sel_theta, sel_logp, out_depth, bank_idx, aux = (
                    leaf_apply(state, active, step, inv_mass, min_micro, R,
                               aux=None if aux is None else aux[:3]))
                # bank completed draws in place at their draw index; other
                # lanes write their row back unchanged
                idx = bank_idx.clamp(0, R - 1).long()
                draws[idx, lanes] = torch.where(_r(complete), sel_theta,
                                                draws[idx, lanes])
                logps[idx, lanes] = torch.where(complete, sel_logp,
                                                logps[idx, lanes])
                depths[idx, lanes] = torch.where(complete, out_depth,
                                                 depths[idx, lanes])
        res = BatchedBlockResult(
            draws=draws, logps=logps, depths=depths, key=state.key,
            # the block's own work: excludes start_block's evaluation
            n_grads_delta=state.n_grads - n_grads0,
            fails_delta=FailStats(*(a - b for a, b in zip(state.fails, fails0))),
            n_inner_trips=n_inner, n_outer_trips=n_outer, n_syncs=n_syncs,
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
                              runahead: int = 4, tier2_every: int = 6):
    """Asynchronous adaptive warmup block (the reference's function of the
    same name): each lane adapts from its own draws at its own draw
    boundary and restarts at once, with ``runahead`` draws of run-ahead.

    Returns ``warmup_block(state: WarmupState, n, out=None) -> (state',
    BatchedBlockResult)``; ``out`` as in ``sample_block``.
    """
    from walnuts_tpu_torch.core.sampler import WarmupState

    _, sample_block = make_batched_sample_block(
        logp_grad,
        sampling_cfg.max_trajectory_doublings,
        sampling_cfg.max_step_halvings,
        runahead=runahead,
        tier2_every=tier2_every,
        adapt_full=True,
    )
    block_adapt = sample_block.adapt
    max_error = sampling_cfg.max_hamiltonian_error

    def warmup_block(ws: WarmupState, n: int, out=None):
        # one fresh evaluation per block (counted); within the block the
        # selected state's logp/grad ride the lane state
        logp0, grad0 = logp_grad(ws.theta)
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
