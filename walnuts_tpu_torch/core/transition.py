"""The classic per-draw WALNUTS transition, batched over chains.

Counterpart of ``walnuts_tpu/core/transition.py`` (read its module
docstring for the design: one attempt per loop pass, the merge stack
indexed by subtree level, the streaming reservoir in place of per-merge
Barker selection, Metropolis at the top level). The reference writes one
chain and vmaps; here the chain axis is written out, first on every field.

What changes in PyTorch:

* The reference's ``lax.while_loop(lambda s: ~s.done, body, state)`` under
  ``vmap`` runs the body on every lane while any lane is not done and keeps
  a finished lane's whole carry, key included. Here that is a Python loop,
  ``while not bool(done.all())``, one device-to-host read ("sync") per
  attempt, with every field of the new state selected against the old one
  on ``done``.
* An attempt's inner loop (``n`` leapfrog micro steps) is one call of an
  integrator ``(cur (C, 3, D), inv_mass (C, D), dt (C,), n_steps (C,)) ->
  (cur', lp)``: the fused kernel of ``ops.integrator.make_fused_integrator``
  when one is given, else the plain masked loop with ``logp_grad``
  (``ops.integrator.integrate_plain``), which runs to the largest
  ``n_steps`` of the batch as the vmapped inner while loop does.

Not ported: ``bf16_ends``, ``unroll`` and the flattened run-ahead sampler
(``make_flat_sample_block``); ROADMAP.md lists them. The batched scheduler
(``core/batched.py``) uses the constants and ``FailStats`` from here.

A span packs five ``(C, D)`` rows into ``(C, 5, D)`` and four scalars into
``(C, 4)``: rows theta_bk, rho_bk, theta_fw, rho_fw, theta_sel; scalars
logp_bk (joint), logp_fw (joint), logp_sel (position), logw.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from walnuts_tpu_torch.core.adapt import AdamState, adam_update, tree_where
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.integrator import integrate_plain
from walnuts_tpu_torch.ops.math import (
    LogpGradFn,
    count_trailing_zeros,
    log_sum_exp,
    logp_momentum,
)

_PH_FWD = 0
_PH_REV = 1

_THETA_BK, _RHO_BK = 0, 1
_THETA_FW, _RHO_FW = 2, 3
_THETA_SEL = 4
_SPAN_ROWS = 5
_LOGP_BK, _LOGP_FW, _LOGP_SEL, _LOGW = 0, 1, 2, 3


def span_from_point(theta, rho, logp_pos, logp_joint):
    """Single-state spans: ``(C, 5, D)`` rows and ``(C, 4)`` scalars."""
    v = torch.stack([theta, rho, theta, rho, theta], dim=1)
    s = torch.stack([logp_joint, logp_joint, logp_pos, logp_joint], dim=1)
    return v, s


def span_uturn(older_v, newer_v, forward, inv_mass) -> torch.Tensor:
    """U-turn test between adjacent spans (walnuts.hpp:192-201): ``older``
    was built first; ``forward`` (C,) is the direction of travel."""
    f = forward[:, None]
    bk_theta = torch.where(f, older_v[:, _THETA_BK], newer_v[:, _THETA_BK])
    bk_rho = torch.where(f, older_v[:, _RHO_BK], newer_v[:, _RHO_BK])
    fw_theta = torch.where(f, newer_v[:, _THETA_FW], older_v[:, _THETA_FW])
    fw_rho = torch.where(f, newer_v[:, _RHO_FW], older_v[:, _RHO_FW])
    delta = inv_mass * (fw_theta - bk_theta)
    return (torch.sum(fw_rho * delta, -1) < 0) | (torch.sum(bk_rho * delta, -1) < 0)


def span_combine(unif, older_v, older_s, newer_v, newer_s, forward,
                 barker: bool):
    """Merge two spans with progressive selection (walnuts.hpp:368-387):
    Barker inside subtrees, Metropolis at the top level."""
    logw_total = log_sum_exp(older_s[:, _LOGW], newer_s[:, _LOGW])
    log_denom = logw_total if barker else older_s[:, _LOGW]
    take_new = torch.log(unif) < (newer_s[:, _LOGW] - log_denom)
    f3 = forward[:, None, None]
    t3 = take_new[:, None, None]
    v = torch.cat([
        torch.where(f3, older_v[:, :2], newer_v[:, :2]),
        torch.where(f3, newer_v[:, 2:4], older_v[:, 2:4]),
        torch.where(t3, newer_v[:, 4:5], older_v[:, 4:5]),
    ], dim=1)
    s = torch.stack([
        torch.where(forward, older_s[:, _LOGP_BK], newer_s[:, _LOGP_BK]),
        torch.where(forward, newer_s[:, _LOGP_FW], older_s[:, _LOGP_FW]),
        torch.where(take_new, newer_s[:, _LOGP_SEL], older_s[:, _LOGP_SEL]),
        logw_total,
    ], dim=1)
    return v, s


class FailStats(NamedTuple):
    """Per-chain failure counters, int32 ``(C,)`` each: macro steps that
    spent every halving (``n_halve_fail``), attempts ending on a
    non-finite log density (``n_nonfinite``), transitions that hit the
    doubling budget (``n_depth_exhausted``)."""

    n_halve_fail: torch.Tensor
    n_nonfinite: torch.Tensor
    n_depth_exhausted: torch.Tensor

    @staticmethod
    def zeros(num_chains: int, device) -> "FailStats":
        z = lambda: torch.zeros((num_chains,), dtype=torch.int32, device=device)
        return FailStats(z(), z(), z())


class TripCounts(NamedTuple):
    """What the host counted while it drove the device (plain ints):
    model evaluations it asked for (masked leapfrog steps of the plain inner
    loop, or integrator calls), loop passes (attempts on the classic path,
    tier-2 passes on the batched one) and device-to-host reads of loop
    conditions."""

    n_inner_trips: int = 0
    n_outer_trips: int = 0
    n_syncs: int = 0

    def __add__(self, other):  # field-wise, not tuple concatenation
        return TripCounts(*(a + b for a, b in zip(self, other)))


class TransitionState(NamedTuple):
    """The attempt loop's carry; every field has the chain axis first."""

    key: torch.Tensor          # (C, 2) int32 key data
    done: torch.Tensor         # bool
    depth: torch.Tensor        # int32, current doubling (1-based)
    out_depth: torch.Tensor    # int32, reported depth at termination
    acc_v: torch.Tensor        # (C, 5, D) accumulated orbit vectors
    acc_s: torch.Tensor        # (C, 4) accumulated orbit scalars
    acc_grad_bk: torch.Tensor  # (C, D) gradient at the orbit's backward end
    acc_grad_sel: torch.Tensor  # (C, D) gradient at the selected state
    acc_grad_fw: torch.Tensor  # (C, D) gradient at the orbit's forward end
    forward: torch.Tensor      # bool, direction of the current subtree
    leaf_idx: torch.Tensor     # int32
    n_leaves: torch.Tensor     # int32 (= 2^(depth-1))
    stack_e: torch.Tensor      # (C, max_depth-1, 2, D): slot i holds the
                               # older-side (theta, rho) endpoint of the
                               # completed size-2^i sibling subtree
    run_sel: torch.Tensor      # (C, D) reservoir: selected state so far
    run_sel_logp: torch.Tensor
    run_sel_grad: torch.Tensor
    run_logw: torch.Tensor     # logsumexp of the subtree's leaf weights
    ms: torch.Tensor           # (C, 3, D) macro-step start [theta, rho, grad]
    ms_joint: torch.Tensor
    halvings: torch.Tensor     # int32
    dt: torch.Tensor           # signed current micro step size
    steps_done: torch.Tensor   # int32
    steps_total: torch.Tensor  # int32
    phase: torch.Tensor        # int32
    cur: torch.Tensor          # (C, 3, D) integration cursor
    fwd: torch.Tensor          # (C, 3, D) saved forward endpoint
    fwd_logp_pos: torch.Tensor
    fwd_joint: torch.Tensor
    adam: AdamState
    n_grads: torch.Tensor      # int32, gradient evaluations of this lane
    fails: FailStats


class TransitionResult(NamedTuple):
    theta: torch.Tensor
    grad: torch.Tensor
    logp: torch.Tensor         # position log density of the selected state
    depth: torch.Tensor        # int32; max_depth + 1 when no U-turn occurred
    n_grads: torch.Tensor      # int32
    adam: AdamState
    key: torch.Tensor
    fails: FailStats
    counts: TripCounts = TripCounts()


def _r(pred: torch.Tensor) -> torch.Tensor:
    """A per-lane ``(C,)`` predicate as a row mask ``(C, 1)``."""
    return pred[:, None]


def _b(pred: torch.Tensor) -> torch.Tensor:
    """A per-lane ``(C,)`` predicate as a block mask ``(C, 1, 1)``."""
    return pred[:, None, None]


def make_transition_parts(
    logp_grad: LogpGradFn,
    max_depth: int,
    max_step_halvings: int,
    adapt_step_size: bool,
    integrator=None,
):
    """``(init_state, body)``: ``init_state`` builds the fresh carry from a
    start point whose log density and gradient are known, ``body`` advances
    it by one attempt on every lane."""
    # imported here: ops.fused_pass imports this module's constants
    from walnuts_tpu_torch.ops.fused_pass import fresh_trajectory

    n_slots = max(max_depth - 1, 1)
    if integrator is None:
        def integrator(cur, inv_mass, dt, n_steps):
            return integrate_plain(logp_grad, cur, inv_mass, dt, n_steps)

    def init_state(key, theta, logp0, grad0, step, inv_mass, min_micro,
                   adam, n_grads, fails=None) -> TransitionState:
        C, D = theta.shape
        dev = theta.device
        # one 3-way split, D normals ~ N(0, M) and the direction bit
        key, rho, joint0, forward0, dt0 = fresh_trajectory(
            key, theta, logp0, step, inv_mass)
        acc_v, acc_s = span_from_point(theta, rho, logp0, joint0)
        start = torch.stack([theta, rho, grad0], dim=1)
        i32 = lambda v: torch.full((C,), v, dtype=torch.int32, device=dev)
        return TransitionState(
            key=key,
            done=torch.zeros((C,), dtype=torch.bool, device=dev),
            depth=i32(1), out_depth=i32(max_depth + 1),
            acc_v=acc_v, acc_s=acc_s,
            acc_grad_bk=grad0, acc_grad_sel=grad0, acc_grad_fw=grad0,
            forward=forward0, leaf_idx=i32(0), n_leaves=i32(1),
            stack_e=torch.zeros((C, n_slots, 2, D), dtype=theta.dtype,
                                device=dev),
            run_sel=theta, run_sel_logp=logp0, run_sel_grad=grad0,
            run_logw=torch.full_like(logp0, float("-inf")),
            ms=start, ms_joint=joint0,
            halvings=i32(0), dt=dt0, steps_done=i32(0),
            steps_total=min_micro, phase=i32(_PH_FWD),
            cur=start, fwd=start, fwd_logp_pos=logp0, fwd_joint=joint0,
            adam=adam, n_grads=n_grads,
            fails=FailStats.zeros(C, dev) if fails is None else fails,
        )

    def body(s: TransitionState, step, inv_mass, min_micro,
             max_error) -> TransitionState:
        dtype = s.ms_joint.dtype
        ks = prng.split(s.key)
        key, k_u = ks[:, 0], ks[:, 1]
        # one reservoir, one Metropolis, one direction draw
        unifs = prng.uniform(k_u, (3,), dtype)

        # ---- integrate the current attempt to completion: one integrator
        # call. A finished lane takes no step; its results are dropped by
        # the caller's select on ``done``.
        n_eff = s.steps_total - s.steps_done
        cur_n, lp_n = integrator(
            s.cur, inv_mass, s.dt,
            torch.where(s.done, torch.zeros_like(n_eff), n_eff))
        grads_used = n_eff
        steps_done = s.steps_total  # every attempt runs to its end
        rho_n = cur_n[:, 1]
        joint_n = lp_n + logp_momentum(rho_n, inv_mass)
        in_fwd = s.phase == _PH_FWD

        # ---- forward attempt completed (macro_step, walnuts.hpp:322-343)
        f_done = in_fwd
        f_err = torch.abs(s.ms_joint - joint_n)
        f_ok = f_err <= max_error  # NaN error -> False -> halve/fail

        if adapt_step_size:
            accept = torch.exp(-f_err)
            accept = torch.where(torch.isnan(accept), torch.zeros_like(accept),
                                 accept)
            observe = f_done & (s.halvings == 0)
            adam = tree_where(observe, adam_update(s.adam, accept), s.adam)
        else:
            adam = s.adam

        need_rev = s.steps_total >= 2 * min_micro
        start_rev = f_done & f_ok & need_rev
        leaf_ok = f_done & f_ok & ~need_rev
        more_halvings = (s.halvings + 1) < max_step_halvings
        restart = f_done & ~f_ok & more_halvings
        halve_exhausted = f_done & ~f_ok & ~more_halvings
        leaf_fail = halve_exhausted

        # ---- reversibility level completed (reversible, walnuts.hpp:267-277)
        r_done = ~in_fwd
        r_err = torch.abs(joint_n - s.fwd_joint)
        r_within = r_err <= max_error  # coarser level passes -> irreversible
        leaf_fail = leaf_fail | (r_done & r_within)
        more_rev = s.steps_total >= 2 * min_micro
        next_rev = r_done & ~r_within & more_rev
        leaf_ok = leaf_ok | (r_done & ~r_within & ~more_rev)

        # saved forward endpoint: refreshed when a forward attempt passes
        set_fwd = f_done & f_ok
        fwd = torch.where(_b(set_fwd), cur_n, s.fwd)
        fwd_logp_pos = torch.where(set_fwd, lp_n, s.fwd_logp_pos)
        fwd_joint = torch.where(set_fwd, joint_n, s.fwd_joint)

        # ---- leaf accepted: U-turn cascade + reservoir selection. Slot i
        # holds the older-side endpoint of the completed size-2^i subtree;
        # leaf j checks slots 0..ctz(j+1)-1 and the push lands at slot
        # ctz(j+1) (build_span, walnuts.hpp:490-494).
        leaf_th, leaf_rho = fwd[:, 0], fwd[:, 1]
        sgn = torch.where(s.forward, 1.0, -1.0).to(dtype)

        def uturn_end(old_th, old_rho):
            # span_uturn with the newer-side endpoint == this leaf: delta
            # points from the older to the newer side
            delta = _r(sgn) * inv_mass * (leaf_th - old_th)
            return ((torch.sum(leaf_rho * delta, -1) < 0)
                    | (torch.sum(old_rho * delta, -1) < 0))

        n_merges = count_trailing_zeros(s.leaf_idx + 1)
        cur_end = fwd[:, :2]  # older-side endpoint of the span being built
        ok = torch.ones_like(leaf_ok)
        for i in range(n_slots):
            do = leaf_ok & (i < n_merges) & ok
            slot = s.stack_e[:, i]
            ut = uturn_end(slot[:, 0], slot[:, 1])
            cur_end = torch.where(_b(do), slot, cur_end)
            ok = ok & ~(do & ut)
        sub_uturn = leaf_ok & ~ok
        leaf_ok = leaf_ok & ok

        new_leaf_idx = s.leaf_idx + 1
        subtree_done = leaf_ok & (new_leaf_idx >= s.n_leaves)
        push = leaf_ok & ~subtree_done
        slots = torch.arange(n_slots, device=n_merges.device, dtype=torch.int32)
        write_mask = _r(push) & (_r(n_merges) == slots[None, :])
        stack_e = torch.where(write_mask[:, :, None, None], cur_end[:, None],
                              s.stack_e)

        # ---- reservoir: weight-proportional selection over the current
        # subtree's leaves; a -inf-weight leaf is never selected
        run_logw_new = log_sum_exp(s.run_logw, fwd_joint)
        take_leaf = torch.log(unifs[:, 0]) < fwd_joint - run_logw_new
        upd = leaf_ok & take_leaf
        run_sel = torch.where(_r(upd), fwd[:, 0], s.run_sel)
        run_sel_logp = torch.where(upd, fwd_logp_pos, s.run_sel_logp)
        run_sel_grad = torch.where(_r(upd), fwd[:, 2], s.run_sel_grad)
        run_logw = torch.where(leaf_ok, run_logw_new, s.run_logw)

        # ---- subtree completed: top-level Metropolis + combined U-turn
        # (transition_w, walnuts.hpp:536-558); the new subtree is always
        # combined, even when the combined span U-turns
        fw3 = _b(s.forward)
        acc_old = torch.where(fw3, s.acc_v[:, _THETA_BK:_RHO_BK + 1],
                              s.acc_v[:, _THETA_FW:_RHO_FW + 1])
        ut_top = uturn_end(acc_old[:, 0], acc_old[:, 1])
        take_new = torch.log(unifs[:, 1]) < run_logw_new - s.acc_s[:, _LOGW]
        upd_fw = subtree_done & s.forward
        upd_bk = subtree_done & ~s.forward
        take = subtree_done & take_new
        acc_v = torch.stack([
            torch.where(_r(upd_bk), fwd[:, 0], s.acc_v[:, _THETA_BK]),
            torch.where(_r(upd_bk), fwd[:, 1], s.acc_v[:, _RHO_BK]),
            torch.where(_r(upd_fw), fwd[:, 0], s.acc_v[:, _THETA_FW]),
            torch.where(_r(upd_fw), fwd[:, 1], s.acc_v[:, _RHO_FW]),
            torch.where(_r(take), run_sel, s.acc_v[:, _THETA_SEL]),
        ], dim=1)
        acc_s = torch.stack([
            torch.where(upd_bk, fwd_joint, s.acc_s[:, _LOGP_BK]),
            torch.where(upd_fw, fwd_joint, s.acc_s[:, _LOGP_FW]),
            torch.where(take, run_sel_logp, s.acc_s[:, _LOGP_SEL]),
            torch.where(subtree_done,
                        log_sum_exp(s.acc_s[:, _LOGW], run_logw_new),
                        s.acc_s[:, _LOGW]),
        ], dim=1)
        # the orbit endpoint in the travel direction becomes the last
        # leaf's endpoint, whose gradient the cursor still holds
        acc_grad_fw = torch.where(_r(upd_fw), fwd[:, 2], s.acc_grad_fw)
        acc_grad_bk = torch.where(_r(upd_bk), fwd[:, 2], s.acc_grad_bk)
        acc_grad_sel = torch.where(_r(take), run_sel_grad, s.acc_grad_sel)
        end_uturn = subtree_done & ut_top
        new_depth = s.depth + 1
        deeper = subtree_done & ~ut_top & (new_depth <= max_depth)
        exhausted = subtree_done & ~ut_top & (new_depth > max_depth)

        # ---- termination bookkeeping ----
        fail = leaf_fail | sub_uturn
        done = s.done | fail | end_uturn | exhausted
        fails = FailStats(
            n_halve_fail=s.fails.n_halve_fail + halve_exhausted.to(torch.int32),
            n_nonfinite=s.fails.n_nonfinite
            + (~torch.isfinite(lp_n)).to(torch.int32),
            n_depth_exhausted=s.fails.n_depth_exhausted
            + exhausted.to(torch.int32),
        )
        out_depth = torch.where(
            fail | end_uturn, s.depth,
            torch.where(exhausted, torch.full_like(s.depth, max_depth + 1),
                        s.out_depth))

        # ---- set up the next attempt ----
        new_dir = torch.where(deeper, unifs[:, 2] < 0.5, s.forward)
        # a new doubling starts an empty subtree: reset the reservoir
        run_logw = torch.where(deeper, torch.full_like(run_logw, float("-inf")),
                               run_logw)
        depth = torch.where(deeper, new_depth, s.depth)
        n_leaves = torch.where(deeper, torch.ones_like(new_depth) << (new_depth - 1),
                               s.n_leaves)
        leaf_idx = torch.where(deeper, torch.zeros_like(new_leaf_idx), new_leaf_idx)
        leaf_idx = torch.where(leaf_ok | deeper, leaf_idx, s.leaf_idx)

        # macro-step start for the next leaf: the last leaf's endpoint
        # within a subtree, or the orbit endpoint in the travel direction
        # when a new doubling begins
        nd1 = _r(new_dir)
        acc_end = torch.stack([
            torch.where(nd1, acc_v[:, _THETA_FW], acc_v[:, _THETA_BK]),
            torch.where(nd1, acc_v[:, _RHO_FW], acc_v[:, _RHO_BK]),
            torch.where(nd1, acc_grad_fw, acc_grad_bk),
        ], dim=1)
        acc_end_joint = torch.where(new_dir, acc_s[:, _LOGP_FW], acc_s[:, _LOGP_BK])

        next_leaf = push  # continue the current subtree from the new frontier
        ms = torch.where(_b(deeper), acc_end, torch.where(_b(next_leaf), fwd, s.ms))
        ms_joint = torch.where(
            deeper, acc_end_joint, torch.where(next_leaf, fwd_joint, s.ms_joint))

        start_macro = deeper | next_leaf
        dt_base = torch.where(new_dir, step, -step)
        to_rev = start_rev | next_rev
        zero_i = torch.zeros_like(s.halvings)
        halvings = torch.where(start_macro, zero_i,
                               torch.where(restart, s.halvings + 1, s.halvings))
        phase = torch.where(start_macro | restart, torch.full_like(s.phase, _PH_FWD),
                            torch.where(to_rev, torch.full_like(s.phase, _PH_REV),
                                        s.phase))
        steps_total = torch.where(
            start_macro, min_micro,
            torch.where(restart, s.steps_total * 2,
                        torch.where(to_rev, s.steps_total // 2, s.steps_total)))
        dt = torch.where(
            start_macro, dt_base,
            torch.where(restart, s.dt * 0.5,
                        torch.where(to_rev, s.dt * 2.0, s.dt)))
        reset_cursor = start_macro | restart | to_rev
        steps_done = torch.where(reset_cursor, zero_i, steps_done)

        # cursor source: macro start for forward (re)starts, negated-
        # momentum forward endpoint for reversibility levels, otherwise the
        # fresh leapfrog output
        rev_cur = torch.stack([fwd[:, 0], -fwd[:, 1], fwd[:, 2]], dim=1)
        cur = torch.where(_b(to_rev), rev_cur,
                          torch.where(_b(start_macro | restart), ms, cur_n))

        return TransitionState(
            key=key, done=done, depth=depth, out_depth=out_depth,
            acc_v=acc_v, acc_s=acc_s,
            acc_grad_bk=acc_grad_bk, acc_grad_fw=acc_grad_fw,
            acc_grad_sel=acc_grad_sel,
            forward=new_dir, leaf_idx=leaf_idx, n_leaves=n_leaves,
            stack_e=stack_e, run_sel=run_sel,
            run_sel_logp=run_sel_logp, run_sel_grad=run_sel_grad,
            run_logw=run_logw,
            ms=ms, ms_joint=ms_joint,
            halvings=halvings, dt=dt, steps_done=steps_done,
            steps_total=steps_total, phase=phase,
            cur=cur, fwd=fwd,
            fwd_logp_pos=fwd_logp_pos, fwd_joint=fwd_joint,
            adam=adam, n_grads=s.n_grads + grads_used,
            fails=fails,
        )

    return init_state, body


def make_transition(
    logp_grad: LogpGradFn,
    max_depth: int,
    max_step_halvings: int,
    adapt_step_size: bool,
    integrator=None,
) -> Callable[..., TransitionResult]:
    """Build the chain-batched WALNUTS transition (walnuts.hpp:520-563).

    Returns ``transition(key (C, 2), theta (C, D), step (C,), inv_mass
    (C, D), min_micro (C,) int32, max_error, adam) -> TransitionResult``.
    With ``adapt_step_size`` the carried Adam state observes ``exp(-|dH|)``
    of the coarsest attempt of every macro step (walnuts.hpp:335-338), as
    warmup requires.

    ``integrator`` optionally replaces the plain inner leapfrog loop with
    a fused kernel of signature ``(cur (C, 3, D), inv_mass (C, D), dt (C,),
    n_steps (C,) int32) -> (cur', lp)`` (``ops.integrator``); lanes with
    ``n_steps == 0`` must pass through unchanged.

    The result's ``counts`` hold what the host counted: attempts
    (``n_outer_trips``), the model evaluations it asked for
    (``n_inner_trips``: masked leapfrog steps, or integrator calls) and
    device-to-host reads (``n_syncs``: the loop condition before every
    attempt and after the last, and one more per attempt for the plain
    inner loop's trip count).
    """
    plain = integrator is None
    asked = [0]  # model evaluations the host asked for in this transition

    if plain:
        def counted(cur, inv_mass, dt, n_steps):
            n = int(n_steps.max())  # the inner loop's trip count: one read
            asked[0] += n
            return integrate_plain(logp_grad, cur, inv_mass, dt, n_steps,
                                   max_steps=n)
    else:
        def counted(cur, inv_mass, dt, n_steps):
            asked[0] += 1
            return integrator(cur, inv_mass, dt, n_steps)

    init_state, body = make_transition_parts(
        logp_grad, max_depth, max_step_halvings, adapt_step_size, counted)

    def transition(key, theta, step, inv_mass, min_micro, max_error,
                   adam: AdamState) -> TransitionResult:
        dtype, dev = theta.dtype, theta.device
        min_micro = min_micro.to(torch.int32)
        step = step.to(dtype)
        max_error = torch.as_tensor(max_error, dtype=dtype, device=dev)
        logp0, grad0 = logp_grad(theta)
        s = init_state(key, theta, logp0, grad0, step, inv_mass, min_micro,
                       adam, torch.ones_like(min_micro))
        asked[0] = attempts = 0
        while not bool(s.done.all()):
            s = tree_where(s.done, s, body(s, step, inv_mass, min_micro, max_error))
            attempts += 1
        # the selected state's gradient (the mass estimator's score) was
        # cached from the cursor when its leaf was accepted
        return TransitionResult(
            theta=s.acc_v[:, _THETA_SEL],
            grad=s.acc_grad_sel,
            logp=s.acc_s[:, _LOGP_SEL],
            depth=s.out_depth,
            n_grads=s.n_grads,
            adam=s.adam,
            key=s.key,
            fails=s.fails,
            counts=TripCounts(asked[0], attempts,
                              attempts * (2 if plain else 1) + 1),
        )

    return transition


__all__ = [
    "FailStats",
    "TransitionResult",
    "TransitionState",
    "TripCounts",
    "make_transition",
    "make_transition_parts",
    "span_combine",
    "span_from_point",
    "span_uturn",
]
