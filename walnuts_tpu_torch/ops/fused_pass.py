"""The batched scheduler's tier-2 pass, and the fused pass (kernel 4).

Counterpart of ``walnuts_tpu/ops/fused_pass.py``. The tier-2 pass resolves
one pending leaf per latched lane: the merge cascade of sub-U-turn checks,
the deferred key-split replay, the stack push, the reservoir and top-level
Metropolis choices, the trajectory restart (a 3-way key split, momenta
~ N(0, M) and the direction bit) and, in the sampling block, banking of
every completed draw.

:func:`leaf_apply` is the pass's arithmetic, written once. Both routes of
the port run it:

- the unfused route (``core/batched.py``, ``pallas_pass=False``) calls it
  with ``prng.replay_split_chain`` (the replay kernel on the card) and
  banks with :func:`bank_draws`; on the card through :class:`GraphedPass`,
  which replays one CUDA graph of it a shape;
- :func:`fused_pass_plain` calls it with the plain replay, banks, and
  writes the new lane fields back into the state's tensors in place.

:func:`fused_pass` is the fused route's entry point: CPU tensors take
:func:`fused_pass_plain`; CUDA tensors launch the kernel of
``csrc/fused_pass.cu``, one launch per pass, which updates the same
tensors in place. Both banks straight into the block's output at the
lane's draw index, as the unfused route does: the port has no B-deep ring.
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator
import threading

import numpy as np
import torch

from walnuts_tpu_torch.core.adapt import (
    adam_step_size,
    mass_estimator_inv_mass,
    mass_estimator_observe,
    min_micro_estimate,
    min_micro_observe,
    tree_where,
)
from walnuts_tpu_torch.core.transition import _PH_FWD, round_bf16
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.math import (
    count_trailing_zeros,
    log_sum_exp,
    logp_momentum,
)


def _r(pred: torch.Tensor) -> torch.Tensor:
    """A per-lane ``(C,)`` predicate as a row mask ``(C, 1)``."""
    return pred[:, None]


def fresh_trajectory(key, theta, logp0, step, inv_mass):
    """One 3-way key split, momentum ~ N(0, M) and the direction bit per
    lane (``transition_w`` entry, walnuts.hpp:528-535)."""
    dtype = theta.dtype
    ks = prng.split(key, 3)
    # subkeys 1 (momentum) and 2 (direction) hashed in one threefry: the
    # direction bit is the uniform of subkey 2's counter 0
    x0, x1 = prng.counter_bits(ks[:, 1:], theta.shape[1:])
    z = prng.normal_from_bits(x0[:, 0], x1[:, 0], dtype)
    rho0 = z / torch.sqrt(inv_mass)
    joint0 = logp0 + logp_momentum(rho0, inv_mass)
    forward0 = prng.uniform_from_bits(x0[:, 1, 0], x1[:, 1, 0], dtype) < 0.5
    dt0 = torch.where(forward0, step, -step)
    return ks[:, 0].contiguous(), rho0, joint0, forward0, dt0


def leaf_apply(s, active, step, inv_mass, min_micro, block_draws: int, *,
               max_depth: int, replay, aux=None, bf16_ends: bool = False):
    """One tier-2 pass over the lane state ``s`` (a ``LaneState``).

    ``replay`` is the deferred key-split replay
    (``prng.replay_split_chain`` or its plain version), or None when the
    trips split the keys themselves (``defer_splits=False``: ``s.ku`` is
    then the leaf's subkey). ``aux`` is warmup's ``(mass, mm_est,
    iteration)``, or None when sampling. Returns ``(s', complete,
    sel_theta, sel_logp, out_depth, bank_idx, aux')``: the new state and
    what :func:`bank_draws` banks. ``bf16_ends``: the stack is bfloat16
    and every U-turn operand is rounded through bfloat16.
    """
    n_slots = max(max_depth - 1, 1)
    jdtype = s.ms_joint.dtype
    dtype = s.run_sel.dtype
    dev = s.run_sel.device
    pend = active & s.leaf_done
    fwd_th, fwd_rho, fwd_grad = s.fwd_th, s.fwd_rho, s.fwd_grad
    fwd_joint, fwd_logp_pos = s.fwd_joint, s.fwd_logp_pos
    leaf_ok = pend & s.leaf_ok
    leaf_fail = pend & ~s.leaf_ok

    leaf_th, leaf_rho = fwd_th, fwd_rho
    if bf16_ends:
        leaf_th, leaf_rho = round_bf16(leaf_th), round_bf16(leaf_rho)
    sgn = torch.where(s.forward, 1.0, -1.0).to(dtype)

    def uturn_end(old_th, old_rho):
        if bf16_ends:
            old_th, old_rho = round_bf16(old_th), round_bf16(old_rho)
        delta = _r(sgn) * inv_mass * (leaf_th - old_th)
        return ((torch.sum(leaf_rho * delta, -1) < 0)
                | (torch.sum(old_rho * delta, -1) < 0))

    # merge cascade: sub-U-turn checks against the stacked older-side
    # endpoints (build_span, walnuts.hpp:490-494); a leaf's merge count
    # is the trailing-zero count of its 1-based index
    n_merges = count_trailing_zeros(s.leaf_idx + 1)
    cur_end = torch.stack([fwd_th, fwd_rho], dim=1)
    ok = torch.ones_like(leaf_ok)
    for i in range(n_slots):
        do = leaf_ok & (i < n_merges) & ok
        slot = s.stack_e[:, i].to(dtype)
        ut = uturn_end(slot[:, 0], slot[:, 1])
        cur_end = torch.where(do[:, None, None], slot, cur_end)
        ok = ok & ~(do & ut)
    sub_uturn = leaf_ok & ~ok
    leaf_ok = leaf_ok & ok

    if replay is not None:
        # deferred key-split replay: the plain version or the CUDA kernel
        key_r, ku = replay(s.key, s.ku, s.n_ends, s.leaf_end_at)
        s = s._replace(key=key_r, ku=ku,
                       n_ends=torch.zeros_like(s.n_ends),
                       leaf_end_at=torch.zeros_like(s.leaf_end_at))
    # the three leaf uniforms, from the resolving leaf's subkey
    unifs = prng.uniform(s.ku, (3,), dtype)

    new_leaf_idx = s.leaf_idx + 1
    subtree_done = leaf_ok & (new_leaf_idx >= s.n_leaves)
    push = leaf_ok & ~subtree_done
    # stack push: lane i writes slot n_merges[i]
    slots = torch.arange(n_slots, device=dev, dtype=torch.int32)
    write_mask = push[:, None] & (n_merges[:, None] == slots[None, :])
    stack_e = torch.where(write_mask[:, :, None, None],
                          cur_end.to(s.stack_e.dtype)[:, None], s.stack_e)

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

    if aux is not None:
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

    knew, rho0, joint0, forward0, dt0 = fresh_trajectory(
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


def bank_draws(out, complete, sel_theta, sel_logp, out_depth, bank_idx):
    """Write each completed lane's draw, log density and depth into the
    block's output ``out = (draws (R, C, D), logps (R, C), depths (R,
    C))`` at its draw index, in place; other lanes write their row back
    unchanged."""
    draws, logps, depths = out
    lanes = torch.arange(draws.shape[1], device=draws.device)
    idx = bank_idx.clamp(0, draws.shape[0] - 1).long()
    draws[idx, lanes] = torch.where(_r(complete), sel_theta, draws[idx, lanes])
    logps[idx, lanes] = torch.where(complete, sel_logp, logps[idx, lanes])
    depths[idx, lanes] = torch.where(complete, out_depth, depths[idx, lanes])


# ---------------------------------------------------------------------------
# the unfused pass over fixed buffers (a CUDA graph on the card)
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    """The tensors of a tree of tuples and NamedTuples (None holds none),
    depth first."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [t for part in tree for t in _leaves(part)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in order, by those of the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        parts = [_rebuild(part, leaves) for part in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return next(leaves)


class GraphedPass:
    """The unfused tier-2 pass for one shape of its arguments, over fixed
    input and output buffers.

    :meth:`run` takes :func:`leaf_apply`'s arguments ``(s, active, step,
    inv_mass, min_micro, aux)``, copies them into the input buffers (one
    ``torch._foreach_copy_`` a dtype) and returns :func:`leaf_apply`'s
    results for them, bit for bit. On CUDA tensors the first run computes
    one eager pass on the buffers (every library loaded, nothing built
    during capture) and captures the pass as a CUDA graph, and every run
    replays that graph: a pass costs the host a few launches instead of one
    an operation, and the replay (kernel 1) stays a node of the graph, which
    ``replay.launches`` counts at each replay. On CPU tensors every run
    computes the pass eagerly and copies it into the output buffers.

    Each result is a buffer that the next run overwrites: an output buffer,
    or an input buffer where the pass hands an argument through unchanged.
    :meth:`detach` copies the buffers in whatever a caller keeps beyond the
    next run.
    """

    def __init__(self, args, block_draws: int, *, max_depth: int, replay,
                 bf16_ends: bool = False):
        self.inputs = [t.clone() for t in _leaves(args)]
        self._args = _rebuild(args, iter(self.inputs))
        self._kw = dict(max_depth=max_depth, replay=replay, bf16_ends=bf16_ends)
        self._block_draws = block_draws
        by_dtype = {}
        for i, t in enumerate(self.inputs):
            by_dtype.setdefault(t.dtype, []).append(i)
        self._copies = [(idx, [self.inputs[i] for i in idx])
                        for idx in by_dtype.values()]
        self.graph = None
        self.captures = 0
        self.outputs = None    # the results' tensors, depth first
        self._results = None   # leaf_apply's results of the input buffers
        self._launches = 0     # kernel-1 launches in the graph

    @staticmethod
    def key(args, block_draws: int) -> tuple:
        """What changes a pass's launches, given the factory's options: the
        block's draw count R and each argument's dtype, shape and device
        (the phase, C and D among them). ``cap`` enters through
        ``active``'s values only."""
        return block_draws, tuple((t.dtype, t.shape, t.device) for t in _leaves(args))

    def _apply(self):
        s, active, step, inv_mass, min_micro, aux = self._args
        return leaf_apply(s, active, step, inv_mass, min_micro,
                          self._block_draws, aux=aux, **self._kw)

    def _capture(self) -> None:
        self._apply()
        replay = self._kw["replay"]
        before = 0 if replay is None else replay.launches
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            results = self._apply()
        if replay is not None:  # a capture launches nothing; a replay does
            self._launches = replay.launches - before
            replay.launches = before
        self.captures += 1
        self._results, self.outputs = results, _leaves(results)

    def run(self, args):
        leaves = _leaves(args)
        for idx, bufs in self._copies:
            torch._foreach_copy_(bufs, [leaves[i] for i in idx])
        if self.inputs[0].is_cuda:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            if self._launches:
                self._kw["replay"].launches += self._launches
        elif self.outputs is None:
            self._results = self._apply()
            self.outputs = _leaves(self._results)
        else:
            for buf, t in zip(self.outputs, _leaves(self._apply())):
                if t is not buf:
                    buf.copy_(t)
        return self._results

    def detach(self, tree):
        """``tree`` with a copy in place of each buffer in it."""
        bufs = {id(t) for t in self.inputs + (self.outputs or [])}
        return _rebuild(tree, iter([t.clone() if id(t) in bufs else t
                                    for t in _leaves(tree)]))


# ---------------------------------------------------------------------------
# the fused pass (kernel 4)
# ---------------------------------------------------------------------------

# The lane fields the pass reads and writes, by kind.
F_RW = ("run_sel_logp", "run_logw", "ms_joint", "dt", "lp_cur",
        "acc_jt_bk", "acc_jt_fw", "acc_lp_sel", "acc_logw")
I_RW = ("depth", "out_depth", "leaf_idx", "n_leaves", "halvings",
        "steps_done", "steps_total", "phase", "n_ends", "leaf_end_at",
        "n_depth_exhausted", "draws_done")
B_RW = ("forward", "leaf_done", "leaf_ok")
K_RW = ("key", "ku")
ROW_RW = ("acc_th_bk", "acc_rho_bk", "acc_th_fw", "acc_rho_fw", "acc_th_sel",
          "acc_grad_bk", "acc_grad_sel", "acc_grad_fw", "run_sel",
          "run_sel_grad", "ms_th", "ms_rho", "ms_grad", "cur_th", "cur_rho",
          "cur_grad")
STACK_RW = ("stack_e",)
ROW_RO = ("fwd_th", "fwd_rho", "fwd_grad", "inv_mass")
F_RO = ("fwd_logp_pos", "fwd_joint", "step")
I_RO = ("min_micro",)
BANK = ("draws", "logps", "depths")
RW_FIELDS = F_RW + I_RW + B_RW + K_RW + ROW_RW + STACK_RW
# The kernel's operands in the order of FusedPassArgs' pointers in
# csrc/fused_pass.cu (enum Ptr): the 28 per-lane scalars first, lane i of
# a warp loading scalar i, then the key data, the rows, the stack and the
# block's output.
_POINTERS = (F_RW + F_RO + I_RW + I_RO + B_RW + K_RW + ROW_RW + STACK_RW
             + ROW_RO + BANK)
_RW = frozenset(RW_FIELDS + BANK)
_INTS = ("chains", "dim", "n_slots", "max_depth", "block_draws", "cap",
         "chains_per_block", "is_double")
#: columns of the kernel's optional trace: the card's clock (ns) at entry
#: and exit, the SM, and the SM's cycle count at each of TRACE_MARKS (the
#: chain's warp: entry, its scalars in, its cascade summed, its rows
#: written; its control lane: the replay and hashes done, the decisions,
#: the tail stored)
TRACE_COLS = 11
TRACE_MARKS = ("entry", "scalars", "cascade", "replay", "decisions", "rows",
               "tail")

#: chains per CUDA block (one warp each) when ``pass_tile`` is None
DEFAULT_PASS_TILE = 8


class FusedPassArgs(ctypes.Structure):
    """The kernel's operands: every pointer, the trace, then the sizes."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [("trace", ctypes.c_void_p)]
                + [(n, ctypes.c_int) for n in _INTS])


def lane_field(s, name):
    """Field ``name`` of the lane state ``s`` (``n_depth_exhausted`` lives
    in ``s.fails``)."""
    return s.fails.n_depth_exhausted if name == "n_depth_exhausted" else getattr(s, name)


def own_storage(s):
    """``s`` with every field the fused pass writes in its own storage.

    A fresh lane state shares one tensor among many fields (the start
    point is every endpoint, selection and cursor at once) and may hold a
    view of the caller's tensors (the previous block's last draw, the
    frozen ``min_micro``). The fused pass writes its fields in place, so
    each gets a private copy once per block."""
    fails = s.fails._replace(n_depth_exhausted=s.fails.n_depth_exhausted.clone())
    return s._replace(fails=fails, **{
        n: getattr(s, n).clone() for n in RW_FIELDS if n != "n_depth_exhausted"})


def _operands(s, step, inv_mass, min_micro, out) -> tuple:
    """The kernel's operands, in ``_POINTERS`` order."""
    extra = {"step": step, "inv_mass": inv_mass, "min_micro": min_micro,
             "draws": out[0], "logps": out[1], "depths": out[2],
             "n_depth_exhausted": s.fails.n_depth_exhausted}
    return tuple(extra[n] if n in extra else getattr(s, n) for n in _POINTERS)


@functools.lru_cache(maxsize=32)
def _wanted(C: int, D: int, n_slots: int, R: int, fdt) -> tuple:
    """Each operand's dtype, shape and byte count, three tuples in
    ``_POINTERS`` order."""
    kind = {}
    kind.update({n: (fdt, (C,)) for n in F_RW + F_RO})
    kind.update({n: (torch.int32, (C,)) for n in I_RW + I_RO})
    kind.update({n: (torch.bool, (C,)) for n in B_RW})
    kind.update({n: (torch.int32, (C, 2)) for n in K_RW})
    kind.update({n: (fdt, (C, D)) for n in ROW_RW + ROW_RO})
    kind.update(stack_e=(fdt, (C, n_slots, 2, D)), draws=(fdt, (R, C, D)),
                logps=(fdt, (R, C)), depths=(torch.int32, (R, C)))
    dts, shapes = zip(*(kind[n] for n in _POINTERS))
    nbytes = tuple(math.prod(sh) * dt.itemsize for dt, sh in zip(dts, shapes))
    return dts, shapes, nbytes


_DTYPE, _SHAPE = operator.attrgetter("dtype"), operator.attrgetter("shape")
_IS_RW = tuple(n in _RW for n in _POINTERS)


def _check(ops, max_depth: int, block_draws: int):
    """Every operand's dtype, shape, device and contiguity, and no
    read-write operand overlapping another operand's memory. ``ops`` in
    ``_POINTERS`` order; each property is read once per operand, in one
    pass. Returns ``(C, D, n_slots, ptrs)``, ``ptrs`` each operand's
    address."""
    ref = ops[_POINTERS.index("run_sel")]
    C, D = ref.shape
    dev = ref.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_pass: unsupported device {dev}")
    fdt = ref.dtype
    if fdt not in (torch.float32, torch.float64):
        raise ValueError(f"fused_pass: rows must be float32 or float64, not {fdt}")
    n_slots = max(max_depth - 1, 1)
    dts, shapes, nbytes = _wanted(C, D, n_slots, int(block_draws), fdt)
    if (tuple(map(_DTYPE, ops)) != dts or tuple(map(_SHAPE, ops)) != shapes
            or tuple(map(torch.Tensor.get_device, ops))
            != (ref.get_device(),) * len(ops)
            or not all(map(torch.Tensor.is_contiguous, ops))):
        for n, t, dt, shape in zip(_POINTERS, ops, dts, shapes):
            if (t.dtype != dt or tuple(t.shape) != shape or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(
                    f"fused_pass: {n} must be a contiguous {dt} {shape} tensor "
                    f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}"
                    f"{'' if t.is_contiguous() else ', not contiguous'}")
    ptrs = list(map(torch.Tensor.data_ptr, ops))
    # sorted by address, a span that starts below the highest end so far
    # overlaps an earlier span: read-write on either side is refused
    top, top_rw = 0, False
    for lo, hi, rw in sorted(zip(ptrs, map(int.__add__, ptrs, nbytes), _IS_RW)):
        if hi == lo:
            continue
        if lo < top and (rw or top_rw):
            _refuse_overlap(ptrs, nbytes)
        if hi > top:
            top, top_rw = hi, rw
    return C, D, n_slots, ptrs


def _refuse_overlap(ptrs, nbytes):
    """Raise naming two operands that share memory, one of them read-write."""
    spans = sorted((p, p + b, n) for p, b, n in zip(ptrs, nbytes, _POINTERS) if b)
    for i, (lo, hi, n) in enumerate(spans):
        for lo2, hi2, n2 in spans[i + 1:]:
            if lo2 >= hi:
                break
            if n in _RW or n2 in _RW:
                raise ValueError(
                    f"fused_pass: {n} and {n2} share memory; the pass writes "
                    f"in place, so each read-write operand needs its own "
                    f"storage (see own_storage)")


def fused_pass_plain(s, step, inv_mass, min_micro, cap: int, block_draws: int,
                     max_depth: int, out) -> None:
    """Plain version of the fused pass: :func:`leaf_apply` with the plain
    replay on the lanes with ``draws_done < cap``, banking into ``out``,
    and the new lane fields written back into ``s``'s tensors in place."""
    active = s.draws_done < cap
    new, complete, sel_theta, sel_logp, out_depth, bank_idx, _ = leaf_apply(
        s, active, step, inv_mass, min_micro, block_draws,
        max_depth=max_depth, replay=prng.replay_split_chain_plain)
    bank_draws(out, complete, sel_theta, sel_logp, out_depth, bank_idx)
    for n in RW_FIELDS:
        lane_field(s, n).copy_(lane_field(new, n))


_LAUNCH = threading.local()


def _launch_args():
    """This thread's ``FusedPassArgs``, made once, and a view of its
    pointers as one array (filled by one slice assignment a launch)."""
    args = getattr(_LAUNCH, "args", None)
    if args is None:
        args = _LAUNCH.args = FusedPassArgs()
        _LAUNCH.ptrs = (ctypes.c_void_p * len(_POINTERS)).from_buffer(args)
    return args, _LAUNCH.ptrs


def fused_pass(s, step, inv_mass, min_micro, cap: int, block_draws: int,
               max_depth: int, out, pass_tile=None, trace=None) -> None:
    """One tier-2 pass of the sampling block, banking included, in place.

    ``s`` is the block's ``LaneState`` (its pass fields in their own
    storage, :func:`own_storage`); ``step`` (C,), ``inv_mass`` (C, D) and
    ``min_micro`` (C,) int32 are the frozen parameters; lanes with
    ``draws_done < cap`` are active; ``block_draws`` is the block's draw
    count R; ``out = (draws (R, C, D), logps (R, C), depths (R, C) int32)``
    receives the completed draws. CPU tensors take :func:`fused_pass_plain`;
    CUDA tensors launch ``csrc/fused_pass.cu`` (``pass_tile`` chains per
    CUDA block, one warp each; fewer where a chain's staged rows would not
    fit a block's shared memory). The operands are checked on either
    device. ``trace``, None or a contiguous ``(C, TRACE_COLS)`` int64 tensor
    on the card, receives each chain's phase times (:data:`TRACE_MARKS`).
    """
    ops = _operands(s, step, inv_mass, min_micro, out)
    C, D, n_slots, ptrs = _check(ops, max_depth, block_draws)
    tile = DEFAULT_PASS_TILE if pass_tile is None else int(pass_tile)
    if not 1 <= tile <= 32:
        raise ValueError(f"fused_pass: pass_tile must be in [1, 32]; got {tile}")
    dev = ops[0].device
    if dev.type == "cpu":
        fused_pass_plain(s, step, inv_mass, min_micro, cap, block_draws,
                         max_depth, out)
        return
    from walnuts_tpu_torch.ops import _cuda

    lib = _cuda.library("fused_pass")
    if not getattr(lib, "args_size_checked", False):
        if lib.wt_fused_pass_args_size() != ctypes.sizeof(FusedPassArgs):
            raise RuntimeError("fused_pass: FusedPassArgs differs from the kernel's")
        lib.args_size_checked = True
    if C == 0:
        return
    if trace is not None and (trace.dtype != torch.int64 or trace.device != dev
                              or tuple(trace.shape) != (C, TRACE_COLS)
                              or not trace.is_contiguous()):
        raise ValueError(f"fused_pass: trace must be a contiguous int64 "
                         f"({C}, {TRACE_COLS}) tensor on {dev}")
    args, arr = _launch_args()
    arr[:] = ptrs
    args.trace = None if trace is None else trace.data_ptr()
    args.chains, args.dim, args.n_slots, args.max_depth = C, D, n_slots, int(max_depth)
    args.block_draws, args.cap, args.chains_per_block = int(block_draws), int(cap), tile
    args.is_double = int(ops[0].dtype == torch.float64)
    if dev.index == torch.cuda.current_device():
        err = lib.wt_fused_pass(ctypes.addressof(args),
                                torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = lib.wt_fused_pass(ctypes.addressof(args),
                                    torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "wt_fused_pass")
    fused_pass.launches += 1


fused_pass.launches = 0


def synthetic_pass_inputs(chains: int, dim: int, max_depth: int,
                          block_draws: int, seed: int):
    """A valid lane state for one tier-2 pass, made with NumPy from
    ``seed``: ``(fields, params)``, fields by ``LaneState`` name
    (chain-major float64, int32, bool, keys as uint32 key data) and params
    ``inv_mass`` (C, D), ``step`` (C,), ``min_micro`` (C,) int32. Pending
    and idle lanes, ``n_ends`` up to 12, leaves at every index (merges over
    every stack slot), draw counts up to ``block_draws``; most lanes move
    straight along a direction, so their U-turn checks pass and pushes,
    doublings and depth exhaustion happen. The input of the pass checks
    (tests and ``chip_smoke.py``); ``convert.lane_state_from_fields``
    makes the state."""
    C, D, R = int(chains), int(dim), int(block_draws)
    rng = np.random.default_rng(seed)
    n_slots = max(max_depth - 1, 1)
    f = lambda *shape: rng.standard_normal((C,) + shape)
    s = {}
    s["depth"] = np.where(rng.random(C) < 0.4, max_depth,
                          rng.integers(1, max_depth + 1, C)).astype(np.int32)
    s["n_leaves"] = (1 << (s["depth"] - 1)).astype(np.int32)
    s["leaf_idx"] = (rng.random(C) * s["n_leaves"]).astype(np.int32)
    # a third of the lanes sit on the last leaf of their doubling: merges
    # over every slot, subtree completion, deeper / exhausted
    last = rng.random(C) < 0.35
    s["leaf_idx"] = np.where(last, s["n_leaves"] - 1, s["leaf_idx"]).astype(np.int32)
    s["out_depth"] = np.full(C, max_depth + 1, np.int32)
    for n in ("halvings", "steps_done", "phase"):
        s[n] = rng.integers(0, 3, C).astype(np.int32)
    s["steps_total"] = rng.integers(1, 9, C).astype(np.int32)
    s["n_ends"] = rng.integers(0, 13, C).astype(np.int32)
    s["leaf_end_at"] = (rng.random(C) * (s["n_ends"] + 1)).astype(np.int32)
    s["n_depth_exhausted"] = rng.integers(0, 3, C).astype(np.int32)
    s["draws_done"] = rng.integers(0, R + 1, C).astype(np.int32)
    s["forward"] = rng.random(C) < 0.5
    s["leaf_done"] = rng.random(C) < 0.75
    s["leaf_ok"] = rng.random(C) < 0.75
    s["key"] = rng.integers(0, 2**32, (C, 2), dtype=np.uint64).astype(np.uint32)
    s["ku"] = rng.integers(0, 2**32, (C, 2), dtype=np.uint64).astype(np.uint32)

    # rows: most lanes move straight along a direction v, so their U-turn
    # checks pass and pushes / doublings happen; the rest are random
    inv_mass = np.exp(0.3 * f(D))
    v = f(D)
    sgn = np.where(s["forward"], 1.0, -1.0)[:, None]
    straight = (rng.random(C) < 0.7)[:, None]

    def older(th):
        """An older endpoint (position, momentum) on the lane's path."""
        a = 0.5 + 1.5 * rng.random((C, 1))
        th_s = th - sgn * a * v / inv_mass
        rho_s = v + 0.2 * f(D)
        return (np.where(straight, th_s, f(D)),
                np.where(straight, rho_s, f(D)))

    s["fwd_th"] = f(D)
    s["fwd_rho"] = np.where(straight, v + 0.2 * f(D), f(D))
    s["fwd_grad"] = f(D)
    s["acc_th_bk"], s["acc_rho_bk"] = older(s["fwd_th"])
    s["acc_th_fw"], s["acc_rho_fw"] = older(s["fwd_th"])
    stack = np.empty((C, n_slots, 2, D))
    for i in range(n_slots):
        stack[:, i, 0], stack[:, i, 1] = older(s["fwd_th"])
    s["stack_e"] = stack
    for n in ("acc_th_sel", "acc_grad_bk", "acc_grad_sel", "acc_grad_fw",
              "run_sel", "run_sel_grad", "ms_th", "ms_rho", "ms_grad",
              "cur_th", "cur_rho", "cur_grad"):
        s[n] = f(D)
    for n in ("run_sel_logp", "ms_joint", "lp_cur", "acc_jt_bk", "acc_jt_fw",
              "acc_lp_sel", "acc_logw", "fwd_logp_pos", "fwd_joint"):
        s[n] = -10.0 + rng.standard_normal(C)
    s["run_logw"] = np.where(s["leaf_idx"] == 0, -np.inf,
                             -10.0 + rng.standard_normal(C))
    s["dt"] = 0.3 * sgn[:, 0]
    params = dict(inv_mass=inv_mass, step=0.2 + 0.1 * rng.random(C),
                  min_micro=rng.integers(1, 5, C).astype(np.int32))
    return s, params


__all__ = [
    "DEFAULT_PASS_TILE",
    "FusedPassArgs",
    "GraphedPass",
    "RW_FIELDS",
    "bank_draws",
    "fresh_trajectory",
    "fused_pass",
    "fused_pass_plain",
    "lane_field",
    "leaf_apply",
    "own_storage",
    "synthetic_pass_inputs",
]
