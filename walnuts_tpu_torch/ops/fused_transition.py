"""Whole WALNUTS transitions, and whole blocks of draws, as one launch each.

Counterpart of ``walnuts_tpu/ops/fused_transition.py``, with its two entry
points of their own (``walnuts()`` does not reach them, as in the
reference):

- :func:`make_fused_transition`: one transition of every chain per call
  (kernel 5a), momentum passed in;
- :func:`make_fused_sample_block`: ``num_draws`` transitions of every chain
  per call (kernel 5b), the momenta of all draws passed in, each chain
  running at its own pace.

One transition is a flat state machine over attempts: integrate
``steps_total`` leapfrog micro steps, classify the attempt (within
``max_error``, halve and restart, reversibility levels, leaf accepted or
failed), merge an accepted leaf with the stack (U-turn test and Barker
combine), combine a finished subtree into the orbit (Metropolis) and test
the orbit's U-turn, then set up the next attempt. The model's value and
gradient are a :class:`~walnuts_tpu_torch.models.kernels.BatchedVG`.

Decisions draw from a counter hash, not from threefry: :func:`hash32`
(murmur3 finalizer), :func:`draw_uniform` of ``(seed, chain index,
counter)``, bitwise equal to the reference's. The counter starts at 1,
advances once at the start of a transition and ``max_depth + 2`` times per
attempt whether or not a merge happens; draw ``i`` of a sample block starts
at ``1 + 0x9E3779B1 * i``. A chain's stream depends on nothing but the
seed, its index and the counter, so the port is held to the reference
chain by chain.

:func:`fused_transition_plain` and :func:`fused_sample_block_plain` are the
plain PyTorch versions (a Python loop while any chain is live, one host
read per attempt). The callables the factories return check their
arguments on either device, then take the plain version for CPU tensors
and ``csrc/fused_transition.cu`` for CUDA tensors. float32 only.

On the card the chains are handed to the warps by a counter, in the order
of :func:`chain_schedule` (the per-chain work measured by the launches
before on the same tuning, largest first), and a logistic-regression chain
is run by a group of ``GROUP_WARPS`` warps that split its rows (5a 2, 5b
1). The order never changes a chain's result; the group changes only the
order of the evaluation's sums.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import numpy as np
import torch

from walnuts_tpu_torch.ops.integrator import (
    BODIES,
    MAX_DIM,
    MAX_LOGREG_ROWS,
    body_scalars,
    integrate_plain,
    kernel_consts,
)
from walnuts_tpu_torch.ops.logreg_fused import MAX_FEATURES as MAX_LOGREG_FEATURES

#: the deepest tree (``max_depth``) the kernels take
MAX_DEPTH = 16

_M32 = 0xFFFFFFFF
# rows of a span (C, 8, D): theta, rho, grad at the backward end and at the
# forward end, then the selected theta and grad
_TB, _RB, _TF, _RF, _TS, _GS = 0, 1, 3, 4, 6, 7
#: the stride between the counter bases of successive draws of a block
DRAW_STRIDE = 0x9E3779B1


def _u32(x):
    """An int, or an int32 / int64 tensor, as uint32 values (int or int64)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def _mul32(x, c: int):
    """``x * c`` modulo 2^32 on uint32 values, without leaving int64."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash32(x):
    """The murmur3 finalizer on uint32 values (an int, or a tensor of
    ``int32`` bit patterns or of ``int64`` values)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 random bits -> uniform (0, 1] float32 (24 bits)."""
    return (_u32(bits) >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12


def draw_uniform(seed, lane, ctr) -> torch.Tensor:
    """The decision uniform of chain ``lane`` at counter ``ctr`` under
    ``seed`` (``int32`` reinterpreted as ``uint32``); each an int or a
    tensor, broadcast together."""
    seed_mix = hash32(_u32(seed) ^ 0x9E3779B9)
    bits = hash32(seed_mix ^ hash32(lane) ^ _mul32(_u32(ctr), 0x27D4EB2F))
    return uniform_from_bits(torch.as_tensor(bits))


def _lse(a, b):
    m = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    safe = m + torch.log1p(torch.exp(mn - m))
    return torch.where(torch.isinf(m), m, safe)


def _uturn(older_v, newer_v, fwd, inv_mass):
    f = fwd[:, None]
    bk_t = torch.where(f, older_v[:, _TB], newer_v[:, _TB])
    bk_r = torch.where(f, older_v[:, _RB], newer_v[:, _RB])
    fw_t = torch.where(f, newer_v[:, _TF], older_v[:, _TF])
    fw_r = torch.where(f, newer_v[:, _RF], older_v[:, _RF])
    delta = inv_mass * (fw_t - bk_t)
    lo = torch.sum(bk_r * delta, dim=-1)
    hi = torch.sum(fw_r * delta, dim=-1)
    return (hi < 0) | (lo < 0)


def _combine(u, old_v, old_s, new_v, new_s, fwd, barker: bool):
    """Merge two spans: vectors (C, 8, D), scalars (C, 4) holding the joint
    at the backward and forward end, the selected log density and the log
    weight."""
    logw = _lse(old_s[:, 3], new_s[:, 3])
    denom = logw if barker else old_s[:, 3]
    take_new = torch.log(u) < (new_s[:, 3] - denom)
    f3, t3 = fwd[:, None, None], take_new[:, None, None]
    v = torch.cat([torch.where(f3, old_v[:, :3], new_v[:, :3]),
                   torch.where(f3, new_v[:, 3:6], old_v[:, 3:6]),
                   torch.where(t3, new_v[:, 6:], old_v[:, 6:])], dim=1)
    s = torch.stack([torch.where(fwd, old_s[:, 0], new_s[:, 0]),
                     torch.where(fwd, new_s[:, 1], old_s[:, 1]),
                     torch.where(take_new, new_s[:, 2], old_s[:, 2]),
                     logw], dim=1)
    return v, s


def _point_span(theta, rho, grad):
    return torch.stack([theta, rho, grad, theta, rho, grad, theta, grad], dim=1)


def fused_transition_plain(vg: Callable, seed, theta, rho, logp0, grad0, step,
                           inv_mass, min_micro, max_error, *, max_depth: int,
                           max_step_halvings: int, ctr0: int = 1, attempts=None):
    """One transition of every chain with tensor operations; returns
    ``(theta, grad, logp, depth, n_grads)``. ``attempts``, a ``(C,)`` int32
    tensor, is incremented in place on every chain for each attempt it runs
    (the work count behind a bound).

    The reference's state machine in the reference's order of arithmetic,
    on ``(C,)`` and ``(C, D)`` tensors: every attempt is computed for every
    chain and kept on the live ones. Chains are live from the first attempt
    until they finish, so the live chains share one counter, kept as an int
    (``ctr0`` is its start: 1, or a sample block's base for the draw)."""
    C, D = theta.shape
    MD = int(max_depth)
    dev = theta.device
    f32 = torch.float32
    sl = hash32(_u32(seed) ^ 0x9E3779B9) ^ hash32(
        torch.arange(C, device=dev, dtype=torch.int64))

    def draw(ctr: int):
        return uniform_from_bits(hash32(sl ^ _mul32(ctr & _M32, 0x27D4EB2F)))

    kinetic = lambda r: -0.5 * torch.sum(inv_mass * r * r, dim=-1)
    zi = torch.zeros(C, dtype=torch.int32, device=dev)
    ctr = int(ctr0)
    joint0 = logp0 + kinetic(rho)
    fwd_dir = draw(ctr) < 0.5
    ctr += 1
    start = torch.stack([theta, rho, grad0], dim=1)
    s = dict(
        done=torch.zeros(C, dtype=torch.bool, device=dev),
        depth=zi + 1, out_depth=zi + (MD + 1),
        acc_v=_point_span(theta, rho, grad0),
        acc_s=torch.stack([joint0, joint0, logp0, joint0], dim=1),
        fwd_dir=fwd_dir, leaf_idx=zi, n_leaves=zi + 1,
        ms=start, ms_joint=joint0, halvings=zi,
        dt=torch.where(fwd_dir, step, -step),
        steps_total=min_micro, in_fwd=torch.ones(C, dtype=torch.bool, device=dev),
        cur=start, fwd=start, fwd_lp=logp0, fwd_joint=joint0, n_grads=zi + 1,
        stk_v=torch.zeros((C, MD, 8, D), dtype=f32, device=dev),
        stk_s=torch.zeros((C, MD, 4), dtype=f32, device=dev),
    )
    rev_sign = torch.tensor([1.0, -1.0, 1.0], dtype=f32, device=dev)[None, :, None]

    while True:
        live = ~s["done"]
        n_eff = torch.where(live, s["steps_total"], 0)
        max_n = int(n_eff.max()) if C else 0  # reads the device
        if max_n == 0:
            break
        if attempts is not None:
            attempts += live
        fwd_dir = s["fwd_dir"]
        cur_n, lp_n = integrate_plain(vg, s["cur"], inv_mass, s["dt"], n_eff, max_n)
        n_grads = s["n_grads"] + n_eff
        joint_n = lp_n + kinetic(cur_n[:, 1])
        in_fwd = s["in_fwd"]

        # the forward attempt completed
        f_ok = torch.abs(s["ms_joint"] - joint_n) <= max_error
        f_done = live & in_fwd
        need_rev = s["steps_total"] >= 2 * min_micro
        start_rev = f_done & f_ok & need_rev
        leaf_ok = f_done & f_ok & ~need_rev
        more_h = (s["halvings"] + 1) < max_step_halvings
        restart = f_done & ~f_ok & more_h
        leaf_fail = f_done & ~f_ok & ~more_h

        # a reversibility level completed
        r_done = live & ~in_fwd
        r_within = torch.abs(joint_n - s["fwd_joint"]) <= max_error
        leaf_fail = leaf_fail | (r_done & r_within)
        next_rev = r_done & ~r_within & need_rev
        leaf_ok = leaf_ok | (r_done & ~r_within & ~need_rev)

        set_fwd = f_done & f_ok
        fwd = torch.where(set_fwd[:, None, None], cur_n, s["fwd"])
        fwd_lp = torch.where(set_fwd, lp_n, s["fwd_lp"])
        fwd_joint = torch.where(set_fwd, joint_n, s["fwd_joint"])

        # the merge cascade over the stack's slots
        cur_v = _point_span(fwd[:, 0], fwd[:, 1], fwd[:, 2])
        cur_s = torch.stack([fwd_joint, fwd_joint, fwd_lp, fwd_joint], dim=1)
        lp1 = s["leaf_idx"] + 1
        n_merges = sum(((lp1 & ((1 << i) - 1)) == 0).to(torch.int32)
                       for i in range(1, MD + 1))
        ok = torch.ones_like(live)
        for i in range(MD):
            do = leaf_ok & (i < n_merges) & ok
            top_v, top_s = s["stk_v"][:, i], s["stk_s"][:, i]
            ut = _uturn(top_v, cur_v, fwd_dir, inv_mass)
            m_v, m_s = _combine(draw(ctr + i), top_v, top_s, cur_v, cur_s,
                                fwd_dir, barker=True)
            cur_v = torch.where(do[:, None, None], m_v, cur_v)
            cur_s = torch.where(do[:, None], m_s, cur_s)
            ok = ok & ~(do & ut)
        sub_uturn = leaf_ok & ~ok
        leaf_ok = leaf_ok & ok

        new_leaf_idx = s["leaf_idx"] + 1
        subtree_done = leaf_ok & (new_leaf_idx >= s["n_leaves"])
        push = leaf_ok & ~subtree_done
        slot = push[:, None] & (n_merges[:, None]
                                == torch.arange(MD, device=dev)[None, :])
        stk_v = torch.where(slot[:, :, None, None], cur_v[:, None], s["stk_v"])
        stk_s = torch.where(slot[:, :, None], cur_s[:, None], s["stk_s"])

        # the orbit: Metropolis combine and U-turn
        ut_top = _uturn(s["acc_v"], cur_v, fwd_dir, inv_mass)
        comb_v, comb_s = _combine(draw(ctr + MD), s["acc_v"], s["acc_s"], cur_v,
                                  cur_s, fwd_dir, barker=False)
        acc_v = torch.where(subtree_done[:, None, None], comb_v, s["acc_v"])
        acc_s = torch.where(subtree_done[:, None], comb_s, s["acc_s"])
        end_uturn = subtree_done & ut_top
        new_depth = s["depth"] + 1
        deeper = subtree_done & ~ut_top & (new_depth <= MD)
        exhausted = subtree_done & ~ut_top & (new_depth > MD)

        fail = leaf_fail | sub_uturn
        done = fail | end_uturn | exhausted | s["done"]
        out_depth = torch.where(
            fail | end_uturn, s["depth"],
            torch.where(exhausted, MD + 1, s["out_depth"]))

        new_dir = torch.where(deeper, draw(ctr + MD + 1) < 0.5, fwd_dir)
        ctr = (ctr + MD + 2) & _M32
        depth = torch.where(deeper, new_depth, s["depth"])
        n_leaves = torch.where(
            deeper, torch.bitwise_left_shift(torch.ones_like(new_depth),
                                             new_depth - 1), s["n_leaves"])
        leaf_idx = torch.where(deeper, 0, new_leaf_idx)
        leaf_idx = torch.where(leaf_ok | deeper, leaf_idx, s["leaf_idx"])

        acc_end = torch.where(new_dir[:, None, None], acc_v[:, 3:6], acc_v[:, 0:3])
        acc_end_joint = torch.where(new_dir, acc_s[:, 1], acc_s[:, 0])
        ms = torch.where(deeper[:, None, None], acc_end,
                         torch.where(push[:, None, None], fwd, s["ms"]))
        ms_joint = torch.where(deeper, acc_end_joint,
                               torch.where(push, fwd_joint, s["ms_joint"]))

        start_macro = deeper | push
        from_rev = start_rev | next_rev
        dt_base = torch.where(new_dir, step, -step)
        halvings = torch.where(start_macro, 0,
                               torch.where(restart, s["halvings"] + 1,
                                           s["halvings"]))
        in_fwd_n = start_macro | restart | (in_fwd & ~from_rev)
        steps_total = torch.where(
            start_macro, min_micro,
            torch.where(restart, s["steps_total"] * 2,
                        torch.where(from_rev, s["steps_total"] // 2,
                                    s["steps_total"])))
        dt = torch.where(start_macro, dt_base,
                         torch.where(restart, s["dt"] * 0.5,
                                     torch.where(from_rev, s["dt"] * 2.0, s["dt"])))
        cur = torch.where(from_rev[:, None, None], fwd * rev_sign,
                          torch.where((start_macro | restart)[:, None, None], ms,
                                      cur_n))

        new = dict(
            done=done, depth=depth, out_depth=out_depth, acc_v=acc_v,
            acc_s=acc_s, fwd_dir=new_dir, leaf_idx=leaf_idx, n_leaves=n_leaves,
            ms=ms, ms_joint=ms_joint, halvings=halvings, dt=dt,
            steps_total=steps_total, in_fwd=in_fwd_n, cur=cur, fwd=fwd,
            fwd_lp=fwd_lp, fwd_joint=fwd_joint, n_grads=n_grads, stk_v=stk_v,
            stk_s=stk_s,
        )
        s = {k: torch.where(live.reshape((C,) + (1,) * (v.dim() - 1)), v, s[k])
             for k, v in new.items()}

    return (s["acc_v"][:, _TS].contiguous(), s["acc_v"][:, _GS].contiguous(),
            s["acc_s"][:, 2].contiguous(), s["out_depth"], s["n_grads"])


def fused_sample_block_plain(vg: Callable, seed, theta, logp0, grad0, rho, step,
                             inv_mass, min_micro, max_error, *, max_depth: int,
                             max_step_halvings: int, attempts=None):
    """``rho.shape[0]`` transitions of every chain, one after the other;
    returns ``(draws, logps, theta_f, grad_f, logp_f, n_grads)``. Draw ``i``
    starts its counter at ``1 + DRAW_STRIDE * i``; ``n_grads`` leaves out
    each draw's first evaluation, which the draw before carried over."""
    n = rho.shape[0]
    draws = torch.empty_like(rho)
    logps = torch.empty(rho.shape[:2], dtype=rho.dtype, device=rho.device)
    n_grads = torch.zeros_like(min_micro)
    lp, grad = logp0, grad0
    for i in range(n):
        theta, grad, lp, _, ng = fused_transition_plain(
            vg, seed, theta, rho[i], lp, grad, step, inv_mass, min_micro,
            max_error, max_depth=max_depth, max_step_halvings=max_step_halvings,
            ctr0=(1 + DRAW_STRIDE * i) & _M32, attempts=attempts)
        draws[i], logps[i] = theta, lp
        n_grads = n_grads + ng - 1
    return draws, logps, theta, grad, lp, n_grads


_POINTERS = ("theta", "rho", "logp0", "grad0", "step", "inv_mass", "min_micro",
             "c0", "c1", "work", "sched", "trace", "draws", "logps", "theta_out",
             "grad_out", "logp_out", "depth_out", "ngrads_out")
_INTS = ("chains", "dim", "num_draws", "body", "max_depth", "max_step_halvings",
         "n_data", "seed", "skip_first_grad", "sms", "group")
_FLOATS = ("max_error", "p0", "p1")


class TransitionArgs(ctypes.Structure):
    """The kernel's operands: every pointer, the sizes, the float scalars."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


def chain_schedule(c: int, measured=None, device=None) -> torch.Tensor:
    """The kernel's ``sched`` operand, made anew for every launch: an int32
    counter at 0, then the ``c`` chain indices in the order the warps take
    them. Most evaluations first by ``measured``, the per-chain ``n_grads``
    of the launches before on the same chains and tuning (from one block of
    100 logistic-regression draws to the next their correlation was 0.925
    on the card), so that the chains left for the end of a launch are
    short; ties, and every chain when nothing was measured, in index
    order."""
    sched = torch.zeros(c + 1, dtype=torch.int32, device=device)
    sched[1:] = (torch.arange(c, device=device) if measured is None
                 else torch.argsort(measured, descending=True, stable=True))
    return sched


class _FusedMachine:
    """What both entry points share: the model, the static sizes, the
    argument checks and the kernel's launch. ``launches`` counts the
    kernel's launches. On the card, ``GROUP_WARPS`` warps share a
    logistic-regression chain (a constant of each entry point, from a sweep
    on the H100). ``trace``, None or a contiguous ``(C, 3)`` int64 tensor on
    the card, receives each chain's start and end on the card's clock (ns)
    and its SM at every launch."""

    name = ""
    GROUP_WARPS = 1
    trace = None

    def __init__(self, model, dim: int, max_depth: int, max_step_halvings: int):
        vg = model[0] if isinstance(model, tuple) else model
        if not callable(vg) or not hasattr(vg, "dim"):
            raise TypeError(
                f"{self.name}: model must be (vg, dim, consts) from "
                "walnuts_tpu_torch.models.kernels, or its vg")
        if int(dim) != vg.dim:
            raise ValueError(
                f"{self.name}: the model has {vg.dim} parameters; dim is {dim}")
        if not 1 <= int(max_depth) <= MAX_DEPTH:
            raise ValueError(
                f"{self.name}: max_depth must be in [1, {MAX_DEPTH}]; got {max_depth}")
        if int(max_step_halvings) < 1:
            raise ValueError(
                f"{self.name}: max_step_halvings must be at least 1; got "
                f"{max_step_halvings}")
        self.vg = vg
        self.dim = int(dim)
        self.max_depth = int(max_depth)
        self.max_step_halvings = int(max_step_halvings)
        self.launches = 0
        self._consts = {}  # device -> the body's constant tensors

    def _check(self, theta, others: Callable):
        """``others(c, d)``: name -> (tensor, dtype, shape)."""
        name = self.name
        if not isinstance(theta, torch.Tensor) or theta.dim() != 2:
            raise ValueError(f"{name}: theta must be a (C, D) tensor")
        dev = theta.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {dev}")
        if theta.dtype != torch.float32:
            raise ValueError(f"{name}: float32 only; theta is {theta.dtype}")
        c, d = theta.shape
        if d != self.dim:
            raise ValueError(
                f"{name}: the model has {self.dim} parameters; theta has {d}")
        others = dict(theta=(theta, torch.float32, (c, d)), **others(c, d))
        for what, (t, dtype, shape) in others.items():
            if (not isinstance(t, torch.Tensor) or t.dtype != dtype
                    or tuple(t.shape) != shape or t.device != dev
                    or not t.is_contiguous()):
                got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                       f"{'' if t.is_contiguous() else ', not contiguous'}"
                       if isinstance(t, torch.Tensor) else type(t).__name__)
                raise ValueError(
                    f"{name}: {what} must be a contiguous {dtype} {shape} "
                    f"tensor on {dev}; got {got}")
        if d > MAX_DIM:
            raise ValueError(
                f"{name}: the kernel takes up to {MAX_DIM} parameters; got {d}")
        if getattr(self.vg, "body", None) == "logistic_regression":
            n = self.vg.params["num_data"]
            if d > MAX_LOGREG_FEATURES or n > MAX_LOGREG_ROWS:
                raise ValueError(
                    f"{name}: the logistic-regression body takes up to "
                    f"{MAX_LOGREG_FEATURES} features and {MAX_LOGREG_ROWS} rows; "
                    f"got {d} and {n}")
        return c, d

    def _launch(self, entry: str, seed, max_error, c: int, d: int, num_draws: int,
                skip_first_grad: int, operands: dict) -> None:
        """Launch ``entry`` of ``csrc/fused_transition.cu`` on the current
        stream; ``operands``: the struct's tensors by field name."""
        vg, name = self.vg, self.name
        body = getattr(vg, "body", None)
        if body not in BODIES:
            raise ValueError(
                f"{name}: no device body for {body!r} in csrc/models.cuh; on "
                f"CUDA tensors the model must be one of {sorted(BODIES)}")
        group = self.GROUP_WARPS if body == "logistic_regression" else 1
        from walnuts_tpu_torch.ops import _cuda

        lib = _cuda.library("fused_transition")
        if lib.wt_transition_args_size() != ctypes.sizeof(TransitionArgs):
            raise RuntimeError(f"{name}: TransitionArgs differs from the kernel's")
        dev = operands["theta"].device
        consts = self._consts.get(dev)
        if consts is None:
            consts = self._consts[dev] = kernel_consts(vg, dev, torch.float32)
        tuning = _tuning_key(operands["step"], operands["inv_mass"],
                             operands["min_micro"])
        measured = _MEASURED[1] if _MEASURED[0] == tuning else None
        p0, p1, n_data = body_scalars(vg, d)
        ptrs = {n: t.data_ptr() for n, t in operands.items()}
        ptrs.update(zip(("c0", "c1"), (t.data_ptr() for t in consts)))
        args = TransitionArgs(
            chains=c, dim=d, num_draws=num_draws, body=BODIES[body],
            max_depth=self.max_depth, max_step_halvings=self.max_step_halvings,
            n_data=n_data, seed=_as_int32(seed), skip_first_grad=skip_first_grad,
            sms=_sm_count(dev), group=group, max_error=float(max_error), p0=p0,
            p1=p1, **ptrs)
        with torch.cuda.device(dev):
            floats = ctypes.c_longlong(0)
            _cuda.check(lib.wt_transition_workspace(ctypes.addressof(args),
                                                    ctypes.addressof(floats)),
                        "wt_transition_workspace")
            # the warps' span workspaces (each row written before it is
            # read), the counter and the order
            work = torch.empty(floats.value, dtype=torch.float32, device=dev)
            sched = chain_schedule(c, measured, dev)
            args.work = work.data_ptr()
            args.sched = sched.data_ptr()
            if self.trace is not None:
                if (self.trace.dtype != torch.int64 or self.trace.device != dev
                        or tuple(self.trace.shape) != (c, 3)
                        or not self.trace.is_contiguous()):
                    raise ValueError(f"{name}: trace must be a contiguous int64 "
                                     f"({c}, 3) tensor on {dev}")
                args.trace = self.trace.data_ptr()
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, entry)(ctypes.addressof(args), stream)
        _cuda.check(err, entry)
        self.launches += 1
        n_grads = operands["ngrads_out"].to(torch.int64)
        _MEASURED[:] = [tuning, n_grads if measured is None else measured + n_grads]


_SMS: dict = {}  # device -> its multiprocessor count
# The per-chain evaluations the kernels made, summed over the launches on
# the same chains and tuning: [key, int64 (C,) tensor on the card]. The key
# is the identity of step, inv_mass and min_micro (data pointer and version)
# and the chain count: a sampling path passes the same tensors launch after
# launch. One entry, shared by both entry points, so a sampler's draws
# through 5a order its next block of 5b draws. A stale hit (a new tensor at
# a freed one's address) would change a launch's order, never a chain's
# result.
_MEASURED: list = [None, None]


def _tuning_key(step, inv_mass, min_micro) -> tuple:
    """The key of :data:`_MEASURED` for a launch on these tuning tensors."""
    key = tuple((t.data_ptr(), t._version) for t in (step, inv_mass, min_micro))
    return key + (step.shape[0],)


def _sm_count(dev: torch.device) -> int:
    n = _SMS.get(dev)
    if n is None:
        n = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _as_int32(seed) -> int:
    """``seed``'s low 32 bits as a signed int (the kernel reinterprets)."""
    v = int(seed) & _M32
    return v - (1 << 32) if v >= 1 << 31 else v


class FusedTransition(_FusedMachine):
    """One transition per call; see :func:`make_fused_transition`."""

    name = "fused transition"
    GROUP_WARPS = 2

    def __call__(self, seed, theta, rho, logp0, grad0, step, inv_mass, min_micro,
                 max_error):
        f, i = torch.float32, torch.int32
        c, d = self._check(theta, lambda c, d: dict(
            rho=(rho, f, (c, d)), logp0=(logp0, f, (c,)), grad0=(grad0, f, (c, d)),
            step=(step, f, (c,)), inv_mass=(inv_mass, f, (c, d)),
            min_micro=(min_micro, i, (c,))))
        if theta.device.type == "cpu":
            return fused_transition_plain(
                self.vg, seed, theta, rho, logp0, grad0, step, inv_mass,
                min_micro, max_error, max_depth=self.max_depth,
                max_step_halvings=self.max_step_halvings)
        out = (torch.empty_like(theta), torch.empty_like(theta),
               torch.empty_like(logp0), torch.empty_like(min_micro),
               torch.empty_like(min_micro))
        if c:
            self._launch("wt_fused_transition", seed, max_error, c, d, 1, 0, dict(
                theta=theta, rho=rho, logp0=logp0, grad0=grad0, step=step,
                inv_mass=inv_mass, min_micro=min_micro, theta_out=out[0],
                grad_out=out[1], logp_out=out[2], depth_out=out[3],
                ngrads_out=out[4]))
        return out


class FusedSampleBlock(_FusedMachine):
    """``num_draws`` transitions per call; see :func:`make_fused_sample_block`."""

    name = "fused sample block"
    GROUP_WARPS = 1

    def __init__(self, model, dim, max_depth, max_step_halvings, num_draws):
        super().__init__(model, dim, max_depth, max_step_halvings)
        if int(num_draws) < 1:
            raise ValueError(
                f"{self.name}: num_draws must be at least 1; got {num_draws}")
        self.num_draws = int(num_draws)

    def __call__(self, seed, theta, logp0, grad0, rho, step, inv_mass, min_micro,
                 max_error):
        f, i = torch.float32, torch.int32
        n = self.num_draws
        c, d = self._check(theta, lambda c, d: dict(
            logp0=(logp0, f, (c,)), grad0=(grad0, f, (c, d)),
            rho=(rho, f, (n, c, d)), step=(step, f, (c,)),
            inv_mass=(inv_mass, f, (c, d)), min_micro=(min_micro, i, (c,))))
        if theta.device.type == "cpu":
            return fused_sample_block_plain(
                self.vg, seed, theta, logp0, grad0, rho, step, inv_mass,
                min_micro, max_error, max_depth=self.max_depth,
                max_step_halvings=self.max_step_halvings)
        out = (torch.empty_like(rho), torch.empty((n, c), dtype=f, device=rho.device),
               torch.empty_like(theta), torch.empty_like(theta),
               torch.empty_like(logp0), torch.empty_like(min_micro))
        if c:
            self._launch("wt_fused_sample_block", seed, max_error, c, d, n, 1, dict(
                theta=theta, rho=rho, logp0=logp0, grad0=grad0, step=step,
                inv_mass=inv_mass, min_micro=min_micro, draws=out[0],
                logps=out[1], theta_out=out[2], grad_out=out[3], logp_out=out[4],
                ngrads_out=out[5]))
        return out


def make_fused_transition(model, dim: int, max_depth: int,
                          max_step_halvings: int) -> FusedTransition:
    """One WALNUTS transition of every chain per call.

    ``model`` is what a factory of ``models.kernels`` returns, ``(vg, dim,
    consts)``, or its ``vg``. Returns ``fn(seed, theta (C, D), rho (C, D),
    logp0 (C,), grad0 (C, D), step (C,), inv_mass (C, D), min_micro (C,)
    int32, max_error) -> (theta (C, D), grad (C, D), logp (C,), depth (C,)
    int32, n_grads (C,) int32)``, all float32 and contiguous on one device;
    ``seed`` and ``max_error`` are host numbers. ``rho`` is the transition's
    momentum, drawn N(0, M): ``z / sqrt(inv_mass)``. ``n_grads`` counts the
    start point's evaluation as one.

    CPU tensors take :func:`fused_transition_plain`; CUDA tensors launch
    ``csrc/fused_transition.cu`` once, each chain looping at its own pace
    (up to 1024 parameters; logistic regression up to 32 features and 1024
    rows; ``max_depth`` up to 16; a ``vg`` with no device body raises). The
    arguments are checked on either device. The reference's tile and VMEM
    options (``block_b``, ``lane_width``, ``interpret``,
    ``vmem_limit_bytes``) have no counterpart, and the model's constants
    ride on ``vg``.
    """
    return FusedTransition(model, dim, max_depth, max_step_halvings)


def make_fused_sample_block(model, dim: int, max_depth: int,
                            max_step_halvings: int,
                            num_draws: int) -> FusedSampleBlock:
    """``num_draws`` WALNUTS transitions of every chain per call: the
    sampling loop with no host work inside or between draws.

    Returns ``fn(seed, theta (C, D), logp0 (C,), grad0 (C, D), rho
    (num_draws, C, D), step (C,), inv_mass (C, D), min_micro (C,) int32,
    max_error) -> (draws (num_draws, C, D), logps (num_draws, C), theta_f,
    grad_f, logp_f, n_grads (C,) int32)``. ``rho[i]`` is draw ``i``'s
    momentum, N(0, M). ``n_grads`` sums the draws' evaluations without each
    draw's first, which the draw before carried over. Devices, limits and
    checks as :func:`make_fused_transition`; on CUDA tensors one launch, a
    chain starting its next draw as soon as it finished the last.
    """
    return FusedSampleBlock(model, dim, max_depth, max_step_halvings, num_draws)


def synthetic_transition_inputs(chains: int, dim: int, seed: int, *,
                                num_draws: int = 1, theta_scale: float = 1.0,
                                inv_mass_scale: float = 1.0,
                                step_range: Tuple[float, float] = (0.2, 0.8),
                                max_min_micro: int = 2) -> dict:
    """A transition's operands for every chain, made with NumPy from
    ``seed`` (float64 and int32): ``theta`` ~ ``theta_scale`` N(0, 1),
    per-chain ``inv_mass`` (log-normal around ``inv_mass_scale``), ``rho``
    ``(num_draws, C, D)`` ~ N(0, M), per-chain ``step`` uniform on
    ``step_range`` and ``min_micro`` uniform on 1..``max_min_micro``. The
    input of the transition checks (tests and ``chip_smoke.py``);
    :func:`transition_tensors` adds the model's value and gradient."""
    rng = np.random.default_rng(seed)
    c, d = int(chains), int(dim)
    inv_mass = inv_mass_scale * np.exp(0.3 * rng.standard_normal((c, d)))
    return dict(
        theta=theta_scale * rng.standard_normal((c, d)),
        rho=rng.standard_normal((int(num_draws), c, d)) / np.sqrt(inv_mass),
        inv_mass=inv_mass,
        step=rng.uniform(*step_range, c),
        min_micro=rng.integers(1, max_min_micro + 1, c).astype(np.int32),
    )


def transition_tensors(vg: Callable, inputs: dict, device) -> dict:
    """:func:`synthetic_transition_inputs` as float32 tensors on ``device``
    with ``logp0`` and ``grad0`` from ``vg``; ``rho`` keeps its draw axis."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device).contiguous()
    out = {k: t(inputs[k]) for k in ("theta", "rho", "inv_mass", "step")}
    out["min_micro"] = torch.as_tensor(inputs["min_micro"], device=device)
    lp, grad = vg(out["theta"])
    out["logp0"], out["grad0"] = lp.contiguous(), grad.contiguous()
    return out


__all__ = [
    "DRAW_STRIDE",
    "MAX_DEPTH",
    "FusedSampleBlock",
    "FusedTransition",
    "chain_schedule",
    "draw_uniform",
    "fused_sample_block_plain",
    "fused_transition_plain",
    "hash32",
    "make_fused_sample_block",
    "make_fused_transition",
    "synthetic_transition_inputs",
    "transition_tensors",
    "uniform_from_bits",
]
