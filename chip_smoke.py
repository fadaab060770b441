"""Chip smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version at the main path's shapes, then drives four paths of the port on
adaptive WALNUTS for the 25-coefficient logistic regression (1000 rows)
with the fused model kernel, 4096 chains, float32:

- the main path, ``walnuts_tpu_torch.walnuts`` (batched scheduler, 30
  warmup + 30 sampling iterations): the replay and logistic-regression
  kernels must run on it;
- the fused route: ``run_warmup`` (50 iterations), then ``run_sampling``
  (50 iterations) twice from the same warmed state, with the unfused
  tier-2 pass and with ``pallas_pass=True``: the fused-pass kernel must
  run on the second;
- the classic path: ``walnuts(batched=False, integrator=...)`` (20 + 20
  iterations) with the fused leapfrog integrator, which must launch once
  per attempt; then 20 classic sampling iterations from the fused route's
  warmed state with the kernel and with the plain integrator, for an A/B;
- the transition path, from the same warmed state (its step sizes, inverse
  masses and ``min_micro``): 50 draws through ``make_fused_transition``
  (momenta, the logistic-regression kernel for the start point, one launch
  per draw, no host sync in the loop), then 4 launches of 100 draws
  through ``make_fused_sample_block``; then 20 draws of each beside the
  classic A/B's 20 iterations.

Each path's draws must be finite, and their pooled posterior mean and sd
must agree with NumPy references (a Newton MAP, its Laplace sd, and the
importance-reweighted Laplace mean).

Run from the root of a checkout:  python3 chip_smoke.py [--profile] [--ab]

``--profile`` adds a ``torch.profiler`` window over a short run and prints
device time by kernel. ``--ab`` samples the fused route's warmed state four
times, unfused, fused, fused, unfused, for an A/B of the two passes. Any
failed phase raises (non-zero exit). The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists each kernel's
route, launches on its path, error against its plain version, times and
bound (the integrator's and the transition kernels' with their
logistic-regression body; their three other bodies are checked and printed
on earlier lines).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

SEED = 2026
CHAINS = 4096
DIM = 25
ROWS = 1000
DEVICE = "cuda"
# the bench's halving budget (bench.py): with the default 5, chains that
# start in the far tail can stay stuck through 100 warmup iterations, in
# the reference as in the port
HALVINGS = 8
# warmup and sampling iterations of the main path and of the classic path,
# and sampling iterations of each run of the fused route
MAIN_ITERS = 30
CLASSIC_ITERS = 20
ROUTE_ITERS = 50
# the transition path: draws through the single-transition kernel, launches
# and draws per launch of the sample-block kernel, draws of each in the A/B
# beside the classic path, and the energy-error limit of every attempt
TRANSITION_DRAWS = 50
BLOCK_LAUNCHES = 4
BLOCK_DRAWS = 100
AB_DRAWS = 20
MAX_ERROR = 0.5
MAX_DEPTH = 5
# draws of the sample block that is held against its plain version
BLOCK_CHECK_DRAWS = 8
# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, float32 outside the
# tensor cores (also taken as the integer ALU rate, which the guide's table
# does not list)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# threefry2x32: 20 rounds of add, rotate (two shifts and an or) and xor,
# five key injections of three adds: ~115 integer operations a hash
THREEFRY_OPS = 115
# cycles of torch.cuda._sleep queued ahead of a timed window, so that the
# host has enqueued the timed launches before the card reaches them and
# the events see device time, not the wrappers' host cost (~12 ms)
LEAD_CYCLES = 20_000_000


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int = 100, warmup: int = 5, lead: bool = True) -> float:
    """Device milliseconds per call of ``fn``: CUDA events over ``reps``
    calls after ``warmup`` calls. With ``lead`` a sleep kernel runs first,
    so that the events time the card, not the host's enqueue rate; a plain
    version that waits on the host is timed without it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if lead:
        torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profiled_ms(fn, kernel: str, reps: int = 50) -> float | None:
    """Device milliseconds per launch of the kernel whose name contains
    ``kernel``, from a ``torch.profiler`` window around ``reps`` calls of
    ``fn`` alone; None if the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [(e.device_time_total, e.count) for e in prof.key_averages()
            if kernel in e.key and e.device_time_total > 0]
    if not hits:
        return None
    return sum(h[0] for h in hits) / sum(h[1] for h in hits) / 1e3


def bound(nbytes: float, ops: float) -> tuple:
    """The least time (ms) the card could take: the larger of the bytes
    over HBM's rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_replay(card: str) -> dict:
    from walnuts_tpu_torch.convert import key_data_torch
    from walnuts_tpu_torch.ops import prng

    rng = np.random.default_rng(SEED)
    kd = rng.integers(0, 2**32, size=(CHAINS, 2), dtype=np.uint64).astype(np.uint32)
    ku = rng.integers(0, 2**32, size=(CHAINS, 2), dtype=np.uint64).astype(np.uint32)
    n_ends = rng.integers(0, 13, size=CHAINS).astype(np.int32)
    leaf_end_at = (rng.random(CHAINS) * (n_ends + 1)).astype(np.int32)
    args = [key_data_torch(kd, DEVICE), key_data_torch(ku, DEVICE),
            torch.from_numpy(n_ends).to(DEVICE),
            torch.from_numpy(leaf_end_at).to(DEVICE)]
    got = prng.replay_split_chain(*args)
    want = prng.replay_split_chain_plain(*args)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    if err != 0:
        raise AssertionError(f"replay kernel differs from its plain version (max {err})")
    ms = time_ms(lambda: prng.replay_split_chain(*args))
    host_ms = time_ms(lambda: prng.replay_split_chain(*args), lead=False)
    dev_ms = profiled_ms(lambda: prng.replay_split_chain(*args), "replay_kernel")
    plain_ms = time_ms(lambda: prng.replay_split_chain_plain(*args), reps=20,
                       lead=False)
    # each lane reads 24 bytes and writes 16; one hash per round, one more
    # at the round that latches ku
    hashes = int(n_ends.sum()) + int(((leaf_end_at >= 1) & (leaf_end_at <= n_ends)).sum())
    bound_ms, bound_by = bound(40.0 * CHAINS, THREEFRY_OPS * hashes)
    print(f"[replay] kernel bitwise equal to plain at C={CHAINS}, n_ends in "
          f"[0, 12]: kernel {ms:.4f} ms (events behind a sleep), profiler "
          f"device time {dev_ms if dev_ms is None else f'{dev_ms:.4f}'} ms, "
          f"back-to-back calls {host_ms:.4f} ms (the wrapper's host cost); "
          f"plain {plain_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us "
          f"({bound_by})  [{card}]")
    return dict(name="replay_split_chain", route="cuda",
                source="walnuts_tpu_torch/csrc/replay.cu",
                replaces="walnuts_tpu/ops/prng.py:170",
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_logreg(card: str) -> dict:
    from walnuts_tpu_torch.convert import logreg_tensors
    from walnuts_tpu_torch.models.targets import logistic_regression_data
    from walnuts_tpu_torch.ops.logreg_fused import (
        logreg_value_grad,
        logreg_value_grad_plain,
    )

    design, y = logistic_regression_data(ROWS, DIM)
    x_t, y_t = logreg_tensors(design, y, DEVICE)
    rng = np.random.default_rng(SEED + 1)
    theta = torch.from_numpy(
        (0.3 * rng.standard_normal((CHAINS, DIM))).astype(np.float32)).to(DEVICE)
    lp_k, g_k = logreg_value_grad(theta, x_t, y_t)
    lp_p, g_p = logreg_value_grad_plain(theta, x_t, y_t)
    torch.cuda.synchronize()
    lp_k, g_k, lp_p, g_p = (t.cpu().numpy() for t in (lp_k, g_k, lp_p, g_p))
    np.testing.assert_allclose(lp_k, lp_p, rtol=1e-5)
    np.testing.assert_allclose(g_k, g_p, rtol=1e-4, atol=2e-3)
    err = float(max(np.abs(lp_k - lp_p).max(), np.abs(g_k - g_p).max()))
    ms = time_ms(lambda: logreg_value_grad(theta, x_t, y_t))
    dev_ms = profiled_ms(lambda: logreg_value_grad(theta, x_t, y_t), "logreg_kernel")
    plain_ms = time_ms(lambda: logreg_value_grad_plain(theta, x_t, y_t))
    # no single PyTorch call computes the function; the plain version's two
    # matrix products are the nearest library yardstick
    z = torch.empty((CHAINS, ROWS), device=DEVICE)
    mm_ms = time_ms(lambda: (torch.matmul(theta, x_t.T, out=z), z @ x_t))
    # two products of 2 * B * N * P flops; theta, X, y read, lp and grad written
    bound_ms, bound_by = bound(4.0 * (2 * CHAINS * DIM + ROWS * DIM + ROWS + CHAINS),
                               4.0 * CHAINS * ROWS * DIM)
    print(f"[logreg] kernel within lp rtol 1e-5, grad rtol 1e-4 atol 2e-3 of "
          f"plain at ({CHAINS}, {DIM}) x ({ROWS}, {DIM}): max abs err {err:.3e}; "
          f"kernel {ms:.4f} ms (profiler {dev_ms if dev_ms is None else f'{dev_ms:.4f}'} "
          f"ms), plain {plain_ms:.4f} ms, its two torch.matmul products "
          f"{mm_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us ({bound_by}), "
          f"{bound_ms / ms:.3f} of it  [{card}]")
    return dict(name="logreg_value_grad", route="cuda",
                source="walnuts_tpu_torch/csrc/logreg.cu",
                replaces="walnuts_tpu/ops/pallas_kernels.py:31",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _pass_case(dim: int, seed: int):
    """A synthetic lane state at the main path's batch, on the card, its
    frozen parameters and an empty block output."""
    from walnuts_tpu_torch.convert import lane_state_from_fields
    from walnuts_tpu_torch.ops.fused_pass import synthetic_pass_inputs

    fields, p = synthetic_pass_inputs(CHAINS, dim, 5, 6, seed)
    st = lane_state_from_fields(fields, torch.float32, DEVICE)
    params = (torch.tensor(p["step"], dtype=torch.float32, device=DEVICE),
              torch.tensor(p["inv_mass"], dtype=torch.float32, device=DEVICE),
              torch.tensor(p["min_micro"], device=DEVICE))
    out = (torch.zeros((6, CHAINS, dim), device=DEVICE),
           torch.zeros((6, CHAINS), device=DEVICE),
           torch.zeros((6, CHAINS), dtype=torch.int32, device=DEVICE))
    return st, params, out


def _pass_bytes(before, after, out, dim: int, n_slots: int, cap: int) -> float:
    """Bytes one pass must move on this data: every lane's keys, replay
    counts and draw count; on pending lanes their scalars, the leaf's three
    rows, inv_mass, the stack slots of the merge cascade and the orbit
    endpoint of the top U-turn check, each read once; every row that
    changes (the stack push and the banked draw included) written once."""
    from walnuts_tpu_torch.ops import fused_pass as fp
    from walnuts_tpu_torch.ops.math import count_trailing_zeros

    pend = (before.draws_done < cap) & before.leaf_done
    leaf_ok = pend & before.leaf_ok
    merges = torch.clamp(count_trailing_zeros(before.leaf_idx + 1), max=n_slots)
    last = leaf_ok & (before.leaf_idx + 1 >= before.n_leaves)
    rows_read = (4 * pend.sum() + 2 * (merges * leaf_ok).sum() + 2 * last.sum())
    rows_written = sum(int((getattr(after, n) != getattr(before, n)).any(-1).sum())
                       for n in fp.ROW_RW)
    rows_written += int((after.stack_e != before.stack_e).any(-1).sum())
    rows_written += int((after.draws_done > before.draws_done).sum())
    scalars = 53 * before.draws_done.numel() + (68 + 80) * int(pend.sum())
    return 4.0 * dim * (int(rows_read) + rows_written) + scalars


def check_fused_pass(card: str, dim: int) -> dict:
    """One tier-2 pass, kernel against plain, at C = 4096 and width dim."""
    from walnuts_tpu_torch.ops import fused_pass as fp

    cap, R, max_depth = 5, 6, 5
    st_k, params, out_k = _pass_case(dim, SEED + dim)
    st_p, _, out_p = _pass_case(dim, SEED + dim)
    pristine, _, _ = _pass_case(dim, SEED + dim)
    fp.fused_pass(st_k, *params, cap, R, max_depth, out_k)
    fp.fused_pass_plain(st_p, *params, cap, R, max_depth, out_p)
    torch.cuda.synchronize()
    float_err = 0.0
    for name in fp.RW_FIELDS:
        k, p = fp.lane_field(st_k, name), fp.lane_field(st_p, name)
        if k.is_floating_point():
            both = torch.isfinite(k) & torch.isfinite(p)
            if not torch.equal(torch.isfinite(k), torch.isfinite(p)):
                raise AssertionError(f"fused pass: {name} finite on one side only")
            float_err = max(float_err, float((k - p)[both].abs().max()) if both.any() else 0.0)
        elif not torch.equal(k, p):
            bad = int((k != p).reshape(CHAINS, -1).any(-1).sum())
            raise AssertionError(f"fused pass: {name} differs on {bad} lanes")
    if not torch.equal(out_k[2], out_p[2]):
        raise AssertionError("fused pass: banked depths differ")
    float_err = max(float_err, float((out_k[0] - out_p[0]).abs().max()),
                    float((out_k[1] - out_p[1]).abs().max()))
    if float_err > 1e-3:
        raise AssertionError(f"fused pass: floats differ by {float_err}")

    work = [st_k, out_k]

    def reset():
        for n in fp.RW_FIELDS:
            fp.lane_field(work[0], n).copy_(fp.lane_field(pristine, n))
        for t in work[1]:
            t.zero_()

    def timed(fn, reps, lead):
        """(device ms, host ms) per call, each call on the pristine state."""
        total = host = 0.0
        for i in range(reps + 2):
            reset()
            torch.cuda.synchronize()
            if lead:
                torch.cuda._sleep(LEAD_CYCLES // 20)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            stop.record()
            torch.cuda.synchronize()
            if i >= 2:
                total += start.elapsed_time(stop)
                host += (t1 - t0) * 1e3
        return total / reps, host / reps

    ms, host_ms = timed(
        lambda: fp.fused_pass(st_k, *params, cap, R, max_depth, out_k), 30, True)
    plain_ms, _ = timed(lambda: fp.fused_pass_plain(st_k, *params, cap, R,
                                                    max_depth, out_k), 10, False)
    nbytes = _pass_bytes(pristine, st_p, out_p, dim, max_depth - 1, cap)
    bound_ms, bound_by = bound(nbytes, 0.0)
    pend = int(((pristine.draws_done < cap) & pristine.leaf_done).sum())
    print(f"[fused pass] D={dim}: kernel against plain at C={CHAINS} ({pend} "
          f"pending lanes): integers, flags and keys equal on every lane, "
          f"largest float difference {float_err:.3e}; kernel {ms:.4f} ms "
          f"(the wrapper's host cost {host_ms:.4f} ms a call), plain "
          f"{plain_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us "
          f"({nbytes / 1e6:.3f} MB, {bound_by}), {bound_ms / ms:.3f} of it  [{card}]")
    return dict(name="fused_pass", route="cuda",
                source="walnuts_tpu_torch/csrc/fused_pass.cu",
                replaces="walnuts_tpu/ops/fused_pass.py:172",
                max_abs_err=float_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# per body of the integrator: the model's factory, the scales of the
# synthetic attempt (synthetic_attempt_inputs), the tolerance against
# integrate_plain after up to 256 steps, and the float operations of one
# model evaluation beyond the leapfrog's 7 D. The simple bodies repeat the
# plain version's arithmetic (the library is built with -fmad=false) and
# differ by the order of their feature sums; the logistic-regression body
# sums its 1000-row products in another order than the plain version's
# matrix products, and rho and grad reach the hundreds.
INTEGRATOR_BODIES = {
    "std_normal": dict(dim=100, scales={}, tol=dict(rtol=1e-4, atol=1e-4),
                       ops=lambda d: 3 * d),
    "ill_conditioned_normal": dict(dim=100, scales={},
                                   tol=dict(rtol=1e-4, atol=1e-4),
                                   ops=lambda d: 4 * d),
    "funnel": dict(dim=101, scales=dict(theta_scale=0.5, dt_range=(0.01, 0.05)),
                   tol=dict(rtol=1e-4, atol=1e-4), ops=lambda d: 4 * d + 20),
    "logistic_regression": dict(
        dim=DIM, scales=dict(theta_scale=0.3, inv_mass_scale=0.005,
                             dt_range=(0.05, 0.2)),
        tol=dict(rtol=1e-3, atol=5e-3), ops=lambda d: 4 * ROWS * d),
}


def _integrator_model(body: str):
    from walnuts_tpu_torch.models import kernels

    dim = INTEGRATOR_BODIES[body]["dim"]
    if body == "std_normal":
        return kernels.std_normal_vg(dim)
    if body == "funnel":
        return kernels.funnel_vg(dim)
    if body == "ill_conditioned_normal":
        return kernels.ill_conditioned_normal_vg(dim, device=DEVICE)
    return kernels.logistic_regression_vg(ROWS, dim, device=DEVICE)


def check_integrator(card: str, body: str) -> dict:
    """One attempt of every chain, kernel against plain, at C = 4096 and
    the body's width: n_steps in 0..256 with a tenth of the lanes at 0,
    dt of both signs, per-chain inv_mass."""
    from walnuts_tpu_torch.ops import integrator as integ

    spec = INTEGRATOR_BODIES[body]
    model = _integrator_model(body)
    vg, dim, consts = model
    inp = integ.synthetic_attempt_inputs(CHAINS, dim, SEED + 3, **spec["scales"])
    args = integ.attempt_tensors(vg, inp, torch.float32, DEVICE)
    fused = integ.make_fused_integrator(model)
    cur_k, lp_k = fused(*args)
    torch.cuda.synchronize()
    cur_p, lp_p = integ.integrate_plain(vg, *args)
    torch.cuda.synchronize()
    if fused.launches != 1:
        raise AssertionError(f"integrator[{body}]: {fused.launches} launches for one call")
    zero = args[3] == 0
    if not (torch.equal(cur_k[zero], args[0][zero])
            and bool((lp_k[zero] == float("-inf")).all())):
        raise AssertionError(f"integrator[{body}]: zero-step lanes were changed")
    ck, cp, lk, lp_ = (t.cpu().numpy() for t in (cur_k, cur_p, lp_k[~zero], lp_p[~zero]))
    np.testing.assert_allclose(ck, cp, **spec["tol"])
    np.testing.assert_allclose(lk, lp_, **spec["tol"])
    err = float(max(np.abs(ck - cp).max(), np.abs(lk - lp_).max()))
    rel = float((np.abs(ck - cp).max(axis=(1, 2))
                 / np.maximum(np.abs(cp).max(axis=(1, 2)), 1.0)).max())
    ms = time_ms(lambda: fused(*args), reps=20, warmup=2)
    plain_ms = time_ms(lambda: integ.integrate_plain(vg, *args), reps=3, warmup=1,
                       lead=False)
    steps = int(inp["n_steps"].sum())
    # four (C, D) rows read, three written, dt, n_steps and lp per chain,
    # the constants once; per chain and step the leapfrog's 7 D operations
    # and the body's
    # (of logistic regression's constants the kernel reads x and y, not xt)
    read = consts[1:] if body == "logistic_regression" else consts
    nbytes = 4.0 * (7 * CHAINS * dim + 3 * CHAINS + sum(c.numel() for c in read))
    bound_ms, bound_by = bound(nbytes, float(steps) * (7 * dim + spec["ops"](dim)))
    print(f"[integrator] {body}, D={dim}: kernel within rtol "
          f"{spec['tol']['rtol']:g} atol {spec['tol']['atol']:g} of plain at "
          f"C={CHAINS}, n_steps in [0, 256] ({steps} chain steps, "
          f"{int(zero.sum())} zero-step lanes bitwise), dt of both signs: max "
          f"abs err {err:.3e}, max err relative to the chain's largest entry "
          f"{rel:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}), {bound_ms / ms:.4f} of it  [{card}]")
    return dict(name="integrator", route="cuda",
                source="walnuts_tpu_torch/csrc/integrator.cu",
                replaces="walnuts_tpu/ops/integrator.py:38",
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# per body of the transition kernels: the scales of the synthetic transition
# (synthetic_transition_inputs) at the width of INTEGRATOR_BODIES
TRANSITION_SCALES = {
    "std_normal": dict(step_range=(0.2, 0.8)),
    "ill_conditioned_normal": dict(step_range=(0.2, 0.8)),
    "funnel": dict(theta_scale=0.5, step_range=(0.05, 0.3)),
    "logistic_regression": dict(theta_scale=0.3, inv_mass_scale=0.005,
                                step_range=(0.3, 1.0)),
}
TRANSITION_TOL = dict(rtol=1e-3, atol=5e-3)


def _event_ms(fn) -> tuple:
    """``fn()``'s result and its milliseconds between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def check_transition(card: str, body: str) -> list:
    """One transition (5a) and a block of BLOCK_CHECK_DRAWS draws (5b) of
    every chain, kernel against plain, at C = 4096 and the body's width:
    depth and n_grads must be equal on at least 0.98 of the chains, and
    theta, grad and logp (5b: every draw too) within TRANSITION_TOL on
    those chains."""
    from walnuts_tpu_torch.ops import fused_transition as ft

    spec = INTEGRATOR_BODIES[body]
    model = _integrator_model(body)
    vg, dim, consts = model
    read = consts[1:] if body == "logistic_regression" else consts
    n_consts = sum(c.numel() for c in read)
    inp = ft.synthetic_transition_inputs(CHAINS, dim, SEED + 5,
                                         num_draws=BLOCK_CHECK_DRAWS,
                                         **TRANSITION_SCALES[body])
    t = ft.transition_tensors(vg, inp, DEVICE)
    tail = (t["step"], t["inv_mass"], t["min_micro"], MAX_ERROR)
    static = dict(max_depth=MAX_DEPTH, max_step_halvings=HALVINGS)
    results = []
    for name, n in (("fused_transition", 1), ("fused_sample_block", BLOCK_CHECK_DRAWS)):
        attempts = torch.zeros(CHAINS, dtype=torch.int32, device=DEVICE)
        if n == 1:
            fused = ft.make_fused_transition(model, dim, MAX_DEPTH, HALVINGS)
            args = (SEED, t["theta"], t["rho"][0].contiguous(), t["logp0"],
                    t["grad0"], *tail)
            plain = lambda: ft.fused_transition_plain(vg, *args, attempts=attempts,
                                                      **static)
            ints, floats, replaces = (3, 4), (0, 1, 2), 441
        else:
            fused = ft.make_fused_sample_block(model, dim, MAX_DEPTH, HALVINGS, n)
            args = (SEED, t["theta"], t["logp0"], t["grad0"], t["rho"], *tail)
            plain = lambda: ft.fused_sample_block_plain(vg, *args, attempts=attempts,
                                                        **static)
            ints, floats, replaces = (5,), (0, 1, 2, 3, 4), 555
        got = fused(*args)
        torch.cuda.synchronize()
        if fused.launches != 1:
            raise AssertionError(f"{name}[{body}]: {fused.launches} launches for one call")
        want, plain_ms = _event_ms(plain)
        same = torch.ones(CHAINS, dtype=torch.bool, device=DEVICE)
        for i in ints:
            same &= got[i] == want[i]
        share = float(same.float().mean())
        if share < 0.98:
            raise AssertionError(f"{name}[{body}]: depth and n_grads agree on "
                                 f"{share:.4f} of the chains only")
        err = 0.0
        for i in floats:
            # the chain axis is the last but the feature axis
            g, w = (x[i].movedim(1, 0) if n > 1 and i < 2 else x[i] for x in (got, want))
            g, w = g[same].cpu().numpy(), w[same].cpu().numpy()
            np.testing.assert_allclose(g, w, **TRANSITION_TOL)
            err = max(err, float(np.abs(g - w).max()))
        ms = time_ms(lambda: fused(*args), reps=5 if n == 1 else 3, warmup=1)
        n_grads = want[ints[-1]].to(torch.int64)
        evals = int(n_grads.sum()) - (CHAINS if n == 1 else 0)  # 5a counts the start
        # operands and outputs once: theta, grad0, inv_mass in, theta, grad
        # out, rho in and draws out per draw; logp0, step, min_micro and
        # three lane outputs (and logps per draw); the body's constants.
        # Operations: every evaluation's leapfrog and model body, and per
        # attempt max_depth + 2 U-turn / combine passes over a span's 8 D
        nbytes = 4.0 * (CHAINS * dim * (5 + (2 * n if n > 1 else 1))
                        + CHAINS * (6 + (n if n > 1 else 0)) + n_consts)
        ops = (float(evals) * (7 * dim + spec["ops"](dim))
               + float(attempts.sum()) * (MAX_DEPTH + 2) * 8 * dim)
        bound_ms, bound_by = bound(nbytes, ops)
        print(f"[transition] {name}, {body}, D={dim}"
              f"{'' if n == 1 else f', {n} draws'}: kernel against plain at "
              f"C={CHAINS}, max_depth {MAX_DEPTH}, max_step_halvings {HALVINGS}: "
              f"depth and n_grads equal on {share:.4f} of the chains, on those "
              f"theta, grad, logp within rtol {TRANSITION_TOL['rtol']:g} atol "
              f"{TRANSITION_TOL['atol']:g} (max abs err {err:.3e}); {evals} "
              f"evaluations in {int(attempts.sum())} attempts, largest per-chain "
              f"n_grads {int(n_grads.max())}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.1f} ms; bound {bound_ms * 1e3:.3f} us ({bound_by}), "
              f"{bound_ms / ms:.4f} of it  [{card}]")
        results.append(dict(
            name=name, route="cuda",
            source="walnuts_tpu_torch/csrc/fused_transition.cu",
            replaces=f"walnuts_tpu/ops/fused_transition.py:{replaces}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None))
    return results


def laplace(design: np.ndarray, y: np.ndarray):
    """Reference moments of the logistic-regression posterior (standard
    normal prior), in float64 NumPy: the Newton MAP, the Laplace sd
    sqrt(diag(H^-1)), and the posterior mean by importance sampling from
    the Laplace approximation (200k proposals). On this data the posterior
    mean sits up to ~0.36 Laplace sd from the MAP (skewness), more than
    the 0.15 sd the check allows, so the mean is held to the reweighted
    mean and the MAP is only reported."""
    beta = np.zeros(design.shape[1])
    for _ in range(100):
        z = y * (design @ beta)
        s = 1.0 / (1.0 + np.exp(z))  # sigmoid(-z)
        grad = design.T @ (y * s) - beta
        w = s * (1.0 - s)
        hess = design.T @ (design * w[:, None]) + np.eye(design.shape[1])
        step = np.linalg.solve(hess, grad)
        beta = beta + step
        if np.abs(step).max() < 1e-12:
            break
    cov = np.linalg.inv(hess)
    chol = np.linalg.cholesky(cov)
    eps = np.random.default_rng(SEED).standard_normal((200_000, design.shape[1]))
    theta = beta + eps @ chol.T
    log_w = np.empty(len(theta))
    for i in range(0, len(theta), 10_000):  # bounded (10k, N) temporaries
        t = theta[i:i + 10_000]
        z = y * (t @ design.T)
        log_w[i:i + 10_000] = (
            -(np.maximum(-z, 0.0) + np.log1p(np.exp(-np.abs(z)))).sum(1)
            - 0.5 * (t * t).sum(1) + 0.5 * (eps[i:i + 10_000] ** 2).sum(1))
    w = np.exp(log_w - log_w.max())
    w /= w.sum()
    return beta, np.sqrt(np.diag(cov)), w @ theta


def check_posterior(draws: np.ndarray, what: str, card: str, ref) -> None:
    """``draws`` (R, C, D): finite, and pooled moments within the limits."""
    if draws.shape[1:] != (CHAINS, DIM) or not np.isfinite(draws).all():
        raise AssertionError(f"{what}: bad draws: shape {draws.shape}, "
                             f"finite {np.isfinite(draws).all()}")
    mode, sd, post_mean = ref
    pooled = draws.reshape(-1, DIM).astype(np.float64)
    z_mean = np.abs(pooled.mean(0) - post_mean) / sd
    z_map = np.abs(pooled.mean(0) - mode) / sd
    sd_ratio = pooled.std(0) / sd
    print(f"[posterior] {what}: pooled mean vs reweighted Laplace mean: max "
          f"|diff| / laplace sd = {z_mean.max():.4f} (limit 0.15); vs Newton "
          f"MAP {z_map.max():.4f} (reported only); pooled sd / laplace sd in "
          f"[{sd_ratio.min():.4f}, {sd_ratio.max():.4f}] (limit 20 %)  [{card}]")
    if z_mean.max() > 0.15 or np.abs(sd_ratio - 1.0).max() > 0.2:
        raise AssertionError(f"{what}: posterior disagrees with the Laplace approximation")


def _reset_counts() -> None:
    from walnuts_tpu_torch.ops import fused_pass, prng
    from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad

    prng.replay_split_chain.launches = 0
    logreg_value_grad.launches = 0
    fused_pass.fused_pass.launches = 0


def _counts() -> dict:
    from walnuts_tpu_torch.ops import fused_pass, prng
    from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad

    return {"replay_split_chain": prng.replay_split_chain.launches,
            "logreg_value_grad": logreg_value_grad.launches,
            "fused_pass": fused_pass.fused_pass.launches}


def run_main_path(card: str, ref) -> dict:
    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out, info = wtt.walnuts(
        logp_grad, fused=True, num_params=dim, num_chains=CHAINS,
        dtype=torch.float32, seed=SEED, device=DEVICE,
        min_warmup_iter=MAIN_ITERS, max_warmup_iter=MAIN_ITERS,
        min_sampling_iter=MAIN_ITERS, max_sampling_iter=MAIN_ITERS,
        block_size=50, return_info=True, max_step_halvings=HALVINGS,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("replay_split_chain", "logreg_value_grad"):
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")

    draws = np.stack([np.asarray(c) for c in out], axis=1)  # (R, C, D)
    if draws.shape[0] != MAIN_ITERS:
        raise AssertionError(f"main path: {draws.shape[0]} draws, not {MAIN_ITERS}")
    check_posterior(draws, "main path", card, ref)

    from walnuts_tpu_torch import summary

    per_chain = list(np.moveaxis(draws, 1, 0))
    ess = summary.ess(per_chain)
    rhat = summary.r_hat(per_chain)
    w_s, s_s = info.seconds["warmup"], info.seconds["sampling"]
    n_grads = float(np.sum(info.n_grads))
    print(f"[main path] logreg({DIM}) x {CHAINS} chains, fused, float32, "
          f"{MAIN_ITERS} + {MAIN_ITERS} iterations, block 50, "
          f"max_step_halvings {HALVINGS}  [{card}]")
    print(f"[main path] wall {wall:.3f} s: warmup {w_s:.3f} s, sampling "
          f"{s_s:.3f} s  [{card}]")
    print(f"[main path] gradients used {n_grads:.0f}, {n_grads / (w_s + s_s):.1f} "
          f"per s over warmup + sampling  [{card}]")
    print(f"[main path] median ESS {np.median(ess):.1f}, min ESS {ess.min():.1f}; "
          f"median ESS per sampling s {np.median(ess) / s_s:.1f}; max R-hat "
          f"{rhat.max():.4f}  [{card}]")
    for phase in ("warmup", "sampling"):
        nb = info.n_blocks[phase]
        print(f"[main path] {phase}: {nb} blocks, {info.n_inner_trips[phase]} "
              f"trips, {info.n_outer_trips[phase]} tier-2 passes, "
              f"{info.n_syncs[phase]} syncs ({info.n_syncs[phase] / nb:.1f} "
              f"per block)  [{card}]")
    print(f"[main path] peak device memory {peak / 2**20:.1f} MiB  [{card}]")
    print(f"[main path] launches on the main path: {json.dumps(launches)}  [{card}]")
    return launches


def _start_state(logp_grad, dim: int, seed: int, wcfg, scfg):
    """The warmup state ``walnuts()`` makes for ``seed`` (api.py)."""
    from walnuts_tpu_torch.core.adapt import nutpie_init_mass
    from walnuts_tpu_torch.core.sampler import init_warmup_state
    from walnuts_tpu_torch.ops import prng
    from walnuts_tpu_torch.ops.math import adapt_step_size

    base = prng.key(seed, DEVICE)
    ids = torch.arange(CHAINS, device=DEVICE)
    theta0 = 2.0 * prng.normal(prng.fold_in(base, 0xFFFFFFFF), (CHAINS, dim),
                               torch.float32)
    mass = nutpie_init_mass(logp_grad(theta0)[1],
                            torch.tensor(1e-5, device=DEVICE))
    step0 = adapt_step_size(prng.fold_in(base, ids + CHAINS), logp_grad, theta0,
                            mass, torch.ones(CHAINS, device=DEVICE))
    return init_warmup_state(prng.fold_in(base, ids), theta0, mass, step0,
                             wcfg, scfg)


def run_fused_route(card: str, ref, warmup: int = 50,
                    order=("unfused", "fused")) -> tuple:
    """Warmup once, then sampling with the unfused and the fused tier-2
    pass from the same warmed state, in ``order``. Returns the fused run's
    launches and the warmed state."""
    from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
    from walnuts_tpu_torch.core.sampler import freeze_params, init_sample_state
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused
    from walnuts_tpu_torch.parallel.runtime import run_sampling, run_warmup

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    wcfg = WarmupConfig(min_iter=warmup, max_iter=warmup, block_size=50)
    scfg = SamplingConfig(min_iter=ROUTE_ITERS, max_iter=ROUTE_ITERS,
                          block_size=50, max_step_halvings=HALVINGS)
    ws = _start_state(logp_grad, dim, SEED + 1, wcfg, scfg)
    t0 = time.perf_counter()
    ws, _, _, winfo = run_warmup(logp_grad, ws, wcfg, scfg, tier2_every=12)
    print(f"[fused route] run_warmup {warmup} iterations: "
          f"{time.perf_counter() - t0:.3f} s  [{card}]")
    params, ss = freeze_params(ws), init_sample_state(ws)

    routes = {}
    for name in order:
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        _, d, _, info = run_sampling(logp_grad, ss, params, scfg,
                                     pallas_pass=name == "fused")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
        routes[name] = (d.cpu().numpy(), launches)
        print(f"[fused route] {ROUTE_ITERS} sampling iterations, {name} pass: "
              f"wall {wall:.3f} s, "
              f"{info.n_inner_trips['sampling']} trips, "
              f"{info.n_outer_trips['sampling']} tier-2 passes, "
              f"{info.n_syncs['sampling']} syncs; launches {json.dumps(launches)}"
              f"  [{card}]")
    launches = routes["fused"][1]
    if launches["fused_pass"] <= 0:
        raise AssertionError("the fused route never launched fused_pass")
    if launches["replay_split_chain"] != 0:
        raise AssertionError("the fused route launched the separate replay")
    d_u, d_f = routes["unfused"][0], routes["fused"][0]
    same = np.all(d_u == d_f, axis=-1)
    print(f"[fused route] draws bitwise equal between the routes: "
          f"{same.mean():.4f} of {same.size}; largest difference "
          f"{np.abs(d_u - d_f).max():.3e} (reported only)  [{card}]")
    check_posterior(d_f, "fused route", card, ref)
    return launches, ws


def run_classic_path(card: str, ref) -> int:
    """``walnuts(batched=False, integrator=...)`` with the fused integrator;
    returns the integrator's launches on that run."""
    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.models.kernels import logistic_regression_vg
    from walnuts_tpu_torch.ops.integrator import make_fused_integrator
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    fused = make_fused_integrator(logistic_regression_vg(ROWS, DIM, device=DEVICE))
    n = CLASSIC_ITERS
    torch.cuda.synchronize()
    _reset_counts()
    fused.launches = 0
    t0 = time.perf_counter()
    out, info = wtt.walnuts(
        logp_grad, fused=True, batched=False, integrator=fused, num_params=dim,
        num_chains=CHAINS, dtype=torch.float32, seed=SEED + 2, device=DEVICE,
        min_warmup_iter=n, max_warmup_iter=n, min_sampling_iter=n,
        max_sampling_iter=n, block_size=50, return_info=True,
        max_step_halvings=HALVINGS,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.launches
    attempts = sum(info.n_outer_trips.values())
    if launches <= 0 or launches != attempts:
        raise AssertionError(f"classic path: {launches} integrator launches "
                             f"for {attempts} attempts")
    draws = np.stack([np.asarray(c) for c in out], axis=1)  # (R, C, D)
    if draws.shape[0] != n:
        raise AssertionError(f"classic path: {draws.shape[0]} draws, not {n}")
    check_posterior(draws, "classic path", card, ref)
    w_s, s_s = info.seconds["warmup"], info.seconds["sampling"]
    n_grads = float(np.sum(info.n_grads))
    print(f"[classic path] logreg({DIM}) x {CHAINS} chains, walnuts(batched=False, "
          f"integrator=fused), float32, {n} + {n} iterations, block 50, "
          f"max_step_halvings {HALVINGS}  [{card}]")
    print(f"[classic path] wall {wall:.3f} s: warmup {w_s:.3f} s, sampling "
          f"{s_s:.3f} s  [{card}]")
    for phase, sec in (("warmup", w_s), ("sampling", s_s)):
        a = info.n_outer_trips[phase]
        print(f"[classic path] {phase}: {a} attempts ({a / n:.1f} per "
              f"iteration), {info.n_inner_trips[phase]} integrator calls, "
              f"{info.n_syncs[phase]} syncs, {sec / a * 1e3:.3f} ms per "
              f"attempt  [{card}]")
    print(f"[classic path] gradients used {n_grads:.0f}, "
          f"{n_grads / (w_s + s_s):.1f} per s over warmup + sampling; integrator "
          f"launches {launches}; other launches {json.dumps(_counts())}  [{card}]")
    return launches


def count_attempt_ops(card: str, logp_grad, fused, params, ss) -> None:
    """Operations PyTorch dispatches for one attempt of the classic
    sampling body and for the select on ``done`` that follows it (each is
    one small launch on the card, bar a few views)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from walnuts_tpu_torch.core.adapt import adam_init, tree_where
    from walnuts_tpu_torch.core.transition import make_transition_parts

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    init_state, body = make_transition_parts(logp_grad, 5, HALVINGS, False, fused)
    lp, grad = logp_grad(ss.theta)
    s = init_state(ss.key, ss.theta, lp, grad, params.step_size, params.inv_mass,
                   params.min_micro, adam_init(params.step_size),
                   torch.ones_like(params.min_micro))
    max_error = torch.tensor(0.5, device=DEVICE)
    with Count():
        new = body(s, params.step_size, params.inv_mass, params.min_micro, max_error)
    n_body, Count.n = Count.n, 0
    with Count():
        tree_where(s.done, s, new)
    print(f"[classic A/B] one attempt of the sampling body dispatches {n_body} "
          f"operations (the integrator's launch among them), the select on "
          f"done {Count.n} more  [{card}]")


def run_classic_ab(card: str, ws) -> tuple:
    """20 classic sampling iterations from the warmed state ``ws`` (the
    fused route's), with the kernel and with the plain integrator of the
    same value-and-gradient. Returns the kernel route's wall seconds and
    gradients."""
    from walnuts_tpu_torch.config import SamplingConfig
    from walnuts_tpu_torch.core.sampler import freeze_params, init_sample_state
    from walnuts_tpu_torch.models.kernels import logistic_regression_vg
    from walnuts_tpu_torch.ops.integrator import (
        make_fused_integrator,
        make_plain_integrator,
    )
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    model = logistic_regression_vg(ROWS, DIM, device=DEVICE)
    fused = make_fused_integrator(model)
    scfg = SamplingConfig(min_iter=20, max_iter=20, block_size=20,
                          max_step_halvings=HALVINGS)
    params, ss = freeze_params(ws), init_sample_state(ws)
    count_attempt_ops(card, logp_grad, fused, params, ss)
    runs = {}
    for name, integrator in (("kernel", fused),
                             ("plain", make_plain_integrator(model[0]))):
        torch.cuda.synchronize()
        fused.launches = 0
        t0 = time.perf_counter()
        st, d, _, info = run_sampling(logp_grad, ss, params, scfg, batched=False,
                                      integrator=integrator)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = (st.key.cpu().numpy(), info.n_grads, d.cpu().numpy(), wall)
        print(f"[classic A/B] 20 sampling iterations, {name} integrator: wall "
              f"{wall:.3f} s, {info.n_outer_trips['sampling']} attempts, "
              f"{info.n_syncs['sampling']} syncs of the attempt loop (the plain "
              f"integrator reads one trip count more per attempt), kernel "
              f"launches {fused.launches}  [{card}]")
    (k_k, g_k, d_k, wall_k), (k_p, g_p, d_p, _) = runs["kernel"], runs["plain"]
    if not np.isfinite(d_k).all():
        raise AssertionError("classic A/B: the kernel route's draws are not finite")
    same_key = np.all(k_k == k_p, axis=-1)
    same_grads = g_k == g_p
    same_draws = np.isclose(d_k, d_p, rtol=1e-3, atol=1e-3).all(axis=(0, 2))
    print(f"[classic A/B] chains that agree after 20 iterations: final keys "
          f"(every attempt's split) {same_key.mean():.4f}, n_grads "
          f"{same_grads.mean():.4f}, all draws within rtol 1e-3 atol 1e-3 "
          f"{same_draws.mean():.4f}, all three "
          f"{(same_key & same_grads & same_draws).mean():.4f} of {CHAINS} "
          f"(reported only)  [{card}]")
    # info.n_grads goes on from the warmed state's counts
    return wall_k, float(np.sum(g_k)) - float(ss.n_grads.sum())


def _momenta(key, shape, inv_mass):
    """Momenta ~ N(0, M): standard normals over sqrt(inv_mass)."""
    from walnuts_tpu_torch.ops import prng

    return (prng.normal(key, shape, torch.float32) / torch.sqrt(inv_mass)).contiguous()


def _transition_setup(ws):
    """The model of the transition kernels, the logistic-regression kernel's
    operands, and the warmed state's frozen tuning as the kernels' trailing
    arguments ``(step, inv_mass, min_micro, max_error)``."""
    from walnuts_tpu_torch.core.sampler import freeze_params
    from walnuts_tpu_torch.models.kernels import logistic_regression_vg

    model = logistic_regression_vg(ROWS, DIM, device=DEVICE)
    params = freeze_params(ws)
    tail = (params.step_size.contiguous(), params.inv_mass.contiguous(),
            params.min_micro.contiguous(), MAX_ERROR)
    return model, (model[2][1], model[2][2][0].contiguous()), tail


def _single_draws(one, n: int, seed0: int, key, theta, xy, tail) -> dict:
    """``n`` draws of every chain from ``theta`` through the
    single-transition kernel ``one``: per draw the momenta, the start
    point's value and gradient (the logistic-regression kernel) and one
    launch, with no host sync from the first draw to the last (the sync
    debug mode raises on one). Returns the draws, per-chain gradients and
    depth sums, each launch's milliseconds between two events, and the
    seconds to enqueue and to finish."""
    from walnuts_tpu_torch.ops import prng
    from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad

    keys = prng.fold_in(key, torch.arange(n, device=DEVICE))
    draws = torch.empty((n, CHAINS, DIM), device=DEVICE)
    n_grads = torch.zeros(CHAINS, dtype=torch.int64, device=DEVICE)
    depth_sum = torch.zeros(CHAINS, dtype=torch.int64, device=DEVICE)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * n)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    for i in range(n):
        rho = _momenta(keys[i], (CHAINS, DIM), tail[1])
        lp0, g0 = logreg_value_grad(theta, *xy)
        marks[2 * i].record()
        theta, _, _, depth, ng = one(seed0 + i, theta, rho, lp0, g0, *tail)
        marks[2 * i + 1].record()
        draws[i] = theta
        n_grads += ng
        depth_sum += depth
    enqueued = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return dict(draws=draws, n_grads=n_grads, depth_sum=depth_sum,
                kernel_ms=[a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])],
                enqueued=enqueued, wall=time.perf_counter() - t0)


def run_transition_path(card: str, ref, ws) -> dict:
    """Sampling from the warmed state ``ws`` through the whole-transition
    kernels; returns their launches on that run."""
    from walnuts_tpu_torch.ops import fused_transition as ft
    from walnuts_tpu_torch.ops import prng
    from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad

    model, xy, tail = _transition_setup(ws)
    base = prng.key(SEED + 3, DEVICE)
    one = ft.make_fused_transition(model, DIM, MAX_DEPTH, HALVINGS)
    block = ft.make_fused_sample_block(model, DIM, MAX_DEPTH, HALVINGS, BLOCK_DRAWS)
    # load the library and the body's constants outside the timed loops
    lp0, g0 = logreg_value_grad(ws.theta, *xy)
    one(0, ws.theta, _momenta(base, (CHAINS, DIM), tail[1]), lp0, g0, *tail)

    # one launch per draw
    _reset_counts()
    one.launches = block.launches = 0
    r = _single_draws(one, TRANSITION_DRAWS, 100, base, ws.theta, xy, tail)
    if one.launches != TRANSITION_DRAWS:
        raise AssertionError(f"transition path: {one.launches} launches of the "
                             f"single-transition kernel for {TRANSITION_DRAWS} draws")
    total, wall = float(r["n_grads"].sum()), r["wall"]
    print(f"[transition path] logreg({DIM}) x {CHAINS} chains from the fused "
          f"route's warmed state, max_depth {MAX_DEPTH}, max_step_halvings "
          f"{HALVINGS}, max_error {MAX_ERROR}  [{card}]")
    print(f"[transition path] 5a, {TRANSITION_DRAWS} draws, one launch each: wall "
          f"{wall:.3f} s ({r['enqueued']:.3f} s to enqueue), "
          f"{wall / TRANSITION_DRAWS * 1e3:.3f} ms per draw, of which the kernel "
          f"{np.mean(r['kernel_ms']):.3f} ms (events around each launch; largest "
          f"{max(r['kernel_ms']):.3f}), 0 host syncs in the loop (sync debug mode "
          f"raises on one), {total:.0f} gradients, {total / wall:.1f} per s, mean "
          f"depth {float(r['depth_sum'].sum()) / (CHAINS * TRANSITION_DRAWS):.3f}, "
          f"largest per-chain n_grads over the run {int(r['n_grads'].max())}  [{card}]")
    check_posterior(r["draws"].cpu().numpy(), "transition path, 5a", card, ref)

    # one launch per BLOCK_DRAWS draws; each launch's final state must be
    # the model's at its final point, and its last draw that point
    def consistent(theta, lp_f, g_f):
        lp0, g0 = logreg_value_grad(theta, *xy)
        if lp_f is not None:
            np.testing.assert_allclose(lp_f.cpu().numpy(), lp0.cpu().numpy(), rtol=1e-3)
            np.testing.assert_allclose(g_f.cpu().numpy(), g0.cpu().numpy(),
                                       rtol=1e-3, atol=5e-3)
        return lp0, g0

    theta, lp_f, g_f = ws.theta, None, None
    blocks = []
    for j in range(BLOCK_LAUNCHES):
        rho = _momenta(prng.fold_in(base, 1000 + j), (BLOCK_DRAWS, CHAINS, DIM),
                       tail[1][None])
        lp0, g0 = consistent(theta, lp_f, g_f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, _, theta, g_f, lp_f, ng = block(17 + j, theta, lp0, g0, rho, *tail)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not torch.equal(d[-1], theta):
            raise AssertionError("transition path: the block's last draw is not "
                                 "its final point")
        blocks.append(d.cpu().numpy())
        total = float(ng.sum())
        print(f"[transition path] 5b, launch {j} of {BLOCK_DRAWS} draws (seed "
              f"{17 + j}; momenta and start point made before): wall {wall:.3f} s, "
              f"{total:.0f} gradients, {total / wall:.1f} per s, "
              f"{total / (CHAINS * BLOCK_DRAWS):.3f} per chain and draw, largest "
              f"per-chain n_grads {int(ng.max())}  [{card}]")
    consistent(theta, lp_f, g_f)
    if block.launches != BLOCK_LAUNCHES:
        raise AssertionError(f"transition path: {block.launches} launches of the "
                             f"sample-block kernel, not {BLOCK_LAUNCHES}")
    launches = {"fused_transition": one.launches, "fused_sample_block": block.launches,
                "logreg_value_grad": _counts()["logreg_value_grad"]}
    print(f"[transition path] final state of every 5b launch: logp and grad "
          f"within rtol 1e-3 (grad atol 5e-3) of the logistic-regression "
          f"kernel at the final point, last draw bitwise the final point; "
          f"launches {json.dumps(launches)}  [{card}]")
    check_posterior(np.concatenate(blocks), "transition path, 5b", card, ref)
    return launches


def run_transition_ab(card: str, ws, classic: tuple) -> None:
    """AB_DRAWS draws from the warmed state ``ws`` through each
    whole-transition kernel, beside the classic path's wall and gradients
    for as many iterations from the same state (``run_classic_ab``)."""
    from walnuts_tpu_torch.ops import fused_transition as ft
    from walnuts_tpu_torch.ops import prng
    from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad

    model, xy, tail = _transition_setup(ws)
    base = prng.key(SEED + 4, DEVICE)
    one = ft.make_fused_transition(model, DIM, MAX_DEPTH, HALVINGS)
    block = ft.make_fused_sample_block(model, DIM, MAX_DEPTH, HALVINGS, AB_DRAWS)
    r = _single_draws(one, AB_DRAWS, 200, base, ws.theta, xy, tail)
    wall_a, grads_a = r["wall"], float(r["n_grads"].sum())

    t0 = time.perf_counter()
    rho = _momenta(prng.fold_in(base, 1000), (AB_DRAWS, CHAINS, DIM), tail[1][None])
    lp0, g0 = logreg_value_grad(ws.theta, *xy)
    d, _, _, _, _, ng = block(300, ws.theta, lp0, g0, rho, *tail)
    torch.cuda.synchronize()
    wall_b, grads_b = time.perf_counter() - t0, float(ng.sum())
    if not (torch.isfinite(r["draws"]).all() and torch.isfinite(d).all()):
        raise AssertionError("transition A/B: draws are not finite")
    wall_c, grads_c = classic
    print(f"[transition A/B] {AB_DRAWS} sampling iterations from one warmed state, "
          f"momenta included: classic path with the integrator kernel: wall "
          f"{wall_c:.3f} s, {grads_c:.0f} gradients, {grads_c / wall_c:.1f} per s | "
          f"5a, one launch per draw: wall {wall_a:.3f} s, {grads_a:.0f} gradients, "
          f"{grads_a / wall_a:.1f} per s | 5b, one launch: wall {wall_b:.3f} s, "
          f"{grads_b:.0f} gradients (a draw's first evaluation not counted), "
          f"{grads_b / wall_b:.1f} per s  [{card}]")


def profile_window(card: str) -> None:
    """Device time by kernel over a short run (10 + 10 iterations)."""
    import walnuts_tpu_torch as wtt
    from torch.profiler import ProfilerActivity, profile

    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device="cuda")
    kw = dict(fused=True, num_params=dim, num_chains=CHAINS, dtype=torch.float32,
              seed=SEED + 7, device="cuda", min_warmup_iter=10,
              max_warmup_iter=10, min_sampling_iter=10, max_sampling_iter=10,
              block_size=10, max_step_halvings=HALVINGS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        wtt.walnuts(logp_grad, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_time_total > 0]
    busy_us = sum(r[1] for r in rows if not r[0].startswith("aten::")
                  and not r[0].startswith("cuda"))
    kernels = sorted((r for r in rows if not r[0].startswith("aten::")),
                     key=lambda r: -r[1])
    print(f"[profile] 10 + 10 iterations, wall {wall:.3f} s (profiled), device "
          f"kernel time {busy_us / 1e6:.3f} s, busy share "
          f"{busy_us / 1e6 / wall:.3f}  [{card}]")
    for key, us, count in kernels[:12]:
        print(f"[profile]   {us / 1e3:10.2f} ms  {count:7d}x  {key[:90]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler window and print kernel times")
    parser.add_argument("--ab", action="store_true",
                        help="sample the fused route's warmed state four times, "
                        "unfused, fused, fused, unfused")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    card = card_label()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    from walnuts_tpu_torch.models.targets import logistic_regression_data
    from walnuts_tpu_torch.ops import _cuda

    names = ("replay", "logreg", "fused_pass", "integrator", "fused_transition")
    t0 = time.perf_counter()
    _cuda.build(*names)
    print(f"[build] {len(names)} libraries, one nvcc each in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        _cuda.library(name)
        b = _cuda.BUILD_INFO[name]
        print(f"[build] {name}: {b['seconds']:.2f} s -> {b['path']}")
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    kernels = [check_replay(card), check_logreg(card), check_fused_pass(card, DIM)]
    check_fused_pass(card, 101)
    for body in ("std_normal", "ill_conditioned_normal", "funnel"):
        check_integrator(card, body)
    kernels.append(check_integrator(card, "logistic_regression"))
    for body in ("std_normal", "ill_conditioned_normal", "funnel"):
        check_transition(card, body)
    kernels.extend(check_transition(card, "logistic_regression"))
    ref = laplace(*logistic_regression_data(ROWS, DIM))
    launches = run_main_path(card, ref)
    order = ("unfused", "fused", "fused", "unfused") if args.ab else ("unfused", "fused")
    route_launches, warmed = run_fused_route(card, ref, order=order)
    launches["fused_pass"] = route_launches["fused_pass"]
    launches["integrator"] = run_classic_path(card, ref)
    classic = run_classic_ab(card, warmed)
    path_launches = run_transition_path(card, ref, warmed)
    launches.update({k: path_launches[k]
                     for k in ("fused_transition", "fused_sample_block")})
    run_transition_ab(card, warmed, classic)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if args.profile:
        profile_window(card)
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s in all  [{card}]")
    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for k in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
