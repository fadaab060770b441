"""Chip smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version at the main path's shapes, then drives seven paths of the port on
adaptive WALNUTS: five on the 25-coefficient logistic regression (1000
rows) with the fused model kernel, 4096 chains, float32, two on the
bench's other models, then the checkpoint, host-model, trace and
command-line entry points (each phase's wall is printed):

- the main path, ``walnuts_tpu_torch.walnuts`` (batched scheduler, 30
  warmup + 30 sampling iterations): the replay and logistic-regression
  kernels must run on it;
- the fused route: ``run_warmup`` (50 iterations), then ``run_sampling``
  (25 iterations) twice from the same warmed state, with the unfused
  tier-2 pass and with ``pallas_pass=True``: the fused-pass kernel must
  run on the second;
- the classic path: ``walnuts(batched=False, integrator=...)`` (20 + 20
  iterations) with the fused leapfrog integrator, which must launch once
  per attempt; then 20 classic sampling iterations from the fused route's
  warmed state with the kernel and with the plain integrator, for an A/B;
- the options path, from the same warmed state: ``run_sampling`` of 10
  iterations in blocks of 5 once per scheduler option and runtime keyword,
  each bit for bit its reference route: the batched runs (kernels 1 and 2;
  ``min_latched``, ``defer_splits=False``, ``pallas_replay``,
  ``fresh_cur``, ``bounded_sweeps``, ``device_draws=False`` (draws on the
  host), a ``block_budget`` that caps the blocks) against the default
  batched run, the classic runs with kernel 3 (``flatten``,
  ``chain_groups=4``; off the card the latter to rtol and atol 1e-5)
  against the classic run, and the batched ``bf16_ends`` run against the classic one
  (kernel 3 evaluating the model in both); before them the card's
  bfloat16 rounding against the CPU's on 10^6 values;
- the transition path, from the same warmed state (its step sizes, inverse
  masses and ``min_micro``): 50 draws through ``make_fused_transition``
  (momenta, the logistic-regression kernel for the start point, one launch
  per draw, no host sync in the loop), then 4 launches of 100 draws
  through ``make_fused_sample_block``; then 20 draws of each beside the
  classic A/B's 20 iterations;
- the funnel path: ``walnuts()`` on funnel(101) x 4096, float32, in 4
  cost-sorted groups (``batched_groups=4``, run-ahead 4, a tier-2 pass every
  6 trips; 6 + 5 iterations, blocks of 5): the replay must run on it,
  and theta[0]'s pooled moments must agree with the JAX package's at the
  same configuration (``FUNNEL_REF``);
- the SV path: ``walnuts()`` on the stochastic-volatility model (D = 1003)
  x 1024, float32 (run-ahead 8, a tier-2 pass every 12 trips, block 50;
  15 + 3 iterations), then 6 sampling iterations twice from its warmed
  state, with the unfused pass and with ``pallas_pass=True``: the replay
  must run on the first, the fused pass on the second, their draws must be
  bitwise equal, and the device ESS of the draw tensor (on the card,
  ``summary_device``) must agree with the host estimator's;
- the checkpoint path: ``walnuts()`` on the logistic regression x 4096
  (kernel 2), 10 + 10 iterations in blocks of 5, three times: with no
  checkpoint, with ``checkpoint_dir`` and crashed after its first sampling
  block, and resumed: the resumed run's draws, step sizes, inverse metrics
  and ``n_grads`` must be the first run's bit for bit, and kernels 1 and 2
  must run;
- the mesh path: the checkpoint path's first run again with
  ``walnuts(mesh=...)``, its chains sharded over a
  ``DeviceMesh`` named ``"chains"``: as two gloo ranks sharing the card
  (2048 chains each, each rank a process of this script, run with the
  hidden ``--mesh-rank`` options) and as one NCCL rank in this process;
  every rank must return that run's result bit for bit and launch
  kernels 1 and 2;
- the host-model path: ``walnuts_stan`` on the eight-schools BridgeStan-ABI
  model (``csrc/abi_models.cpp``, built with ``g++`` with the port's native
  bridge) x 1024, float64, 15 + 15, against ``walnuts(eight_schools())``
  at the same seed (0.99 of the chains with equal ``n_grads``, ``mu`` to
  1e-3 on those), and ``walnuts_pyfunc`` with the C callback of
  ``csrc/callback_model.c`` (a standard normal, D = 100) x 256: kernel 1
  must run on both, and the host time of a model call is printed beside
  the trip's;
- ``walnuts(profile_dir=...)`` on the logistic regression (1 + 1): the trace
  must name the replay and logistic-regression kernels; beside it ``python
  -m walnuts_tpu_torch.cli`` on funnel(25) x 8 in a subprocess.

Each logistic-regression path's draws must be finite, and their pooled
posterior mean and sd must agree with NumPy references (a Newton MAP, its Laplace sd, and the
importance-reweighted Laplace mean). Kernels 1, 3, 4, 5a and 5b are also
timed on their own paths, beside the bound of those launches: kernels 1
and 3 by relaunching every launch of the main path (1) and of the classic
A/B (3) on its recorded operands under ``torch.profiler`` (kernel 1 also
on the options, checkpoint, mesh and host-model paths, kernel 2, every
50th launch, on the options, checkpoint and mesh paths, and kernel 3,
every 4th launch, on the options path), kernel 4 by
relaunching every tenth launch of the fused route on a copy of its lane
state, 5a and 5b by CUDA events around each launch. An empty kernel is
timed as kernels 1 and 4 are (the launch floor both sit on), and kernel 4
is traced once at each width (its chains' phases on the card's clock).

Run from the root of a checkout:  python3 chip_smoke.py [--profile] [--ab] [--options]

``--profile`` adds a ``torch.profiler`` window over a short run and prints
device time by kernel. ``--ab`` samples the fused route's warmed state four
times, unfused, fused, fused, unfused, for an A/B of the two passes.
``--options`` runs the options path alone (kernels 1, 2 and 3 built, the
fused route's warmed state, then the phase; a few minutes) and prints its
result as the last line. Any
failed phase raises (non-zero exit). The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists each kernel's
route, launches on its logistic-regression path (and on the funnel and SV
paths: ``launches_funnel``, ``launches_sv``, with the time and bound of a
launch there; on the options, checkpoint, mesh and host-model paths:
``launches_options``, ``launches_ckpt``, ``launches_mesh`` (by rank),
``launches_host_model``,
with ``path_ms_*`` and ``path_bound_ms_*`` beside them), error against
its plain version, times and bound (the integrator's and the transition kernels' with their
logistic-regression body; their three other bodies are checked and printed
on earlier lines), the logistic-regression kernel's two ``torch.matmul``
products (``matmul_ms``), the time and bound of a launch on the path
(``path_ms``, ``path_bound_ms``) for kernels 1, 3, 4, 5a and 5b, the empty
kernel's two times beside kernel 1 (``empty_queued_ms``,
``empty_single_ms``), and beside kernel 4 its wrapper's host time
(``host_ms``) and its time and bound at D = 101 (``ms_d101``,
``bound_ms_d101``) and at D = 1003 with the SV path's 1024 chains
(``ms_d1003``, ``bound_ms_d1003``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
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
# the options path: sampling runs of OPTIONS_ITERS in blocks of OPTIONS_BLOCK
# from the fused route's warmed state
OPTIONS_ITERS = 10
OPTIONS_BLOCK = 5
OPTIONS_MIN_LATCHED = 1024
OPTIONS_GROUPS = 4
# (rtol, atol) of chain_groups' draws off the card (a plain model's matrix
# product sums in another order at another width); on the card, bit for bit
OPTIONS_GROUPS_TOL = (1e-5, 1e-5)
OPTIONS_K3_EVERY = 4  # kernel 3's launches kept for path_integrator_ms
ROUTE_ITERS = 25
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
# the fused route's pass launches kept for their time on the path: every
# PASS_EVERY-th (a copy of the lane state each, ~12 MB at D = 25)
PASS_EVERY = 10
# the funnel path: Neal's funnel at the bench's width (bench.py), 4096
# chains in 4 cost-sorted groups, run-ahead 4, a tier-2 pass every 6 trips,
# cut in length from the bench's 400 + 400 (100 + 100 took 1017 s on the
# card, host-bound, 6 + 10 174 s, 4 + 10 242 s: the first warmup
# iterations cost the most, and a shorter warmup leaves sampling less
# adapted; 6 + 5 since the smoke drives the host-facing entry points too),
# in blocks of 5 so that the groups are re-sorted by realized cost;
# theta[0] ~ N(0, 3^2)
FUNNEL_DIM = 101
FUNNEL_WARMUP = 6
FUNNEL_SAMPLING = 5
FUNNEL_BLOCK = 5
FUNNEL_GROUPS = 4
# theta[0]'s pooled moments from the JAX package at this configuration,
# seed and lengths, on the CPU with 1024 chains. At these lengths neither
# package reaches the exact N(0, 3^2) (mean 0, sd 3): the chains have not
# mixed through the neck, so the exact marginal is reported and these are
# the check. Seeds 2036, 2037, 2038 gave means 0.9794, 0.9850, 1.0403 and
# sds 1.3632, 1.4441, 1.4122 (at 6 + 10: 0.9884, 0.9823, 1.0386 and
# 1.3853, 1.4511, 1.4264): the port is held within 0.15 of the mean (2.5
# times that spread) and 10 % of the sd (1.7 times). To recompute, with
# JAX on the CPU (~20 s a seed):
#
#   import jax; jax.config.update("jax_platforms", "cpu")
#   import jax.numpy as jnp, numpy as np, chip_smoke as cs, walnuts_tpu as wt
#   from walnuts_tpu.models import funnel
#   for seed in (cs.SEED + 10, cs.SEED + 11, cs.SEED + 12):
#       out = wt.walnuts(
#           funnel(cs.FUNNEL_DIM)[0], num_params=cs.FUNNEL_DIM, num_chains=1024,
#           seed=seed, dtype=jnp.float32, min_warmup_iter=cs.FUNNEL_WARMUP,
#           max_warmup_iter=cs.FUNNEL_WARMUP, min_sampling_iter=cs.FUNNEL_SAMPLING,
#           max_sampling_iter=cs.FUNNEL_SAMPLING, block_size=cs.FUNNEL_BLOCK,
#           batched_groups=cs.FUNNEL_GROUPS, runahead=4, tier2_every=6,
#           max_step_halvings=cs.HALVINGS)
#       v = np.stack([np.asarray(o)[:, 0] for o in out]).astype(np.float64)
#       print(seed, v.mean(), v.std())
FUNNEL_REF = dict(mean=0.9793896049363184, sd=1.363240828091224)
FUNNEL_MEAN_TOL = 0.15
FUNNEL_SD_TOL = 0.10
# the checkpoint path: the main path's model and width, its own seed
CKPT_ITERS = 10
CKPT_BLOCK = 5
CKPT_SEED = SEED + 30
# kernel 2's launches kept for its time on a path: every LOGREG_KEEP_EVERY-th
# (0.4 MB of operands each)
LOGREG_KEEP_EVERY = 50
# the mesh path: the checkpoint path's run (a) with its chains sharded over
# MESH_WORLD gloo ranks sharing the one card, each a process of its own,
# then over one NCCL rank in this process; each run and every collective
# gets MESH_TIMEOUT_S
MESH_WORLD = 2
MESH_TIMEOUT_S = 600
# the profile_dir run: iterations of warmup and of sampling, cut from 5 to
# pay for the mesh path (the first iterations hold most trips: 2 + 2 still
# traces 3/4 of 5 + 5's events)
PROFILE_ITERS = 1
# the host-model path: eight schools through the native Stan bridge against
# autograd (the reference's parity test at the card's width), and a
# standard normal through walnuts_pyfunc's C callback; 15 + 15 iterations,
# cut from 30 + 30 (139-190 s on the card, host-bound) to pay for the mesh
# path together with PROFILE_ITERS
HOST_CHAINS = 1024
HOST_ITERS = 15
HOST_SEED = SEED + 40
HOST_SHARE = 0.99
PYFUNC_CHAINS = 256
PYFUNC_DIM = 100
# the stochastic-volatility path: the bench's 1000 time steps (D = 1003),
# 1024 chains, run-ahead 8, a tier-2 pass every 12 trips, block 50, cut in
# length from the bench's 200 + 200 (30 + 10 took 185 s on the card, 20 + 5
# 111 s); then SV_SAMPLING iterations twice from the warmed state, the
# unfused and the fused pass (every SV_PASS_EVERY-th launch of kernel 4
# kept: ~0.1 GB a copy of the lane state); 6, not fewer: at 5 draws a chain
# the ESS estimator saturates at half the draws, and its device and host
# versions would agree trivially
SV_CHAINS = 1024
SV_WARMUP = 15
SV_MAIN_SAMPLING = 3
SV_SAMPLING = 6
SV_PASS_EVERY = 10
# dimensions whose device ESS is held to the host estimator's: the three
# hyperparameters and three latent steps
SV_ESS_DIMS = (0, 1, 2, 3, 503, 1002)


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
    return profiled_ms_each(fn, (kernel,), reps)[kernel]


def profiled_ms_each(fn, kernels, reps: int = 50) -> dict:
    """``profiled_ms`` of each of ``kernels`` from one window (a process's
    first profiler window costs seconds)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for kernel in kernels:
        hits = [(e.device_time_total, e.count) for e in prof.key_averages()
                if kernel in e.key and e.device_time_total > 0]
        out[kernel] = (sum(h[0] for h in hits) / sum(h[1] for h in hits) / 1e3
                       if hits else None)
    return out


def ptxas_report(log: str) -> list:
    """``(kernel, registers, spill store bytes)`` per kernel from nvcc's
    ``-Xptxas -v`` log, names demangled by ``c++filt`` where it exists."""
    rows, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            rows.append((fn, int(m.group(1)), spill))
            fn, spill = None, 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = [r[0] for r in rows]
    short = [re.sub(r"^.*?(\w+(?:<[^()]*>)?)\(.*$", r"\1", n) for n in names]
    return [(n, r[1], r[2]) for n, r in zip(short, rows)]


def bound(nbytes: float, ops: float) -> tuple:
    """The least time (ms) the card could take: the larger of the bytes
    over HBM's rate and the operations over the float32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed_single(fn, reset, reps: int, lead: bool = True) -> tuple:
    """(device ms, host ms) per call of ``fn``, one call at a time, each
    after ``reset()`` and a sync: CUDA events around the call, behind a
    short sleep with ``lead`` (the fused pass's measure)."""
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


def check_empty(card: str) -> dict:
    """The launch floor: a kernel that does nothing, timed as the replay
    (back-to-back launches behind a sleep, its 32 blocks of 128) and as
    the fused pass (one launch between events, its 512 blocks of 256)."""
    from walnuts_tpu_torch.ops import _cuda

    lib = _cuda.library("replay")

    def launch(blocks, threads):
        stream = torch.cuda.current_stream().cuda_stream
        _cuda.check(lib.wt_empty_kernel(blocks, threads, stream), "wt_empty_kernel")

    queued = time_ms(lambda: launch(32, 128))
    single, _ = timed_single(lambda: launch(CHAINS // 8, 256), lambda: None, 30)
    print(f"[empty kernel] {queued:.4f} ms a launch back to back behind a sleep "
          f"(32 x 128 threads, the replay's measure), {single:.4f} ms one launch "
          f"between events ({CHAINS // 8} x 256, the fused pass's measure)  [{card}]")
    return dict(empty_queued_ms=queued, empty_single_ms=single)


def pass_trace_summary(trace: torch.Tensor, pend: torch.Tensor) -> dict:
    """Where a fused-pass launch's time went, from the kernel's trace
    (``ops.fused_pass.TRACE_COLS`` a chain): when the chains started and
    ended on the card's clock, and when each mark was reached after the
    chain's entry (SM cycles, in us at the clock the trace measured) over
    the pending chains."""
    from walnuts_tpu_torch.ops.fused_pass import TRACE_MARKS

    t = trace.cpu().double()
    pend = pend.cpu()
    t0 = t[:, 0].min()
    entry, leave = (t[:, 0] - t0) / 1e3, (t[:, 1] - t0) / 1e3  # us
    clk = t[:, 3:3 + len(TRACE_MARKS)]
    ns = t[:, 1] - t[:, 0]
    cyc = clk[:, -1] - clk[:, 0]
    ok = (ns > 0) & (cyc > 0)
    ghz = float((cyc[ok] / ns[ok]).median()) if ok.any() else float("nan")
    marks = {}
    for k in range(1, len(TRACE_MARKS)):
        d = (clk[pend, k] - clk[pend, 0]) / ghz / 1e3
        if d.numel():
            marks[TRACE_MARKS[k]] = (float(d.mean()), float(d.max()))
    per_sm = torch.bincount(t[:, 2].long())
    q = lambda x, f: float(torch.quantile(x, f))
    return dict(
        span_us=float(leave.max()), entry_p50_us=q(entry, 0.5),
        entry_p90_us=q(entry, 0.9), entry_max_us=float(entry.max()),
        chain_p50_us=q(leave - entry, 0.5), chain_max_us=float((leave - entry).max()),
        sms=int((per_sm > 0).sum()), chains_per_sm_max=int(per_sm.max()),
        ghz=ghz, marks_us=marks)


def format_trace(tr: dict) -> str:
    ms = ", ".join(f"{k} {m:.3f} (max {x:.3f})" for k, (m, x) in tr["marks_us"].items())
    return (f"chains start from 0 to {tr['entry_max_us']:.3f} us (median "
            f"{tr['entry_p50_us']:.3f}, p90 {tr['entry_p90_us']:.3f}), the last ends "
            f"at {tr['span_us']:.3f} us; a chain takes {tr['chain_p50_us']:.3f} us "
            f"(median), {tr['chain_max_us']:.3f} at most; {tr['sms']} SMs, at most "
            f"{tr['chains_per_sm_max']} chains on one; clock {tr['ghz']:.3f} GHz; "
            f"each mark of a pending chain after its entry, mean (max) us: {ms}")


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
    lp_2, g_2 = logreg_value_grad(theta, x_t, y_t)
    lp_p, g_p = logreg_value_grad_plain(theta, x_t, y_t)
    torch.cuda.synchronize()
    # a fixed order of every sum, no atomics: a launch repeats bit for bit
    repeat = torch.equal(lp_k, lp_2) and torch.equal(g_k, g_2)
    print(f"[logreg] two launches on the same inputs bitwise equal: {repeat}  [{card}]")
    if not repeat:
        raise AssertionError("logreg kernel: two launches on the same inputs differ")
    lp_k, g_k, lp_p, g_p = (t.cpu().numpy() for t in (lp_k, g_k, lp_p, g_p))
    np.testing.assert_allclose(lp_k, lp_p, rtol=1e-5)
    np.testing.assert_allclose(g_k, g_p, rtol=1e-4, atol=2e-3)
    err = float(max(np.abs(lp_k - lp_p).max(), np.abs(g_k - g_p).max()))
    ms = time_ms(lambda: logreg_value_grad(theta, x_t, y_t))
    dev_ms = profiled_ms(lambda: logreg_value_grad(theta, x_t, y_t), "logreg_kernel")
    plain_ms = time_ms(lambda: logreg_value_grad_plain(theta, x_t, y_t))
    # no single PyTorch call computes the function; the plain version's two
    # matrix products are the nearest library yardstick (matmul_ms)
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
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                matmul_ms=mm_ms)


def _pass_case(dim: int, seed: int, chains: int = CHAINS):
    """A synthetic lane state of ``chains`` chains on the card, its frozen
    parameters and an empty block output."""
    from walnuts_tpu_torch.convert import lane_state_from_fields
    from walnuts_tpu_torch.ops.fused_pass import synthetic_pass_inputs

    fields, p = synthetic_pass_inputs(chains, dim, 5, 6, seed)
    st = lane_state_from_fields(fields, torch.float32, DEVICE)
    params = (torch.tensor(p["step"], dtype=torch.float32, device=DEVICE),
              torch.tensor(p["inv_mass"], dtype=torch.float32, device=DEVICE),
              torch.tensor(p["min_micro"], device=DEVICE))
    out = (torch.zeros((6, chains, dim), device=DEVICE),
           torch.zeros((6, chains), device=DEVICE),
           torch.zeros((6, chains), dtype=torch.int32, device=DEVICE))
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


def check_fused_pass(card: str, dim: int, chains: int = CHAINS) -> dict:
    """One tier-2 pass, kernel against plain, at C = chains and width dim."""
    from walnuts_tpu_torch.ops import fused_pass as fp

    cap, R, max_depth = 5, 6, 5
    st_k, params, out_k = _pass_case(dim, SEED + dim, chains)
    st_p, _, out_p = _pass_case(dim, SEED + dim, chains)
    pristine, _, _ = _pass_case(dim, SEED + dim, chains)
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
            bad = int((k != p).reshape(chains, -1).any(-1).sum())
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

    ms, host_ms = timed_single(
        lambda: fp.fused_pass(st_k, *params, cap, R, max_depth, out_k), reset, 30)
    plain_ms, _ = timed_single(lambda: fp.fused_pass_plain(st_k, *params, cap, R,
                                                           max_depth, out_k),
                               reset, 10, lead=False)
    dev_ms = profiled_ms(lambda: (reset(), fp.fused_pass(st_k, *params, cap, R,
                                                         max_depth, out_k)),
                         "fused_pass_kernel", reps=20)
    reset()
    trace = torch.zeros((chains, fp.TRACE_COLS), dtype=torch.int64, device=DEVICE)
    fp.fused_pass(st_k, *params, cap, R, max_depth, out_k, trace=trace)
    torch.cuda.synchronize()
    tr = pass_trace_summary(trace, (pristine.draws_done < cap) & pristine.leaf_done)
    nbytes = _pass_bytes(pristine, st_p, out_p, dim, max_depth - 1, cap)
    bound_ms, bound_by = bound(nbytes, 0.0)
    pend = int(((pristine.draws_done < cap) & pristine.leaf_done).sum())
    print(f"[fused pass] D={dim}: kernel against plain at C={chains} ({pend} "
          f"pending lanes): integers, flags and keys equal on every lane, "
          f"largest float difference {float_err:.3e}; kernel {ms:.4f} ms "
          f"(profiler device time "
          f"{dev_ms if dev_ms is None else f'{dev_ms:.4f}'} ms; the wrapper's "
          f"host cost {host_ms:.4f} ms a call), plain {plain_ms:.4f} ms; bound "
          f"{bound_ms * 1e3:.3f} us ({nbytes / 1e6:.3f} MB, {bound_by}), "
          f"{bound_ms / ms:.3f} of it  [{card}]")
    print(f"[fused pass] D={dim}: a traced launch: {format_trace(tr)}  [{card}]")
    return dict(name="fused_pass", route="cuda",
                source="walnuts_tpu_torch/csrc/fused_pass.cu",
                replaces="walnuts_tpu/ops/fused_pass.py:172",
                max_abs_err=float_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                host_ms=host_ms, trace=tr)


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
        # no measurement of an earlier check (its tensors may have lain at
        # these addresses): the first launch takes the chains in index order
        ft._MEASURED[:] = [None, None]
        got = fused(*args)
        torch.cuda.synchronize()
        if fused.launches != 1:
            raise AssertionError(f"{name}[{body}]: {fused.launches} launches for one call")
        # a second launch, its chains taken in the order the first measured:
        # a chain's result depends on neither the warp nor the order (and
        # the counter starts at 0 again)
        again = fused(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name}[{body}]: a launch in measured order "
                                 "differs from the launch in index order")
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
        group = fused.GROUP_WARPS if body == "logistic_regression" else 1
        print(f"[transition] {name}, {body}, D={dim}"
              f"{'' if n == 1 else f', {n} draws'}, group_warps {group}: kernel "
              f"against plain at C={CHAINS}, max_depth {MAX_DEPTH}, "
              f"max_step_halvings {HALVINGS}: launches in index and in measured order "
              f"bitwise equal; depth and n_grads equal on {share:.4f} of the "
              f"chains, on those "
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
            bound_by=bound_by, library_ms=None, group_warps=group))
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
    from walnuts_tpu_torch.ops import prng

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the replay's operands of every launch, for path_replay_ms
    replay = prng.replay_split_chain
    recording = prng.replay_split_chain = _Recording(replay)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        out, info = wtt.walnuts(
            logp_grad, fused=True, num_params=dim, num_chains=CHAINS,
            dtype=torch.float32, seed=SEED, device=DEVICE,
            min_warmup_iter=MAIN_ITERS, max_warmup_iter=MAIN_ITERS,
            min_sampling_iter=MAIN_ITERS, max_sampling_iter=MAIN_ITERS,
            block_size=50, return_info=True, max_step_halvings=HALVINGS,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        prng.replay_split_chain = replay
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
              f"trips, {info.n_outer_trips[phase]} tier-2 passes "
              f"({info.n_pass_replays[phase]} CUDA graph replays, "
              f"{info.n_pass_captures[phase]} captures), "
              f"{info.n_syncs[phase]} syncs ({info.n_syncs[phase] / nb:.1f} "
              f"per block)  [{card}]")
        replays, passes = info.n_pass_replays[phase], info.n_outer_trips[phase]
        if DEVICE == "cuda" and replays != passes:
            raise AssertionError(f"main path {phase}: {replays} graph replays "
                                 f"for {passes} passes")
    print(f"[main path] peak device memory {peak / 2**20:.1f} MiB  [{card}]")
    print(f"[main path] launches on the main path: {json.dumps(launches)}  [{card}]")
    return launches, path_replay_ms(card, recording.calls)


def path_replay_ms(card: str, calls, path: str = "main path",
                   ms: float | None = None) -> dict:
    """Kernel 1 at the main path's own operands: every launch relaunched
    under ``torch.profiler`` (device time of the kernel alone; CUDA events
    over the relaunches where the profiler sees none; ``ms`` where a
    window over several kernels took it), and the bound of those
    launches."""
    from walnuts_tpu_torch.ops import prng

    def relaunch():
        for a in calls:
            prng.replay_split_chain(*a)

    if ms is None:
        ms = profiled_ms(relaunch, "replay_kernel", reps=1)
    how = "torch.profiler"
    if ms is None:
        ms = time_ms(relaunch, reps=1, warmup=1) / len(calls)
        how = "CUDA events"
    hashes = sum(int(a[2].sum()) + int(((a[3] >= 1) & (a[3] <= a[2])).sum())
                 for a in calls)
    lanes = sum(int(a[2].numel()) for a in calls)
    bound_ms, bound_by = bound(40.0 * lanes, THREEFRY_OPS * hashes)
    bound_ms /= len(calls)
    longest = max(int(a[2].max()) for a in calls)
    print(f"[{path}] kernel 1 on the {path}: its {len(calls)} launches "
          f"relaunched on their own operands ({lanes / len(calls):.0f} lanes a "
          f"launch, n_ends up to {longest}, {hashes / lanes:.3f} hashes a lane "
          f"and launch): "
          f"{ms:.4f} ms a launch ({how}); bound {bound_ms * 1e3:.3f} us a launch "
          f"({bound_by}), {bound_ms / ms:.4f} of it  [{card}]")
    return dict(path_ms=ms, path_bound_ms=bound_ms)


def path_logreg_ms(card: str, calls, path: str, ms: float | None = None) -> dict:
    """Kernel 2 at a path's own operands: the recorded launches (every
    LOGREG_KEEP_EVERY-th) relaunched under ``torch.profiler`` (CUDA events
    where the profiler sees none; ``ms`` as in ``path_replay_ms``), and the
    bound of a launch: the two products' operations, or theta, X and y
    read and lp and grad written."""
    from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad

    def relaunch():
        for a in calls:
            logreg_value_grad(*a)

    if ms is None:
        ms = profiled_ms(relaunch, "logreg_kernel", reps=1)
    how = "torch.profiler"
    if ms is None:
        ms = time_ms(relaunch, reps=1, warmup=1) / len(calls)
        how = "CUDA events"
    chains = sum(a[0].shape[0] for a in calls) / len(calls)
    rows, dim = calls[0][1].shape
    bound_ms, bound_by = bound(4.0 * (2 * chains * dim + rows * dim + rows + chains),
                               4.0 * chains * rows * dim)
    print(f"[{path}] kernel 2 on the {path}: {len(calls)} of its launches "
          f"relaunched on their own operands ({chains:.0f} chains a launch): "
          f"{ms:.4f} ms a launch ({how}); bound {bound_ms * 1e3:.3f} us a launch "
          f"({bound_by}), {bound_ms / ms:.4f} of it  [{card}]")
    return dict(path_ms=ms, path_bound_ms=bound_ms)


def _pass_copy(s):
    """The lane state ``s`` with every field the fused pass reads or
    writes in storage of its own."""
    from walnuts_tpu_torch.ops import fused_pass as fp

    names = [n for n in fp.RW_FIELDS + fp.ROW_RO[:3] + fp.F_RO[:2]
             if n != "n_depth_exhausted"]
    return s._replace(
        fails=s.fails._replace(n_depth_exhausted=s.fails.n_depth_exhausted.clone()),
        **{n: getattr(s, n).clone() for n in names})


class _PassRecording:
    """Stands in for ``core.batched.fused_pass``: keeps a copy of the lane
    state before every ``every``-th call, with the call's other operands."""

    def __init__(self, fn, every: int):
        self.fn, self.every, self.n, self.calls = fn, every, 0, []

    def __call__(self, s, *args, **kwargs):
        if self.n % self.every == 0:
            self.calls.append((_pass_copy(s), args))
        self.n += 1
        return self.fn(s, *args, **kwargs)


def path_pass_ms(card: str, calls, every: int = PASS_EVERY,
                 path: str = "fused route") -> dict:
    """Kernel 4 at the fused route's own lane states: each recorded launch
    relaunched on a copy of its state under ``torch.profiler`` (device
    time of the kernel alone), and the bound of those launches."""
    from walnuts_tpu_torch.ops import fused_pass as fp

    spare = {}

    def out_like(out):
        key = tuple(t.shape for t in out)
        if key not in spare:
            spare[key] = tuple(torch.zeros_like(t) for t in out)
        return spare[key]

    def relaunch():
        for st, (step, inv_mass, min_micro, cap, R, max_depth, out) in calls:
            fp.fused_pass(_pass_copy(st), step, inv_mass, min_micro, cap, R,
                          max_depth, out_like(out))

    ms = profiled_ms(relaunch, "fused_pass_kernel", reps=1)
    how = "torch.profiler"
    if ms is None:
        ms = time_ms(relaunch, reps=1, warmup=1) / len(calls)
        how = "CUDA events, copies included"
    nbytes = pend = 0.0
    ends = 0
    for st, (step, inv_mass, min_micro, cap, R, max_depth, out) in calls:
        after = _pass_copy(st)
        o = out_like(out)
        fp.fused_pass(after, step, inv_mass, min_micro, cap, R, max_depth, o)
        nbytes += _pass_bytes(st, after, o, st.run_sel.shape[1], max(max_depth - 1, 1),
                              cap)
        pend += float(((st.draws_done < cap) & st.leaf_done).float().mean())
        ends = max(ends, int(st.n_ends.max()))
    bound_ms, bound_by = bound(nbytes / len(calls), 0.0)
    print(f"[{path}] kernel 4 on the {path}: {len(calls)} of its launches "
          f"(every {every}th) relaunched on copies of their lane states "
          f"(n_ends up to {ends}, {pend / len(calls):.3f} of the lanes pending): "
          f"{ms:.4f} ms a launch ({how}); bound {bound_ms * 1e3:.3f} us a launch "
          f"({bound_by}), {bound_ms / ms:.4f} of it  [{card}]")
    return dict(path_ms=ms, path_bound_ms=bound_ms)


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


def warmed_state(warmup: int = 50):
    """The fused route's warmed state: ``run_warmup`` for ``warmup``
    iterations from the start ``walnuts()`` makes for seed SEED + 1 (also
    the input of ``tools/torch_logreg_sweep.py``'s transition sweep)."""
    from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused
    from walnuts_tpu_torch.parallel.runtime import run_warmup

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    wcfg = WarmupConfig(min_iter=warmup, max_iter=warmup, block_size=50)
    scfg = SamplingConfig(min_iter=ROUTE_ITERS, max_iter=ROUTE_ITERS,
                          block_size=50, max_step_halvings=HALVINGS)
    ws = _start_state(logp_grad, dim, SEED + 1, wcfg, scfg)
    return run_warmup(logp_grad, ws, wcfg, scfg, batched=True, tier2_every=12)[0]


def run_fused_route(card: str, ref, warmup: int = 50,
                    order=("unfused", "fused")) -> tuple:
    """Warmup once, then sampling with the unfused and the fused tier-2
    pass from the same warmed state, in ``order``. Returns the fused run's
    launches, the warmed state and kernel 4's time on the route
    (:func:`path_pass_ms`)."""
    from walnuts_tpu_torch.config import SamplingConfig
    from walnuts_tpu_torch.core.sampler import freeze_params, init_sample_state
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    scfg = SamplingConfig(min_iter=ROUTE_ITERS, max_iter=ROUTE_ITERS,
                          block_size=50, max_step_halvings=HALVINGS)
    t0 = time.perf_counter()
    ws = warmed_state(warmup)
    print(f"[fused route] run_warmup {warmup} iterations: "
          f"{time.perf_counter() - t0:.3f} s  [{card}]")
    params, ss = freeze_params(ws), init_sample_state(ws)

    from walnuts_tpu_torch.core import batched

    routes = {}
    recorded = None
    for name in order:
        torch.cuda.synchronize()
        # the first fused run keeps every PASS_EVERY-th lane state for
        # path_pass_ms
        pass_fn = batched.fused_pass
        if name == "fused" and recorded is None:
            batched.fused_pass = recorded = _PassRecording(pass_fn, PASS_EVERY)
        _reset_counts()
        t0 = time.perf_counter()
        try:
            _, d, _, info = run_sampling(logp_grad, ss, params, scfg, batched=True,
                                         device_draws=True,
                                         pallas_pass=name == "fused")
            torch.cuda.synchronize()
        finally:
            batched.fused_pass = pass_fn
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
    return launches, ws, path_pass_ms(card, recorded.calls)


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


class _Recording:
    """Stands in for a kernel's wrapper (an attempt integrator, the
    replay, the logistic regression) and keeps a copy of the operands of
    every ``every``-th call. Its ``launches`` is the wrapper's: a wrapper
    that counts through its module's name for itself counts on, and so do
    the replays of a CUDA graph that holds the kernel. A call while a graph
    is captured launches nothing and keeps no operands (a copy made then
    would be a node of the graph, its values unwritten): the tier-2 pass's
    graph replays kernel 1 without a host call, so the kept calls of
    kernel 1 on the batched paths are the eager pass before each capture
    and, with ``defer_splits=False``, the trips' splits."""

    def __init__(self, integrator, every: int = 1):
        self.integrator, self.calls, self.every, self.seen = integrator, [], every, 0

    @property
    def launches(self):
        return self.integrator.launches

    @launches.setter
    def launches(self, n):
        self.integrator.launches = n

    def __call__(self, *args):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return self.integrator(*args)
        if self.seen % self.every == 0:
            self.calls.append(tuple(a.clone() for a in args))
        self.seen += 1
        return self.integrator(*args)


def path_integrator_ms(card: str, fused, calls, tag: str = "classic A/B",
                       path: str = "classic path", which: str = "the kernel route's") -> dict:
    """Kernel 3 at a path's own operands (the classic path's by default):
    the recorded launches (``which``) relaunched under ``torch.profiler``
    (device time of the kernel alone; CUDA events over the relaunches where
    the profiler sees none), and the bound of those launches' steps."""
    def relaunch():
        for a in calls:
            fused(*a)

    ms = profiled_ms(relaunch, "integrate_logreg_kernel", reps=1)
    how = "torch.profiler"
    if ms is None:
        ms = time_ms(relaunch, reps=1, warmup=1) / len(calls)
        how = "CUDA events"
    steps = sum(int(a[3].sum()) for a in calls)
    chains = sum(a[0].shape[0] for a in calls)
    nbytes = 4.0 * ((7 * DIM + 3) * chains + (ROWS * DIM + ROWS) * len(calls))
    bound_ms, bound_by = bound(nbytes, float(steps) * (7 * DIM + 4 * ROWS * DIM))
    bound_ms /= len(calls)
    print(f"[{tag}] kernel 3 on the {path}: {which} "
          f"{len(calls)} launches relaunched on their own operands ({steps} chain "
          f"steps, {steps / chains:.2f} a chain and launch): "
          f"{ms:.4f} ms a launch ({how}); bound {bound_ms * 1e3:.3f} us a launch "
          f"({bound_by}), {bound_ms / ms:.4f} of it  [{card}]")
    return dict(path_ms=ms, path_bound_ms=bound_ms)


def run_classic_ab(card: str, ws) -> tuple:
    """20 classic sampling iterations from the warmed state ``ws`` (the
    fused route's), with the kernel and with the plain integrator of the
    same value-and-gradient. Returns the kernel route's wall seconds and
    gradients, and kernel 3's time and bound on the path
    (:func:`path_integrator_ms`)."""
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
    # the kernel route keeps its operands (4 copies an attempt beside the
    # ~850 operations of the attempt) for path_integrator_ms
    recording = _Recording(fused)
    for name, integrator in (("kernel", recording),
                             ("plain", make_plain_integrator(model[0]))):
        torch.cuda.synchronize()
        fused.launches = 0
        t0 = time.perf_counter()
        st, d, _, info = run_sampling(logp_grad, ss, params, scfg, batched=False,
                                      device_draws=True, integrator=integrator)
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
    path = path_integrator_ms(card, fused, recording.calls)
    # info.n_grads goes on from the warmed state's counts
    return wall_k, float(np.sum(g_k)) - float(ss.n_grads.sum()), path


def check_bf16_rounding(card: str) -> None:
    """``round_bf16`` (``bf16_ends``' rounding) on the card against the CPU:
    10^6 random values over 40 binades and values beside bfloat16's
    midpoints, in float32 and float64: equal bit for bit."""
    from walnuts_tpu_torch.core.transition import round_bf16

    rng = np.random.default_rng(SEED)
    x = rng.standard_normal(10**6) * np.exp(rng.uniform(-20, 20, 10**6))
    mid = np.arange(1, 4097, dtype=np.float64) * 2.0**-7 + 2.0**-8 + 1.0
    x = np.concatenate([x, mid, np.nextafter(mid, 0), np.nextafter(mid, 4), -mid])
    same = {}
    for dtype in (torch.float32, torch.float64):
        v = torch.from_numpy(x).to(dtype)
        same[str(dtype).removeprefix("torch.")] = bool(torch.equal(
            round_bf16(v), round_bf16(v.to(DEVICE)).cpu()))
    print(f"[options path] bfloat16 round trip of {x.size} values, the card's "
          f"against the CPU's, bitwise: {json.dumps(same)}  [{card}]")
    if not all(same.values()):
        raise AssertionError("bf16 rounding on the card differs from the CPU's")


def _k3_value_grad(fused):
    """The model's value and gradient by kernel 3's own body: one leapfrog
    step of size 0 from ``(theta, 0, 0)`` leaves theta as it is and
    evaluates the body there, so a transition's start point has the same
    bits whether the classic path re-evaluates it or the flattened sampler
    caches it from an attempt."""
    consts = {}

    def value_grad(theta):
        c, d = theta.shape
        if c not in consts:
            consts[c] = (torch.ones((c, d), dtype=theta.dtype, device=theta.device),
                         torch.zeros((c,), dtype=theta.dtype, device=theta.device),
                         torch.ones((c,), dtype=torch.int32, device=theta.device))
        ones, zero, one = consts[c]
        cur = torch.stack([theta, torch.zeros_like(theta), torch.zeros_like(theta)], 1)
        out, lp = fused(cur, ones, zero, one)
        return lp, out[:, 2]

    return value_grad


class _Depths:
    """Stands in for ``runtime.make_batched_sample_block`` and keeps each
    sampling block's depths (``run_sampling`` returns draws and log
    densities only)."""

    def __init__(self, factory):
        self.factory, self.depths = factory, []

    def __call__(self, *args, **kwargs):
        start, sample = self.factory(*args, **kwargs)

        def kept(*a, **k):
            res = sample(*a, **k)
            self.depths.append(res.depths.cpu().numpy())
            return res

        return start, kept


def run_options_path(card: str, ws) -> dict:
    """The scheduler options and runtime keywords on the main path's model
    at full width, from the fused route's warmed state ``ws``: one
    sampling run of OPTIONS_ITERS iterations in blocks of OPTIONS_BLOCK
    per option, each held to its reference route. The batched runs (kernel
    2 for the model, kernel 1 in every pass, or in every trip with
    ``defer_splits=False``) against the default batched run A; the classic
    runs with kernel 3 (for the attempts and, through
    :func:`_k3_value_grad`, for the model) against the classic run C; the
    batched ``bf16_ends`` run (kernel 3 for the model) against the classic
    ``bf16_ends`` run. Returns each kernel's launches in the phase and its
    time and bound a launch there."""
    from walnuts_tpu_torch.config import SamplingConfig
    from walnuts_tpu_torch.core.sampler import freeze_params, init_sample_state
    from walnuts_tpu_torch.models.kernels import logistic_regression_vg
    from walnuts_tpu_torch.ops.integrator import make_fused_integrator
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused
    from walnuts_tpu_torch.parallel import runtime

    check_bf16_rounding(card)
    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    fused = make_fused_integrator(logistic_regression_vg(ROWS, DIM, device=DEVICE))
    k3 = _Recording(fused, every=OPTIONS_K3_EVERY)
    lg3 = _k3_value_grad(k3)
    scfg = SamplingConfig(min_iter=OPTIONS_ITERS, max_iter=OPTIONS_ITERS,
                          block_size=OPTIONS_BLOCK, max_step_halvings=HALVINGS)
    params, ss = freeze_params(ws), init_sample_state(ws)
    depths = runtime.make_batched_sample_block = _Depths(runtime.make_batched_sample_block)
    runs = {}

    def run(name, lg, **kw):
        depths.depths = []
        first_replay = len(rec.replay.calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, d, lp, info = runtime.run_sampling(lg, ss, params, scfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = dict(
            draws=d.cpu().numpy(), logps=lp.cpu().numpy(), key=st.key.cpu().numpy(),
            n_grads=np.asarray(info.n_grads), device=d.device.type,
            fails=np.stack([info.n_halve_fail, info.n_nonfinite, info.n_depth_exhausted]),
            depths=np.concatenate(depths.depths) if depths.depths else None,
            blocks=info.n_blocks["sampling"], trips=info.n_inner_trips["sampling"],
            replay_calls=rec.replay.calls[first_replay:])
        what = "attempts" if not kw.get("batched") else "tier-2 passes"
        print(f"[options path] {name}: wall {wall:.3f} s, {info.n_inner_trips['sampling']} "
              f"{'trips' if kw.get('batched') else 'model evaluations asked'}, "
              f"{info.n_outer_trips['sampling']} {what}, {info.n_syncs['sampling']} "
              f"syncs, {info.n_blocks['sampling']} blocks  [{card}]")

    def held(name, ref, grads=0, run_ahead=False, draws_on=None, tol=None):
        """``name`` against ``ref`` bit for bit: draws, log densities, depths
        where both have them, and unless ``run_ahead`` (the flattened
        sampler's bank has run into the next transition) end keys, failure
        counters and ``n_grads`` less ``grads``; with ``tol`` the draws and
        log densities within ``tol = (rtol, atol)`` (the bitwise share is
        printed)."""
        a, b = runs[name], runs[ref]
        eq = np.array_equal if tol is None else (
            lambda x, y: bool(np.allclose(x, y, rtol=tol[0], atol=tol[1])))
        same = {k: bool(eq(a[k], b[k])) for k in ("draws", "logps")}
        if not run_ahead:
            same.update({k: bool(np.array_equal(a[k], b[k])) for k in ("key", "fails")})
            same["n_grads"] = bool(np.array_equal(a["n_grads"] - grads, b["n_grads"]))
        if a["depths"] is not None and b["depths"] is not None:
            same["depths"] = bool(np.array_equal(a["depths"], b["depths"]))
        if draws_on is not None:
            same[f"draws on {draws_on}"] = a["device"] == draws_on
        lanes = np.all(a["draws"] == b["draws"], axis=(0, 2))
        print(f"[options path] {name} against {ref}: {json.dumps(same)}; chains "
              f"with equal draws {lanes.mean():.4f}, largest difference "
              f"{np.abs(a['draws'] - b['draws']).max():.3e}  [{card}]")
        if not all(same.values()):
            raise AssertionError(f"options path: {name} differs from {ref}: {same}")

    try:
        with _Recorded() as rec:
            _reset_counts()
            fused.launches = 0
            kw = dict(batched=True, device_draws=True)
            run("A (batched)", logp_grad, **kw)
            for name, extra in (
                    (f"min_latched={OPTIONS_MIN_LATCHED}", dict(min_latched=OPTIONS_MIN_LATCHED)),
                    ("defer_splits=False", dict(defer_splits=False)),
                    ("pallas_replay=True", dict(pallas_replay=True)),
                    ("fresh_cur=True", dict(fresh_cur=True)),
                    ("bounded_sweeps=True", dict(bounded_sweeps=True))):
                run(name, logp_grad, **kw, **extra)
                held(name, "A (batched)")
            run("device_draws=False", logp_grad, batched=True, device_draws=False)
            held("device_draws=False", "A (batched)", draws_on="cpu")
            run("block_budget=1e-9", logp_grad, **kw, block_budget=1e-9)
            extra_blocks = runs["block_budget=1e-9"]["blocks"] - runs["A (batched)"]["blocks"]
            if extra_blocks <= 0:
                raise AssertionError("options path: the block budget capped no block")
            # every block of the batched scheduler pays one start gradient
            held("block_budget=1e-9", "A (batched)", grads=extra_blocks)
            ckw = dict(integrator=k3, device_draws=True)
            run("C (classic, kernel 3)", lg3, **ckw)
            run("flatten=True", lg3, flatten=True, **ckw)
            flat, classic = runs["flatten=True"], runs["C (classic, kernel 3)"]
            # no start evaluation a transition, one for the bank, the banked
            # run-ahead counted: n_grads as the reference counts them
            runahead = flat["n_grads"] - classic["n_grads"] + OPTIONS_ITERS - 1
            print(f"[options path] flatten=True: run-ahead gradients banked a chain, "
                  f"mean {runahead.mean():.2f}, least {runahead.min()}  [{card}]")
            if runahead.min() < 0:
                raise AssertionError("options path: flatten counts fewer gradients "
                                     "than the classic path's transitions")
            held("flatten=True", "C (classic, kernel 3)", run_ahead=True)
            run(f"chain_groups={OPTIONS_GROUPS}", lg3, chain_groups=OPTIONS_GROUPS, **ckw)
            # each group's chains at 1/OPTIONS_GROUPS of the width: kernel 3
            # sums a chain alone, so on the card the groups are bit for bit
            held(f"chain_groups={OPTIONS_GROUPS}", "C (classic, kernel 3)",
                 tol=None if DEVICE == "cuda" else OPTIONS_GROUPS_TOL)
            run("bf16_ends=True (classic, kernel 3)", lg3, bf16_ends=True, **ckw)
            run("bf16_ends=True (batched, kernel 3 for the model)", lg3, batched=True,
                bf16_ends=True, device_draws=True)
            # the batched block caches every draw's start gradient but its
            # blocks' first
            held("bf16_ends=True (batched, kernel 3 for the model)",
                 "bf16_ends=True (classic, kernel 3)",
                 grads=-(OPTIONS_ITERS - OPTIONS_ITERS // OPTIONS_BLOCK))
            launches = dict(_counts(), integrator=fused.launches)
    finally:
        runtime.make_batched_sample_block = depths.factory
    for name in ("replay_split_chain", "logreg_value_grad", "integrator"):
        if launches[name] <= 0:
            raise AssertionError(f"the options path never launched {name}")
    print(f"[options path] launches on the options path: {json.dumps(launches)}  [{card}]")
    # defer_splits=False: every kernel 1 launch of that run is a trip's split
    split = runs["defer_splits=False"]
    split_ms = path_replay_ms(card, split["replay_calls"],
                              "options path, defer_splits=False's trip splits")
    print(f"[options path] defer_splits=False splits in every trip by kernel 1: "
          f"{len(split['replay_calls'])} launches for {split['trips']} trips, "
          f"{split_ms['path_ms']:.4f} ms a trip on the card  [{card}]")
    path = rec.path_ms(card, "options path")
    path["integrator"] = path_integrator_ms(
        card, fused, k3.calls, tag="options path", path="options path",
        which=f"every {OPTIONS_K3_EVERY}th launch kept:")
    return {name: dict(launches_options=launches[name],
                       path_ms_options=path[name]["path_ms"],
                       path_bound_ms_options=path[name]["path_bound_ms"])
            for name in ("replay_split_chain", "logreg_value_grad", "integrator")}


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

    from walnuts_tpu_torch.ops import _cuda

    model, xy, tail = _transition_setup(ws)
    base = prng.key(SEED + 3, DEVICE)
    one = ft.make_fused_transition(model, DIM, MAX_DEPTH, HALVINGS)
    block = ft.make_fused_sample_block(model, DIM, MAX_DEPTH, HALVINGS, BLOCK_DRAWS)
    # the body's kernel at this width, by its demangled or its mangled name
    kp = (DIM + 3) // 4 * 4
    regs = [r for r in ptxas_report(_cuda.BUILD_INFO["fused_transition"]["log"])
            if r[0].startswith(f"transition_logreg_kernel<{kp},")
            or f"transition_logreg_kernelILi{kp}E" in r[0]]
    if not regs:
        raise AssertionError("ptxas reported no transition_logreg_kernel at width "
                             f"{kp}")
    print(f"[transition path] group_warps: 5a {one.GROUP_WARPS}, 5b "
          f"{block.GROUP_WARPS}; chains taken in measured order; "
          f"{regs[0][0]}: {regs[0][1]} registers, {regs[0][2]} bytes spill "
          f"stores  [{card}]")
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
    # the bound of a launch on the path, as check_transition's without the
    # attempts' U-turn passes (the kernel does not report its attempts): the
    # evaluations the kernel made (n_grads counts each start point) times the
    # body's and the leapfrog's operations, and the operands' bytes
    ops_eval = 7 * DIM + 4 * ROWS * DIM
    consts = ROWS * DIM + ROWS
    bound_a, _ = bound(4.0 * (CHAINS * DIM * 6 + CHAINS * 6 + consts),
                       (total - CHAINS * TRANSITION_DRAWS) / TRANSITION_DRAWS * ops_eval)
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
          f"largest per-chain n_grads over the run {int(r['n_grads'].max())}; "
          f"bound {bound_a * 1e3:.3f} us a launch, {bound_a / np.mean(r['kernel_ms']):.4f} "
          f"of the kernel's time  [{card}]")
    check_posterior(r["draws"].cpu().numpy(), "transition path, 5a", card, ref)
    path = {"fused_transition": dict(path_ms=float(np.mean(r["kernel_ms"])),
                                     path_bound_ms=bound_a)}

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
    blocks, block_ms, block_bound = [], [], []
    for j in range(BLOCK_LAUNCHES):
        rho = _momenta(prng.fold_in(base, 1000 + j), (BLOCK_DRAWS, CHAINS, DIM),
                       tail[1][None])
        lp0, g0 = consistent(theta, lp_f, g_f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (d, _, theta, g_f, lp_f, ng), ms = _event_ms(
            lambda: block(17 + j, theta, lp0, g0, rho, *tail))
        wall = time.perf_counter() - t0
        if not torch.equal(d[-1], theta):
            raise AssertionError("transition path: the block's last draw is not "
                                 "its final point")
        blocks.append(d.cpu().numpy())
        total = float(ng.sum())  # the evaluations the launch made
        bound_b, bound_by = bound(
            4.0 * (CHAINS * DIM * (5 + 2 * BLOCK_DRAWS)
                   + CHAINS * (6 + BLOCK_DRAWS) + consts), total * ops_eval)
        block_ms.append(ms)
        block_bound.append(bound_b)
        print(f"[transition path] 5b, launch {j} of {BLOCK_DRAWS} draws (seed "
              f"{17 + j}; momenta and start point made before): wall {wall:.3f} s, "
              f"kernel {ms:.3f} ms (events), {total:.0f} gradients, "
              f"{total / wall:.1f} per s, {total / (CHAINS * BLOCK_DRAWS):.3f} per "
              f"chain and draw, largest per-chain n_grads {int(ng.max())}; bound "
              f"{bound_b:.3f} ms ({bound_by}), {bound_b / ms:.4f} of the kernel's "
              f"time  [{card}]")
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
    path["fused_sample_block"] = dict(path_ms=float(np.mean(block_ms)),
                                      path_bound_ms=float(np.mean(block_bound)))
    return launches, path


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
    wall_c, grads_c, _ = classic
    print(f"[transition A/B] {AB_DRAWS} sampling iterations from one warmed state, "
          f"momenta included: classic path with the integrator kernel: wall "
          f"{wall_c:.3f} s, {grads_c:.0f} gradients, {grads_c / wall_c:.1f} per s | "
          f"5a, one launch per draw: wall {wall_a:.3f} s, {grads_a:.0f} gradients, "
          f"{grads_a / wall_a:.1f} per s | 5b, one launch: wall {wall_b:.3f} s, "
          f"{grads_b:.0f} gradients (a draw's first evaluation not counted), "
          f"{grads_b / wall_b:.1f} per s  [{card}]")


def _print_phases(what: str, info, card: str) -> None:
    for phase in ("warmup", "sampling"):
        nb = info.n_blocks[phase]
        print(f"[{what}] {phase}: {info.seconds[phase]:.3f} s, {nb} blocks, "
              f"{info.n_inner_trips[phase]} trips, {info.n_outer_trips[phase]} "
              f"tier-2 passes, {info.n_syncs[phase]} syncs  [{card}]")


def run_funnel_path(card: str) -> tuple:
    """``walnuts()`` on funnel(101) x 4096 in 4 cost-sorted groups: finite
    draws, and theta[0]'s pooled mean within ``FUNNEL_MEAN_TOL`` and its
    pooled sd within ``FUNNEL_SD_TOL`` of the JAX package's at the same
    configuration (``FUNNEL_REF``). Returns the replay's launches and its
    time on the path."""
    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch import summary
    from walnuts_tpu_torch.models import funnel
    from walnuts_tpu_torch.ops import prng

    logp, dim = funnel(FUNNEL_DIM)
    torch.cuda.synchronize()
    replay = prng.replay_split_chain
    recording = prng.replay_split_chain = _Recording(replay)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        out, info = wtt.walnuts(
            logp, num_params=dim, num_chains=CHAINS, dtype=torch.float32,
            seed=SEED + 10, device=DEVICE, min_warmup_iter=FUNNEL_WARMUP,
            max_warmup_iter=FUNNEL_WARMUP, min_sampling_iter=FUNNEL_SAMPLING,
            max_sampling_iter=FUNNEL_SAMPLING, block_size=FUNNEL_BLOCK,
            batched_groups=FUNNEL_GROUPS, runahead=4, tier2_every=6,
            max_step_halvings=HALVINGS, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        prng.replay_split_chain = replay
    launches = _counts()
    if launches["replay_split_chain"] <= 0:
        raise AssertionError("the funnel path never launched replay_split_chain")
    draws = np.stack([np.asarray(c) for c in out], axis=1)  # (R, C, D)
    if draws.shape != (FUNNEL_SAMPLING, CHAINS, dim) or not np.isfinite(draws).all():
        raise AssertionError(f"funnel path: bad draws: shape {draws.shape}, "
                             f"finite {np.isfinite(draws).all()}")
    v = draws[:, :, 0].astype(np.float64)
    mean, sd = float(v.mean()), float(v.std())
    per_chain = list(np.moveaxis(draws, 1, 0))
    ess = summary.ess(per_chain)
    n_grads = float(np.sum(info.n_grads))
    w_s, s_s = info.seconds["warmup"], info.seconds["sampling"]
    print(f"[funnel path] funnel({dim}) x {CHAINS} chains, float32, "
          f"{FUNNEL_WARMUP} + {FUNNEL_SAMPLING} iterations, block {FUNNEL_BLOCK}, "
          f"batched_groups {FUNNEL_GROUPS}, runahead 4, tier2_every 6, "
          f"max_step_halvings {HALVINGS}: wall {wall:.3f} s  [{card}]")
    _print_phases("funnel path", info, card)
    print(f"[funnel path] gradients used {n_grads:.0f}, {n_grads / (w_s + s_s):.1f} "
          f"per s; median ESS {np.median(ess):.1f}, ESS of theta[0] {ess[0]:.1f}, "
          f"min ESS {ess.min():.1f}; median ESS per sampling s "
          f"{np.median(ess) / s_s:.1f}  [{card}]")
    ref_mean, ref_sd = FUNNEL_REF["mean"], FUNNEL_REF["sd"]
    print(f"[funnel path] theta[0] pooled mean {mean:.4f}, sd {sd:.4f}; the JAX "
          f"package's at this configuration {ref_mean:.4f}, {ref_sd:.4f}: mean "
          f"{abs(mean - ref_mean):.4f} apart (limit {FUNNEL_MEAN_TOL}), sd ratio "
          f"{sd / ref_sd:.4f} (limit 1 +- {FUNNEL_SD_TOL}); the exact N(0, 3^2): mean "
          f"{abs(mean) / 3.0:.4f} sd off, sd ratio {sd / 3.0:.4f} (reported only); "
          f"launches {json.dumps(launches)}  [{card}]")
    if abs(mean - ref_mean) > FUNNEL_MEAN_TOL or abs(sd / ref_sd - 1.0) > FUNNEL_SD_TOL:
        raise AssertionError("funnel path: theta[0] disagrees with the reference")
    return launches, path_replay_ms(card, recording.calls, "funnel path")


class _WarmupCapture:
    """Stands in for ``api.run_warmup`` and keeps the warmed state it
    returns."""

    def __init__(self, fn):
        self.fn, self.state = fn, None

    def __call__(self, *args, **kwargs):
        res = self.fn(*args, **kwargs)
        self.state = res[0]
        return res


def run_sv_path(card: str) -> tuple:
    """``walnuts()`` on the stochastic-volatility model (D = 1003) x 1024,
    then SV_SAMPLING sampling iterations twice from its warmed state, with
    the unfused and the fused tier-2 pass: draws finite and bitwise equal
    between the two, the device ESS of the cube against the host's.
    Returns the launches of kernels 1 (``walnuts()``) and 4 (the fused
    run) and their times on the path."""
    import walnuts_tpu_torch as wtt
    import walnuts_tpu_torch.api as api
    from walnuts_tpu_torch import parity, summary
    from walnuts_tpu_torch.config import SamplingConfig
    from walnuts_tpu_torch.core import batched
    from walnuts_tpu_torch.core.sampler import freeze_params, init_sample_state
    from walnuts_tpu_torch.models import stochastic_volatility
    from walnuts_tpu_torch.ops import prng
    from walnuts_tpu_torch.ops.math import make_logp_grad
    from walnuts_tpu_torch.parallel.runtime import run_sampling
    from walnuts_tpu_torch.summary_device import effective_sample_size_device_chunked

    logp, dim = stochastic_volatility(device=DEVICE)
    torch.cuda.synchronize()
    replay, warmup = prng.replay_split_chain, api.run_warmup
    recording = prng.replay_split_chain = _Recording(replay)
    capture = api.run_warmup = _WarmupCapture(warmup)
    _reset_counts()
    t0 = time.perf_counter()
    try:
        out, info = wtt.walnuts(
            logp, num_params=dim, num_chains=SV_CHAINS, dtype=torch.float32,
            seed=SEED + 20, device=DEVICE, min_warmup_iter=SV_WARMUP,
            max_warmup_iter=SV_WARMUP, min_sampling_iter=SV_MAIN_SAMPLING,
            max_sampling_iter=SV_MAIN_SAMPLING, block_size=50, runahead=8,
            tier2_every=12, max_step_halvings=HALVINGS, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        prng.replay_split_chain, api.run_warmup = replay, warmup
    launches = _counts()
    if launches["replay_split_chain"] <= 0:
        raise AssertionError("the SV path never launched replay_split_chain")
    main = np.stack([np.asarray(c) for c in out], axis=1)
    if main.shape != (SV_MAIN_SAMPLING, SV_CHAINS, dim) or not np.isfinite(main).all():
        raise AssertionError(f"SV path: bad draws of walnuts(): {main.shape}")
    print(f"[SV path] stochastic_volatility() (D = {dim}) x {SV_CHAINS} chains, "
          f"float32, {SV_WARMUP} + {SV_MAIN_SAMPLING} iterations, block 50, "
          f"runahead 8, tier2_every 12, max_step_halvings {HALVINGS}: wall "
          f"{wall:.3f} s; launches {json.dumps(launches)}  [{card}]")
    _print_phases("SV path", info, card)

    logp_grad = make_logp_grad(logp)
    params, ss = freeze_params(capture.state), init_sample_state(capture.state)
    scfg = SamplingConfig(min_iter=SV_SAMPLING, max_iter=SV_SAMPLING, block_size=50,
                          max_step_halvings=HALVINGS)
    cubes, recorded = {}, None
    for name in ("unfused", "fused"):
        pass_fn = batched.fused_pass
        if name == "fused":
            batched.fused_pass = recorded = _PassRecording(pass_fn, SV_PASS_EVERY)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        try:
            _, d, _, sinfo = run_sampling(logp_grad, ss, params, scfg, batched=True,
                                          device_draws=True,
                                          runahead=8, tier2_every=12,
                                          pallas_pass=name == "fused")
            torch.cuda.synchronize()
        finally:
            batched.fused_pass = pass_fn
        wall = time.perf_counter() - t0
        counts = _counts()
        cubes[name] = d
        print(f"[SV path] {SV_SAMPLING} sampling iterations from the warmed state, "
              f"{name} pass: wall {wall:.3f} s, {sinfo.n_inner_trips['sampling']} "
              f"trips, {sinfo.n_outer_trips['sampling']} tier-2 passes, "
              f"{sinfo.n_syncs['sampling']} syncs; launches {json.dumps(counts)}"
              f"  [{card}]")
        if name == "fused":
            launches["fused_pass"] = counts["fused_pass"]
    if launches["fused_pass"] <= 0:
        raise AssertionError("the SV path's fused run never launched fused_pass")
    d_u, d_f = cubes["unfused"], cubes["fused"]
    if not bool(torch.isfinite(d_f).all()):
        raise AssertionError("SV path: draws are not finite")
    if not torch.equal(d_u, d_f):
        bad = float((d_u != d_f).any(-1).float().mean())
        raise AssertionError(f"SV path: the fused pass's draws differ from the "
                             f"unfused pass's ({bad:.4f} of the chain draws)")
    print(f"[SV path] draws of the unfused and the fused pass bitwise equal "
          f"({tuple(d_f.shape)}), all finite  [{card}]")

    # the device-resident cube's ESS, against the host estimator
    cube = d_f.movedim(0, 1)  # (C, N, D), a view
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ess_dev = effective_sample_size_device_chunked(cube.double())
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    ess_f32 = effective_sample_size_device_chunked(cube)
    sub = cube[:, :, list(SV_ESS_DIMS)].double().cpu().numpy()
    t0 = time.perf_counter()
    ess_host = summary.effective_sample_size([sub[c] for c in range(sub.shape[0])])
    host_s = time.perf_counter() - t0
    got = ess_dev[list(SV_ESS_DIMS)].cpu().numpy()
    rel = float(np.max(np.abs(got - ess_host) / np.abs(ess_host)))
    rel32 = float((ess_f32.double() - ess_dev).abs().div(ess_dev.abs()).max())
    print(f"[SV path] device ESS of the cube (float64 on the card, all {dim} "
          f"dimensions, chunks of 64: {dev_s:.3f} s) against the host estimator "
          f"on dimensions {list(SV_ESS_DIMS)} ({host_s:.3f} s): max relative "
          f"difference {rel:.3e} (limit 1e-4); the float32 cube's device ESS "
          f"differs from float64's by up to {rel32:.3e} (reported only); median "
          f"ESS {float(ess_dev.median()):.1f}, min {float(ess_dev.min()):.1f}  [{card}]")
    if rel > 1e-4:
        raise AssertionError("SV path: device ESS disagrees with the host's")

    # live chains (moved at all) and the hyperparameters' pooled moments
    hyper = d_f[:, :, :3].movedim(0, 1).double().cpu().numpy()  # (C, N, 3)
    _, live, _ = parity.chain_autocorr_stats(hyper)
    h = hyper[live]
    mu, phi, sigma = h[..., 0], np.tanh(h[..., 1]), np.exp(h[..., 2])
    print(f"[SV path] live chains (moved in the fused run) {live.mean():.4f} of "
          f"{SV_CHAINS}; over them: mu {mu.mean():.4f} +- {mu.std():.4f}, phi "
          f"{phi.mean():.4f} +- {phi.std():.4f}, sigma {sigma.mean():.4f} +- "
          f"{sigma.std():.4f} (the data's generating values -1, 0.97, 0.25; "
          f"reported only)  [{card}]")
    path = {"replay_split_chain": path_replay_ms(card, recording.calls, "SV path"),
            "fused_pass": path_pass_ms(card, recorded.calls, SV_PASS_EVERY,
                                       "SV path")}
    return launches, path


class _Preempted(Exception):
    """The crash the checkpoint path stages on purpose."""


class _SaveTimer:
    """Times every call of ``BlockCheckpointer.save``: ``method`` stands
    in for it on the class."""

    def __init__(self, real):
        self.calls, self.seconds = 0, 0.0

        def method(ckpt, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(ckpt, *args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

        self.method = method


def _ckpt_kwargs(dim: int) -> dict:
    """``walnuts``' arguments on the checkpoint path (and the mesh path)."""
    return dict(fused=True, num_params=dim, num_chains=CHAINS, dtype=torch.float32,
                seed=CKPT_SEED, device=DEVICE, min_warmup_iter=CKPT_ITERS,
                max_warmup_iter=CKPT_ITERS, min_sampling_iter=CKPT_ITERS,
                max_sampling_iter=CKPT_ITERS, block_size=CKPT_BLOCK,
                max_step_halvings=HALVINGS, save_inv_metric=True, return_info=True)


def _result(out, info, wall: float) -> dict:
    """What the checkpoint and mesh paths compare of a run."""
    return dict(draws=np.stack([np.asarray(c) for c in out], axis=1),
                stepsize=np.array([c.warmup.stepsize for c in out]),
                inv_metric=np.stack([c.warmup.inv_metric for c in out]),
                n_grads=np.asarray(info.n_grads), wall=np.asarray(wall))


def _same(x: dict, y: dict) -> dict:
    """Which of two runs' results are equal bit for bit."""
    return {k: bool(np.array_equal(x[k], y[k]))
            for k in ("draws", "stepsize", "inv_metric", "n_grads")}


class _Recorded:
    """Kernels 1 and 2 recorded while the body runs (every replay launch,
    every LOGREG_KEEP_EVERY-th logistic-regression launch): ``replay`` and
    ``logreg`` hold the recordings."""

    def __enter__(self):
        from walnuts_tpu_torch.ops import logreg_fused, prng

        self._real = prng.replay_split_chain, logreg_fused.logreg_value_grad
        self.replay = prng.replay_split_chain = _Recording(self._real[0])
        self.logreg = logreg_fused.logreg_value_grad = _Recording(
            self._real[1], every=LOGREG_KEEP_EVERY)
        return self

    def __exit__(self, *exc):
        from walnuts_tpu_torch.ops import logreg_fused, prng

        prng.replay_split_chain, logreg_fused.logreg_value_grad = self._real

    def path_ms(self, card: str, path: str) -> dict:
        return recorded_path_ms(card, self.replay.calls, self.logreg.calls, path)


def recorded_path_ms(card: str, replay_calls, logreg_calls, path: str) -> dict:
    """Kernels 1 and 2's time and bound a launch on a recorded path (both
    relaunched in one profiler window)."""
    from walnuts_tpu_torch.ops import logreg_fused, prng

    def relaunch():
        for a in replay_calls:
            prng.replay_split_chain(*a)
        for a in logreg_calls:
            logreg_fused.logreg_value_grad(*a)

    ms = profiled_ms_each(relaunch, ("replay_kernel", "logreg_kernel"), reps=1)
    return {"replay_split_chain": path_replay_ms(card, replay_calls, path,
                                                 ms["replay_kernel"]),
            "logreg_value_grad": path_logreg_ms(card, logreg_calls, path,
                                                ms["logreg_kernel"])}


def run_checkpoint_path(card: str) -> tuple:
    """``walnuts()`` on the main path's model (kernel 2, ``fused=True``) at
    CKPT_ITERS + CKPT_ITERS iterations in blocks of CKPT_BLOCK, three
    times: (a) with no checkpoint; (b) with ``checkpoint_dir``, crashed
    (an exception) right after its first sampling block is saved; (c)
    resumed from (b)'s directory. (a) and (c) must be equal bit for bit:
    draws, step sizes, inverse metrics and ``n_grads``. Returns the
    launches of kernels 1 and 2 over the three runs, their time and bound
    a launch on (a) (recorded there, relaunched after the three runs), and
    (a)'s result for the mesh path."""
    import shutil
    import tempfile

    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused
    from walnuts_tpu_torch.parallel.checkpoint import BlockCheckpointer

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    kw = _ckpt_kwargs(dim)

    def timed(**extra):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = wtt.walnuts(logp_grad, **kw, **extra)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _reset_counts()
    with _Recorded() as recorded:
        (plain, info_a), wall_a = timed()
    directory = tempfile.mkdtemp(prefix="walnuts-ckpt-")
    real_block, real_save = BlockCheckpointer.block, BlockCheckpointer.save
    saves = _SaveTimer(real_save)
    BlockCheckpointer.save = saves.method

    def block_then_crash(ckpt, phase, it, *args, **kwargs):
        # the process dies right after the first sampling block is saved
        real_block(ckpt, phase, it, *args, **kwargs)
        if (phase, it) == ("sampling", CKPT_BLOCK):
            raise _Preempted()

    try:
        BlockCheckpointer.block = block_then_crash
        t0 = time.perf_counter()
        try:
            wtt.walnuts(logp_grad, checkpoint_dir=directory, **kw)
        except _Preempted:
            wall_b = time.perf_counter() - t0
        else:
            raise AssertionError("checkpoint path: the staged crash was not raised")
        finally:
            BlockCheckpointer.block = real_block
        saves_b, save_s_b = saves.calls, saves.seconds
        (resumed, info_c), wall_c = timed(checkpoint_dir=directory)
        slot = sum(os.path.getsize(os.path.join(directory, s, "state.pt"))
                   for s in ("state_a", "state_b")) / 2
    finally:
        BlockCheckpointer.save = real_save
        shutil.rmtree(directory, ignore_errors=True)
    launches = _counts()
    for name in ("replay_split_chain", "logreg_value_grad"):
        if launches[name] <= 0:
            raise AssertionError(f"the checkpoint path never launched {name}")

    res_a, res_c = _result(plain, info_a, wall_a), _result(resumed, info_c, wall_c)
    a, c = res_a["draws"], res_c["draws"]
    if a.shape != (CKPT_ITERS, CHAINS, DIM) or not np.isfinite(a).all():
        raise AssertionError(f"checkpoint path: bad draws: shape {a.shape}")
    same = _same(res_a, res_c)
    chains_same = int(np.all(a == c, axis=(0, 2)).sum())
    print(f"[checkpoint path] logreg({DIM}) x {CHAINS} chains, fused, float32, "
          f"{CKPT_ITERS} + {CKPT_ITERS} iterations, blocks of {CKPT_BLOCK}: (a) "
          f"uninterrupted {wall_a:.3f} s; (b) checkpointed, crashed after its "
          f"first sampling block {wall_b:.3f} s ({saves_b} saves, "
          f"{save_s_b / saves_b * 1e3:.2f} ms a save, the block's draws and a "
          f"state slot of {slot / 2**20:.3f} MiB); (c) resumed {wall_c:.3f} s "
          f"({saves.calls - saves_b} saves, "
          f"{(saves.seconds - save_s_b) / max(saves.calls - saves_b, 1) * 1e3:.2f} ms "
          f"a save)  [{card}]")
    print(f"[checkpoint path] (c) against (a), bit for bit: {json.dumps(same)}; "
          f"chains with equal draws {chains_same} of {CHAINS}; launches over the "
          f"three runs {json.dumps(launches)}  [{card}]")
    if not all(same.values()):
        raise AssertionError("checkpoint path: the resumed run is not the "
                             "uninterrupted one bit for bit")
    return launches, recorded.path_ms(card, "checkpoint path"), res_a


def mesh_rank(card: str, rank: int, world: int, backend: str, init: str) -> dict:
    """One rank of the mesh path: the checkpoint path's run (a) under
    ``init_device_mesh("cuda", (world,), mesh_dim_names=("chains",))`` over
    a ``backend`` process group (rendezvous ``init``), every rank on the
    one card. Returns the whole result the rank got, its wall, its launches
    of kernels 1 and 2 (this process's counts) and their recorded operands
    on its shard (``calls``, for ``recorded_path_ms``)."""
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused

    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            timeout=timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = init_device_mesh(torch.device(DEVICE).type, (world,),
                                mesh_dim_names=("chains",))
        t_mesh = time.perf_counter() - t_start
        logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
        _reset_counts()
        with _Recorded() as recorded:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, info = wtt.walnuts(logp_grad, mesh=mesh, **_ckpt_kwargs(dim))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _counts()
        print(f"[mesh path] {backend} rank {rank} of {world}, {CHAINS // world} "
              f"chains: wall {wall:.3f} s (the process group and the mesh "
              f"{t_mesh:.3f} s before it), launches {json.dumps(launches)}  [{card}]")
        for name in ("replay_split_chain", "logreg_value_grad"):
            if launches[name] <= 0:
                raise AssertionError(f"mesh path: {backend} rank {rank} never "
                                     f"launched {name}")
    finally:
        dist.destroy_process_group()
    return dict(_result(out, info, wall), launches=launches,
                calls=(recorded.replay.calls, recorded.logreg.calls))


def run_mesh_path(card: str, plain: dict) -> dict:
    """The checkpoint path's run (a) with its chains sharded: (i) over
    MESH_WORLD gloo ranks, each a process of this script
    (``--mesh-rank``), sharing the card (NCCL refuses two ranks on one
    device); (ii) over one NCCL rank in this process. Every rank's whole
    result must be (a)'s bit for bit (a chain's arithmetic does not depend
    on the chain count: kernel 2 sums a chain's rows in a fixed order
    whatever the batch, kernel 1 is integer work); every rank must launch
    kernels 1 and 2. Each rank's kernels are timed here after the runs, on
    the operands it recorded (a gloo rank's through a file: a process's
    first profiler window costs seconds). Returns the launches and times a
    launch of each run, by kernel."""
    import sys
    import tempfile

    results = {}
    with tempfile.TemporaryDirectory(prefix="walnuts-mesh-") as d:
        logs = [os.path.join(d, f"rank{r}.log") for r in range(MESH_WORLD)]
        procs = []
        t0 = time.perf_counter()
        try:
            for r in range(MESH_WORLD):
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                         str(r), "--mesh-world", str(MESH_WORLD), "--mesh-init",
                         f"file://{d}/rendezvous", "--mesh-out", d],
                        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + MESH_TIMEOUT_S
            while (any(p.poll() is None for p in procs)
                   and all(p.poll() in (None, 0) for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        wall_procs = time.perf_counter() - t0
        for r, p in enumerate(procs):
            with open(logs[r]) as f:
                text = f.read()
            if p.returncode != 0:
                raise AssertionError(f"mesh path: gloo rank {r} exited "
                                     f"{p.returncode}:\n{text[-6000:]}")
            print("\n".join(ln for ln in text.splitlines() if ln.startswith("[")))
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                res = {k: z[k] for k in z.files if k != "meta"}
                res.update(json.loads(str(z["meta"])))
            calls = torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=True)
            res["calls"] = [[tuple(t.to(DEVICE) for t in a) for a in c] for c in calls]
            results[f"gloo rank {r}"] = res
    print(f"[mesh path] {MESH_WORLD} gloo ranks: {wall_procs:.3f} s from their "
          f"start to their end (process start and the kernels' load "
          f"included)  [{card}]")
    with tempfile.TemporaryDirectory(prefix="walnuts-nccl-") as d:
        results["nccl rank 0"] = mesh_rank(card, 0, 1, "nccl", f"file://{d}/rendezvous")
    bad = []
    for what, res in results.items():
        res["path"] = recorded_path_ms(card, *res.pop("calls"), f"mesh path, {what}")
        same = _same(res, plain)
        equal = int(np.all(res["draws"] == plain["draws"], axis=(0, 2)).sum())
        diff = float(np.abs(res["draws"].astype(np.float64) - plain["draws"]).max())
        print(f"[mesh path] {what}: wall {float(res['wall']):.3f} s against (a)'s "
              f"{float(plain['wall']):.3f} s; its whole result against (a), bit for "
              f"bit: {json.dumps(same)}; chains with equal draws {equal} of "
              f"{CHAINS}, max abs draw difference {diff:.3e}  [{card}]")
        if not all(same.values()):
            bad.append(what)
    if bad:
        raise AssertionError(f"mesh path: {bad} not (a) bit for bit")
    return {name: {"launches_mesh": {w: r["launches"][name] for w, r in results.items()},
                   "path_ms_mesh": {w: r["path"][name]["path_ms"]
                                    for w, r in results.items()},
                   "path_bound_ms_mesh": {w: r["path"][name]["path_bound_ms"]
                                          for w, r in results.items()}}
            for name in ("replay_split_chain", "logreg_value_grad")}


class _HostTimer:
    """Stands in for ``api.host_model``: the models it makes time each
    call on the host (after a device synchronize, so that earlier device
    work is not counted)."""

    def __init__(self, real):
        self.real, self.calls, self.seconds = real, 0, 0.0

    def __call__(self, evaluate):
        model = self.real(evaluate)

        def timed(theta):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model(theta)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        return timed


def run_host_model_path(card: str) -> dict:
    """The host-model entry points on the card: ``walnuts_stan`` on the
    eight-schools BridgeStan-ABI model (``csrc/abi_models.cpp``, through
    the port's native bridge) x HOST_CHAINS, float64, against the port's
    autograd ``walnuts(eight_schools())`` at the same seed (the share of
    chains with equal ``n_grads`` at least HOST_SHARE, ``mu`` to rtol /
    atol 1e-3 on those); then ``walnuts_pyfunc`` with the ``(ctypes_cfunc,
    data)`` form of ``csrc/callback_model.c`` (a standard normal, D =
    PYFUNC_DIM) x PYFUNC_CHAINS: every coordinate's pooled mean within 0.1
    of 0, its sd within 10 % of 1. Returns kernel 1's launches on the two
    host-model runs, and its time and bound a launch there (every launch
    recorded, relaunched after the runs)."""
    import ctypes

    import walnuts_tpu_torch as wtt
    import walnuts_tpu_torch.api as api
    from walnuts_tpu_torch.models import eight_schools
    from walnuts_tpu_torch.ops import prng
    from walnuts_tpu_torch.ops._cuda import build_host

    t0 = time.perf_counter()
    so = build_host(ROOT / "csrc" / "abi_models.cpp",
                    defines=("ABI_MODEL_EIGHT_SCHOOLS",))
    cb = build_host(ROOT / "csrc" / "callback_model.c")
    from walnuts_tpu_torch.models.stan import build_bridge

    bridge = build_bridge()
    print(f"[host model] g++ / gcc builds {time.perf_counter() - t0:.2f} s -> "
          f"{so}, {cb}, {bridge}  [{card}]")
    kw = dict(seed=HOST_SEED, num_chains=HOST_CHAINS, dtype=torch.float64,
              device=DEVICE, min_warmup_iter=HOST_ITERS, max_warmup_iter=HOST_ITERS,
              min_sampling_iter=HOST_ITERS, max_sampling_iter=HOST_ITERS,
              return_info=True)
    real, replay = api.host_model, prng.replay_split_chain
    recording = prng.replay_split_chain = _Recording(replay)
    timers, launches, walls, infos = [], 0, [], []
    try:
        for what in ("stan", "pyfunc"):
            timer = api.host_model = _HostTimer(real)
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if what == "stan":
                out_s, info = wtt.walnuts_stan(str(so), **kw)
            else:
                lib = ctypes.CDLL(str(cb))
                proto = ctypes.CFUNCTYPE(
                    ctypes.c_int, ctypes.c_size_t, ctypes.POINTER(ctypes.c_double),
                    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
                    ctypes.c_void_p)
                out_p, info = wtt.walnuts_pyfunc(
                    (proto(("logp_cb", lib)), None), num_params=PYFUNC_DIM,
                    **{**kw, "num_chains": PYFUNC_CHAINS, "seed": HOST_SEED + 1,
                       "dtype": torch.float32})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            timers.append(timer)
            infos.append(info)
            n = _counts()["replay_split_chain"]
            if n <= 0:
                raise AssertionError(f"the {what} run never launched replay_split_chain")
            launches += n
    finally:
        api.host_model, prng.replay_split_chain = real, replay

    logp, dim = eight_schools(device=DEVICE)
    t0 = time.perf_counter()
    out_a, info_a = wtt.walnuts(logp, num_params=dim, **kw)
    wall_a = time.perf_counter() - t0
    equal = infos[0].n_grads == info_a.n_grads
    share = float(equal.mean())
    mu_s = np.stack([o["mu"] for o in out_s], axis=1)
    mu_a = np.stack([np.asarray(o)[:, 0] for o in out_a], axis=1)
    if (not np.isfinite(mu_s).all()) or mu_s.shape != (HOST_ITERS, HOST_CHAINS):
        raise AssertionError(f"host model path: bad Stan draws {mu_s.shape}")
    off = ~np.isclose(mu_s[:, equal], mu_a[:, equal], rtol=1e-3, atol=1e-3)
    tau = np.stack([o["tau"] for o in out_s])
    for what, timer, wall, info in zip(("stan", "pyfunc"), timers, walls, infos):
        trips = info.n_inner_trips["warmup"] + info.n_inner_trips["sampling"]
        secs = info.seconds["warmup"] + info.seconds["sampling"]
        print(f"[host model] {what}: wall {wall:.3f} s; {timer.calls} model calls, "
              f"{timer.seconds / timer.calls * 1e3:.3f} ms a call on the host "
              f"(copies included) against {secs / trips * 1e3:.3f} ms a trip "
              f"({trips} trips in {secs:.3f} s)  [{card}]")
    print(f"[host model] eight schools x {HOST_CHAINS}, float64, {HOST_ITERS} + "
          f"{HOST_ITERS}: walnuts_stan against the autograd model ({wall_a:.3f} s): "
          f"{share:.4f} of the chains with equal n_grads (limit {HOST_SHARE}); on "
          f"those, mu off rtol / atol 1e-3 at {int(off.sum())} of {off.size} draws; "
          f"tau > 0: {bool((tau > 0).all())}; kernel 1 launches on the two "
          f"host-model runs {launches}  [{card}]")
    if share < HOST_SHARE or off.any() or not (tau > 0).all():
        raise AssertionError("host model path: walnuts_stan disagrees with autograd")
    d = np.stack([np.asarray(o) for o in out_p], axis=1).reshape(-1, PYFUNC_DIM)
    mean, sd = d.mean(0), d.std(0)
    print(f"[host model] pyfunc standard normal D = {PYFUNC_DIM} x {PYFUNC_CHAINS}: "
          f"pooled |mean| up to {np.abs(mean).max():.4f} (limit 0.1), sd in "
          f"[{sd.min():.4f}, {sd.max():.4f}] (limit 1 +- 0.1)  [{card}]")
    if not np.isfinite(d).all() or np.abs(mean).max() > 0.1 or np.abs(sd - 1).max() > 0.1:
        raise AssertionError("host model path: pyfunc moments off")
    return ({"replay_split_chain": launches},
            path_replay_ms(card, recording.calls, "host-model path"))


def run_profile_and_cli(card: str) -> None:
    """``walnuts(profile_dir=...)`` on the main path's model (PROFILE_ITERS
    + PROFILE_ITERS iterations): the Chrome trace must name the replay and the
    logistic-regression kernels. Meanwhile ``python -m
    walnuts_tpu_torch.cli`` on funnel(25) x 8 runs in a subprocess: exit 0
    and its table."""
    import glob
    import sys
    import tempfile

    from torch.profiler import profile

    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused

    cmd = [sys.executable, "-m", "walnuts_tpu_torch.cli", "--model", "funnel",
           "--dim", "25", "--chains", "8", "--warmup", "20", "--sampling", "20",
           "--device", DEVICE]
    t_cli = time.perf_counter()
    cli = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
        real_export, export_s = profile.export_chrome_trace, []

        def timed_export(prof, path):
            t0 = time.perf_counter()
            try:
                return real_export(prof, path)
            finally:
                export_s.append(time.perf_counter() - t0)

        with tempfile.TemporaryDirectory(prefix="walnuts-prof-") as d:
            profile.export_chrome_trace = timed_export
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                wtt.walnuts(logp_grad, fused=True, num_params=dim, num_chains=CHAINS,
                            dtype=torch.float32, seed=SEED + 60, device=DEVICE,
                            min_warmup_iter=PROFILE_ITERS, max_warmup_iter=PROFILE_ITERS,
                            min_sampling_iter=PROFILE_ITERS,
                            max_sampling_iter=PROFILE_ITERS, block_size=PROFILE_ITERS,
                            max_step_halvings=HALVINGS, profile_dir=d)
            finally:
                profile.export_chrome_trace = real_export
            wall = time.perf_counter() - t0
            traces = glob.glob(os.path.join(d, "walnuts-*.pt.trace.json"))
            if len(traces) != 1:
                raise AssertionError(f"profile_dir: {len(traces)} trace files")
            found = dict.fromkeys(("replay_kernel", "logreg_kernel"), 0)
            with open(traces[0]) as f:  # in pieces: the trace runs to GiB
                tail = ""
                while chunk := f.read(1 << 26):
                    text = tail + chunk
                    for k in found:
                        found[k] += text.count(k) - tail.count(k)
                    tail = text[-64:]
            size = os.path.getsize(traces[0])
        print(f"[profile_dir] {PROFILE_ITERS} + {PROFILE_ITERS} iterations with "
              f"profile_dir: wall {wall:.3f} s, "
              f"of which the trace's export {sum(export_s):.3f} s; "
              f"{os.path.basename(traces[0])} {size / 2**20:.1f} MiB, kernel names "
              f"found {json.dumps(found)} (the CLI ran beside it)  [{card}]")
        if not all(found.values()):
            raise AssertionError("profile_dir: the trace misses a kernel")
        stdout, stderr = cli.communicate(timeout=600)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    wall = time.perf_counter() - t_cli
    lines = stdout.splitlines()
    if (cli.returncode != 0 or not lines or lines[0].split()[:2] != ["parameter", "mean"]
            or "gradient evaluations:" not in stdout):
        raise AssertionError(f"CLI failed (exit {cli.returncode}):\n{stdout}\n"
                             f"{stderr[-4000:]}")
    profile_lines = [ln for ln in lines if ln.startswith(("total wall", "gradient eval",
                                                          "chains:"))]
    print(f"[cli] {' '.join(cmd[1:])}: exit 0, done {wall:.3f} s after its start "
          f"(process start included, beside the profile_dir run); {len(lines)} "
          f"lines; {' | '.join(profile_lines)}  [{card}]")


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


def _phase(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler window and print kernel times")
    parser.add_argument("--ab", action="store_true",
                        help="sample the fused route's warmed state four times, "
                        "unfused, fused, fused, unfused")
    parser.add_argument("--options", action="store_true",
                        help="run the options path alone (kernels 1, 2 and 3)")
    parser.add_argument("--mesh-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--mesh-init", help=argparse.SUPPRESS)
    parser.add_argument("--mesh-out", help=argparse.SUPPRESS)
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    card = card_label()
    if args.mesh_rank is not None:  # a gloo rank of the mesh path
        res = mesh_rank(card, args.mesh_rank, args.mesh_world, "gloo", args.mesh_init)
        torch.save([[tuple(t.cpu() for t in a) for a in c] for c in res.pop("calls")],
                   os.path.join(args.mesh_out, f"rank{args.mesh_rank}.pt"))
        np.savez(os.path.join(args.mesh_out, f"rank{args.mesh_rank}.npz"),
                 meta=json.dumps({"launches": res.pop("launches")}), **res)
        return
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    from walnuts_tpu_torch.models.targets import logistic_regression_data
    from walnuts_tpu_torch.ops import _cuda

    if args.options:
        t0 = time.perf_counter()
        _cuda.build("replay", "logreg", "integrator")
        print(f"[build] replay, logreg, integrator: {time.perf_counter() - t0:.1f} s")
        warmed = _phase("fused route's warmup", warmed_state)
        print(json.dumps(_phase("options path", run_options_path, card, warmed)))
        return
    names = ("replay", "logreg", "fused_pass", "integrator", "fused_transition")
    t0 = time.perf_counter()
    _cuda.build(*names)
    print(f"[build] {len(names)} libraries, one nvcc each in parallel: "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        _cuda.library(name)
        b = _cuda.BUILD_INFO[name]
        print(f"[build] {name}: {b['seconds']:.2f} s -> {b['path']}")
        for kernel, regs, spill in ptxas_report(b["log"]):
            print(f"[build]   {kernel}: {regs} registers, {spill} bytes spill stores")

    t0 = time.perf_counter()
    empty = check_empty(card)
    kernels = [check_replay(card), check_logreg(card), check_fused_pass(card, DIM)]
    kernels[0].update(empty)
    wide = check_fused_pass(card, 101)
    kernels[2].update(ms_d101=wide["ms"], bound_ms_d101=wide["bound_ms"])
    sv_wide = check_fused_pass(card, 1003, SV_CHAINS)
    kernels[2].update(ms_d1003=sv_wide["ms"], bound_ms_d1003=sv_wide["bound_ms"])
    for body in ("std_normal", "ill_conditioned_normal", "funnel"):
        check_integrator(card, body)
    kernels.append(check_integrator(card, "logistic_regression"))
    shares = {}
    for body in ("std_normal", "ill_conditioned_normal", "funnel", "logistic_regression"):
        checked = check_transition(card, body)
        shares[body] = " / ".join(f"{k['ms']:.4f} ms, {k['bound_ms'] / k['ms']:.4f}"
                                  for k in checked)
    kernels.extend(checked)
    print(f"[transition] 5a / 5b ({BLOCK_CHECK_DRAWS} draws) at C={CHAINS}, each "
          f"body's time and share of its bound: {json.dumps(shares)}  [{card}]")
    print(f"[phase] kernel checks: {time.perf_counter() - t0:.1f} s")
    ref = laplace(*logistic_regression_data(ROWS, DIM))
    launches, path = _phase("main path", run_main_path, card, ref)
    path = {"replay_split_chain": path}
    order = ("unfused", "fused", "fused", "unfused") if args.ab else ("unfused", "fused")
    route_launches, warmed, path["fused_pass"] = _phase(
        "fused route", run_fused_route, card, ref, order=order)
    launches["fused_pass"] = route_launches["fused_pass"]
    launches["integrator"] = _phase("classic path", run_classic_path, card, ref)
    classic = _phase("classic A/B", run_classic_ab, card, warmed)
    options = _phase("options path", run_options_path, card, warmed)
    path_launches, path_t = _phase("transition path", run_transition_path, card, ref,
                                   warmed)
    path.update(path_t, integrator=classic[2])
    launches.update({k: path_launches[k]
                     for k in ("fused_transition", "fused_sample_block")})
    _phase("transition A/B", run_transition_ab, card, warmed, classic)
    # the other paths' launches and times under keys of their own
    extra = {k["name"]: dict(options.get(k["name"], {})) for k in kernels}
    f_launches, f_path = _phase("funnel path", run_funnel_path, card)
    extra["replay_split_chain"].update(launches_funnel=f_launches["replay_split_chain"],
                                       path_ms_funnel=f_path["path_ms"],
                                       path_bound_ms_funnel=f_path["path_bound_ms"])
    s_launches, s_path = _phase("SV path", run_sv_path, card)
    extra["replay_split_chain"].update(
        launches_sv=s_launches["replay_split_chain"],
        path_ms_sv=s_path["replay_split_chain"]["path_ms"],
        path_bound_ms_sv=s_path["replay_split_chain"]["path_bound_ms"])
    extra["fused_pass"].update(
        launches_sv=s_launches["fused_pass"],
        path_ms_sv=s_path["fused_pass"]["path_ms"],
        path_bound_ms_sv=s_path["fused_pass"]["path_bound_ms"])
    c_launches, c_path, plain = _phase("checkpoint path", run_checkpoint_path, card)
    for name in ("replay_split_chain", "logreg_value_grad"):
        extra[name].update(launches_ckpt=c_launches[name],
                           path_ms_ckpt=c_path[name]["path_ms"],
                           path_bound_ms_ckpt=c_path[name]["path_bound_ms"])
    for name, m in _phase("mesh path", run_mesh_path, card, plain).items():
        extra[name].update(m)
    h_launches, h_path = _phase("host model path", run_host_model_path, card)
    extra["replay_split_chain"].update(
        launches_host_model=h_launches["replay_split_chain"],
        path_ms_host_model=h_path["path_ms"],
        path_bound_ms_host_model=h_path["path_bound_ms"])
    _phase("profile_dir and CLI", run_profile_and_cli, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k.update(path.get(k["name"], {}), **extra[k["name"]])
    if args.profile:
        _phase("profile window", profile_window, card)
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s in all  [{card}]")
    # the contract's keys, then kernel 2's matrix products, the time and
    # bound of a launch on the kernel's own path where they differ from the
    # check's synthetic inputs (kernels 3, 5a, 5b), and the warps a
    # logistic-regression chain is split over (5a, 5b)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "matmul_ms",
            "path_ms", "path_bound_ms", "group_warps", "empty_queued_ms",
            "empty_single_ms", "host_ms", "ms_d101", "bound_ms_d101", "ms_d1003",
            "bound_ms_d1003", "launches_funnel", "path_ms_funnel",
            "path_bound_ms_funnel", "launches_sv", "path_ms_sv", "path_bound_ms_sv",
            "launches_options", "path_ms_options", "path_bound_ms_options",
            "launches_ckpt", "path_ms_ckpt", "path_bound_ms_ckpt", "launches_mesh",
            "path_ms_mesh", "path_bound_ms_mesh", "launches_host_model",
            "path_ms_host_model", "path_bound_ms_host_model")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
