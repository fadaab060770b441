"""Time launch geometries of the port's kernels on a card.

Kernel 2 (``walnuts_tpu_torch/csrc/logreg.cu``) and the logistic-regression
body of kernel 3 (``csrc/integrator.cu``) and of kernels 5a and 5b
(``csrc/fused_transition.cu``), all three through ``csrc/logreg_chain.cuh``,
are templates over their warps per block. This script builds one library
per source that includes it and exports a launcher per warp count (kernel
2 also without its log-sigmoid terms: the two products alone), then times
each with CUDA events behind a sleep kernel, holds it against a reference,
and prints ptxas' registers and spill stores for it:

- kernel 2 at ``chip_smoke.py``'s shapes (theta 4096 x 25, X 1000 x 25),
  against its plain version;
- kernel 3 on the synthetic attempt of 4096 chains (n_steps in 0..256),
  against its plain version;
- 5a and 5b on ``chip_smoke.py``'s transition path: the fused route's warmed
  state (4096 chains, 50 warmup iterations), 5b one launch of 100 draws
  (timed three times after two launches that are not, so that the measured
  order has launches to learn from and the schedule's first sort is not
  timed), 5a 20 launches of one draw, at every warps per block and every
  group of warps a chain (the harness sets the group the entry points fix),
  at 8 warps also with the chains in index order and in the order of a
  cost proxy (``min_micro`` descending, then ``step`` ascending), each
  against the first geometry's chains, with where a 5b launch's time went
  (the kernel's per-chain trace);
- ``pass``: the fused tier-2 pass (kernel 4, ``csrc/fused_pass.cu``) at each
  ``pass_tile`` on ``chip_smoke.py``'s synthetic state at D = 25 and 101,
  each with a traced launch (where its chains' time went), and the replay
  (kernel 1, ``csrc/replay.cu``) beside an empty kernel and the SM cycles
  of a threefry hash and of a replay round; with ``--parent DIR`` (a tree
  holding another ``walnuts_tpu_torch/``, e.g. the parent commit's, from
  ``git archive``) also that tree's kernels 4 and 1, built from its sources:
  their outputs compared with these bit for bit, their times and the fused
  pass wrappers' host times taken in turns.

The geometry the sources launch is marked ``*``. Needs ``nvcc`` and a CUDA
card.

Run from the root of a checkout:
``python3 tools/torch_logreg_sweep.py [part ...] [--parent DIR]`` with parts
among ``logreg``, ``integrator``, ``transition``, ``pass`` (default: all).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from walnuts_tpu_torch.models import kernels  # noqa: E402
from walnuts_tpu_torch.models.targets import logistic_regression_data  # noqa: E402
from walnuts_tpu_torch.ops import _cuda  # noqa: E402
from walnuts_tpu_torch.ops import fused_transition as ft  # noqa: E402
from walnuts_tpu_torch.ops import integrator as integ  # noqa: E402
from walnuts_tpu_torch.ops import prng  # noqa: E402
from walnuts_tpu_torch.ops.logreg_fused import (  # noqa: E402
    logreg_value_grad,
    logreg_value_grad_plain,
)

CHAINS, DIM, ROWS = 4096, 25, 1000
KP = 28  # DIM rounded up to 4
LEAD_CYCLES = 20_000_000

# warps per block; the first is the count the source launches. Kernel 2's
# second entry: False leaves out the log-sigmoid terms (the two products
# alone, not a correct result)
LOGREG_GEOMETRIES = [(16, True), (16, False), (8, True), (12, True)]
INTEGRATOR_GEOMETRIES = [(16,), (8,), (12,)]
# 5a / 5b: warps per block, and warps a chain; the first warp count is the
# one the source launches
TRANSITION_GEOMETRIES = [(8, 1), (8, 2), (8, 4), (16, 1), (16, 2), (16, 4),
                         (12, 1), (12, 2), (12, 4), (6, 1), (6, 2), (4, 1),
                         (4, 2), (4, 4)]
# the orders the 8-warp geometries also run in (the others: measured only)
ORDERS = ("measured", "index", "cost")

_HARNESS = {
    "logreg": """#include "{src}"
extern "C" int sweep(int v, const void* theta, const void* x, const void* y,
                     void* lp, void* grad, int B, int P, int N, void* stream) {{
  const float *t = static_cast<const float*>(theta), *xx = static_cast<const float*>(x),
              *yy = static_cast<const float*>(y);
  float *l = static_cast<float*>(lp), *g = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {{
{cases}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}
""",
    "integrator": """#include "{src}"
extern "C" int sweep(int v, const void* cur, const void* inv_mass, const void* dt,
                     const void* n_steps, const void* x, const void* y,
                     void* cur_out, void* lp_out, void* sched, int C, int P,
                     int N, void* stream) {{
  const float *c = static_cast<const float*>(cur), *im = static_cast<const float*>(inv_mass),
              *h = static_cast<const float*>(dt), *xx = static_cast<const float*>(x),
              *yy = static_cast<const float*>(y);
  const int* n = static_cast<const int*>(n_steps);
  float *co = static_cast<float*>(cur_out), *lo = static_cast<float*>(lp_out);
  int* nc = static_cast<int*>(sched);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {{
{cases}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}
""",
    "fused_transition": """#include "{src}"
// geometry v: its warps per block, and its group in place of the caller's
static cudaError_t sweep_plan(int v, TransitionArgs& a, Plan* p) {{
  switch (v) {{
{cases}
  }}
  return cudaErrorInvalidValue;
}}
extern "C" int sweep_workspace(int v, const void* args, long long* floats) {{
  TransitionArgs a = *static_cast<const TransitionArgs*>(args);
  Plan p;
  const cudaError_t err = sweep_plan(v, a, &p);
  if (err == cudaSuccess)
    *floats = static_cast<long long>(p.blocks) * p.runners *
              work_floats(a.max_depth, a.dim);
  return static_cast<int>(err);
}}
extern "C" int sweep(int v, const void* args, void* stream) {{
  TransitionArgs a = *static_cast<const TransitionArgs*>(args);
  Plan p;
  const cudaError_t err = sweep_plan(v, a, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_plan(a, p, static_cast<cudaStream_t>(stream)));
}}
""",
}
_CASE = {
    "logreg": "    case {i}: return static_cast<int>(launch<{kp}, {w}, {terms}>("
              "t, xx, yy, l, g, B, P, N, s));",
    "integrator": "    case {i}: return static_cast<int>(launch_logreg_width<{kp}, {w}>("
                  "c, im, h, n, xx, yy, co, lo, nc, C, P, N, s));",
    "fused_transition": "    case {i}: a.group = {g}; return plan_logreg<{kp}, {w}>(a, p);",
}
_KERNEL = {"logreg": "logreg_kernel", "integrator": "integrate_logreg_kernel",
           "fused_transition": "transition_logreg_kernel"}


def build(name: str, geometries) -> tuple:
    """The harness library of csrc/<name>.cu and ptxas' report per geometry."""
    src, flags, _ = _cuda._target(name)
    cases = "\n".join(_CASE[name].format(i=i, kp=KP, w=g[0], g=g[-1],
                                          terms=str(g[-1] is not False).lower())
                      for i, g in enumerate(geometries))
    out_dir = _cuda.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"sweep_{name}.cu"
    cu.write_text(_HARNESS[name].format(src=src, cases=cases))
    lib = out_dir / f"libsweep_{name}.so"
    proc = subprocess.run([_cuda._nvcc(), *flags, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}\n{proc.stderr}")
    report, fn = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None or _KERNEL[name] not in fn:
            continue
        m = re.search(r"ILi(\d+)ELi(\d+)E(Lb([01])E)?", fn)
        if m is None or int(m.group(1)) != KP:
            continue
        key = (int(m.group(2)), m.group(4) != "0")
        r = re.search(r"Used (\d+) registers", line)
        sp = re.search(r"(\d+) bytes spill stores", line)
        if r:
            report.setdefault(key, {})["registers"] = int(r.group(1))
        if sp:
            report.setdefault(key, {})["spill_stores"] = int(sp.group(1))
    return ctypes.CDLL(str(lib)), report


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sweep_logreg(card: str) -> None:
    lib, report = build("logreg", LOGREG_GEOMETRIES)
    design, y = logistic_regression_data(ROWS, DIM)
    x = torch.as_tensor(design, dtype=torch.float32, device="cuda").contiguous()
    yt = torch.as_tensor(y, dtype=torch.float32, device="cuda").contiguous()
    rng = np.random.default_rng(2027)
    theta = torch.from_numpy(
        (0.3 * rng.standard_normal((CHAINS, DIM))).astype(np.float32)).cuda()
    lp_p, g_p = logreg_value_grad_plain(theta, x, yt)
    z = torch.empty((CHAINS, ROWS), device="cuda")
    mm_ms = time_ms(lambda: (torch.matmul(theta, x.T, out=z), z @ x), 100)
    stream = torch.cuda.current_stream().cuda_stream
    for i, (w, terms) in enumerate(LOGREG_GEOMETRIES):
        lp = torch.empty(CHAINS, device="cuda")
        g = torch.empty((CHAINS, DIM), device="cuda")

        def run():
            err = lib.sweep(i, ctypes.c_void_p(theta.data_ptr()),
                            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(yt.data_ptr()),
                            ctypes.c_void_p(lp.data_ptr()), ctypes.c_void_p(g.data_ptr()),
                            CHAINS, DIM, ROWS, ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"logreg, {w} warps: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        err = max(float((lp - lp_p).abs().max()), float((g - g_p).abs().max()))
        ok = (torch.allclose(lp, lp_p, rtol=1e-5, atol=0)
              and torch.allclose(g, g_p, rtol=1e-4, atol=2e-3))
        ms = time_ms(run, 200)
        rep = report.get((w, terms), {})
        what = "" if terms else ", the two products alone (no log-sigmoid terms)"
        print(f"[sweep] kernel 2, {w} warps{what}"
              f"{' *' if i == 0 else ''}: {ms:.4f} ms, within tolerance of plain "
              f"{ok} (max abs err {err:.3e}), registers {rep.get('registers')}, "
              f"spill stores {rep.get('spill_stores')} bytes; the two torch.matmul "
              f"products {mm_ms:.4f} ms  [{card}]", flush=True)


def sweep_integrator(card: str) -> None:
    lib, report = build("integrator", INTEGRATOR_GEOMETRIES)
    vg, dim, consts = kernels.logistic_regression_vg(ROWS, DIM, device="cuda")
    inp = integ.synthetic_attempt_inputs(CHAINS, dim, 2029, theta_scale=0.3,
                                         inv_mass_scale=0.005, dt_range=(0.05, 0.2))
    cur, im, dt, n = integ.attempt_tensors(vg, inp, torch.float32, "cuda")
    x, y = integ.kernel_consts(vg, "cuda", torch.float32)
    cur_p, lp_p = integ.integrate_plain(vg, cur, im, dt, n)
    moved = n > 0
    stream = torch.cuda.current_stream().cuda_stream
    for i, (w,) in enumerate(INTEGRATOR_GEOMETRIES):
        cur_k = torch.empty_like(cur)
        lp_k = torch.empty_like(dt)

        def run():
            sched = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                               torch.argsort(n, descending=True, stable=True)
                               .to(torch.int32)])
            err = lib.sweep(i, *(ctypes.c_void_p(t.data_ptr()) for t in
                                 (cur, im, dt, n, x, y, cur_k, lp_k, sched)),
                            CHAINS, DIM, ROWS, ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"integrator, {w} warps: cudaError_t {err}")

        run()
        torch.cuda.synchronize()
        err = max(float((cur_k - cur_p).abs().max()),
                  float((lp_k - lp_p)[moved].abs().max()))
        ok = (torch.allclose(cur_k, cur_p, rtol=1e-3, atol=5e-3)
              and torch.allclose(lp_k[moved], lp_p[moved], rtol=1e-3, atol=5e-3))
        ms = time_ms(run, 10, warmup=1)
        rep = report.get((w, True), {})
        print(f"[sweep] kernel 3 logreg body, {w} warps"
              f"{' *' if i == 0 else ''}: {ms:.4f} ms ({int(n.sum())} chain "
              f"steps), within tolerance of plain {ok} (max abs err {err:.3e}), "
              f"registers {rep.get('registers')}, spill stores "
              f"{rep.get('spill_stores')} bytes  [{card}]", flush=True)


class _Variant:
    """Stands in for the fused_transition library: the wrappers of
    ops/fused_transition.py launch geometry ``v`` of the sweep library."""

    def __init__(self, lib, v: int):
        self.lib, self.v = lib, v

    def wt_transition_args_size(self) -> int:
        return self.lib.wt_transition_args_size()

    def wt_transition_workspace(self, args: int, floats: int) -> int:
        return self.lib.sweep_workspace(self.v, ctypes.c_void_p(args),
                                        ctypes.c_void_p(floats))

    def wt_fused_transition(self, args: int, stream: int) -> int:
        return self.lib.sweep(self.v, ctypes.c_void_p(args), ctypes.c_void_p(stream))

    wt_fused_sample_block = wt_fused_transition


def _event_ms(fn) -> tuple:
    """``fn()``'s result and its device milliseconds (events behind a sleep)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES // 20)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def trace_summary(trace: torch.Tensor, n_grads: torch.Tensor) -> str:
    """Where a launch's time went, from the kernel's per-chain trace (start
    and end in ns, SM): when the counter ran dry, when the first SM went
    idle, when the last chain ended, and the chain that ran longest."""
    t = trace.cpu()
    t0 = int(t[:, 0].min())
    start, end = (t[:, 0] - t0) / 1e6, (t[:, 1] - t0) / 1e6
    sm_end = [float(end[t[:, 2] == sm].max()) for sm in torch.unique(t[:, 2])]
    run = end - start
    k = int(torch.argmax(run))
    return (f"counter dry at {float(start.max()):.3f} ms, first SM idle at "
            f"{min(sm_end):.3f} ms, last chain ends at {float(end.max()):.3f} ms "
            f"({len(sm_end)} SMs); longest-running chain {k}: n_grads "
            f"{int(n_grads[k])}, from {float(start[k]):.3f} to {float(end[k]):.3f} ms "
            f"({float(run[k]) / int(n_grads[k]) * 1e3:.2f} us an evaluation)")


def cost_order(step: torch.Tensor, min_micro: torch.Tensor) -> torch.Tensor:
    """The chains most expensive first by a proxy from the frozen tuning:
    ``min_micro`` descending, then ``step`` ascending, ties in index order."""
    by_step = torch.argsort(step, stable=True)
    return by_step[torch.argsort(min_micro[by_step], descending=True, stable=True)]


def order_setter(order: str, tail) -> Callable[[], None]:
    """What makes the wrappers' next launch on ``tail``'s tuning take its
    chains in ``order``: ``"measured"`` leaves the measurement of the
    launches before; ``"index"`` forgets it; ``"cost"`` puts in its place a
    score that sorts into :func:`cost_order`."""
    if order == "measured":
        return lambda: None
    if order == "index":
        return lambda: ft._MEASURED.__setitem__(slice(None), [None, None])
    by_cost = cost_order(tail[0], tail[2])
    score = torch.empty_like(by_cost)
    score[by_cost] = torch.arange(by_cost.shape[0], 0, -1, device=by_cost.device)
    key = ft._tuning_key(*tail[:3])
    return lambda: ft._MEASURED.__setitem__(slice(None), [key, score])


def sweep_transition(card: str) -> None:
    lib, report = build("fused_transition", TRANSITION_GEOMETRIES)
    ws = chip_smoke.warmed_state()
    model, xy, tail = chip_smoke._transition_setup(ws)
    md, mh, n_draws, n_single = chip_smoke.MAX_DEPTH, chip_smoke.HALVINGS, 100, 20
    base = prng.key(chip_smoke.SEED + 3, "cuda")
    lp0, g0 = logreg_value_grad(ws.theta, *xy)
    rho_b = chip_smoke._momenta(prng.fold_in(base, 1000), (n_draws, CHAINS, DIM),
                                tail[1][None])
    rho_a = [chip_smoke._momenta(prng.fold_in(base, i), (CHAINS, DIM), tail[1])
             for i in range(n_single)]
    ops_eval = 7 * DIM + 4 * ROWS * DIM
    consts = ROWS * DIM + ROWS
    saved = _cuda._LIBRARIES.get("fused_transition")
    first = None
    try:
        for i, (w, g) in enumerate(TRANSITION_GEOMETRIES):
            _cuda._LIBRARIES["fused_transition"] = _Variant(lib, i)
            rep = report.get((w, True), {})
            for order in ORDERS if w == TRANSITION_GEOMETRIES[0][0] else ORDERS[:1]:
                one = ft.make_fused_transition(model, DIM, md, mh)
                block = ft.make_fused_sample_block(model, DIM, md, mh, n_draws)
                set_order = order_setter(order, tail)

                def run_b():
                    set_order()
                    return block(17, ws.theta, lp0, g0, rho_b, *tail)

                ft._MEASURED[:] = [None, None]
                run_b()
                run_b()
                outs = [_event_ms(run_b) for _ in range(3)]
                got_b = outs[0][0]
                ms_b = [o[1] for o in outs]
                ng = got_b[5].to(torch.int64)
                block.trace = torch.zeros((CHAINS, 3), dtype=torch.int64,
                                          device="cuda")
                run_b()
                where_b = trace_summary(block.trace, ng)
                block.trace = None
                bound_b, _ = chip_smoke.bound(
                    4.0 * (CHAINS * DIM * (5 + 2 * n_draws)
                           + CHAINS * (6 + n_draws) + consts),
                    float(ng.sum()) * ops_eval)
                got_a, ms_a = [], []
                for j, rho in enumerate(rho_a):
                    set_order()
                    out, ms = _event_ms(lambda: one(100 + j, ws.theta, rho, lp0, g0,
                                                    *tail))
                    got_a.append(out[4])
                    ms_a.append(ms)
                ng_a = torch.stack(got_a).to(torch.int64)
                bound_a, _ = chip_smoke.bound(
                    4.0 * (CHAINS * DIM * 6 + CHAINS * 6 + consts),
                    float(ng_a.sum() - CHAINS * n_single) / n_single * ops_eval)
                if first is None:
                    first = (ng, ng_a)
                    # how well the cost proxy foretells a chain's work
                    by_cost = ng[cost_order(tail[0], tail[2])]
                    tenth = CHAINS // 10
                    print(f"[sweep] 5b's per-chain n_grads in cost order: first "
                          f"tenth mean {float(by_cost[:tenth].float().mean()):.1f}, "
                          f"last tenth {float(by_cost[-tenth:].float().mean()):.1f}, "
                          f"all {float(ng.float().mean()):.1f}; the largest chain "
                          f"taken {int(torch.argmax(by_cost))}th of {CHAINS}; "
                          f"min_micro values {torch.unique(tail[2]).tolist()}  "
                          f"[{card}]", flush=True)
                    # and how well a launch's per-chain n_grads foretells
                    # the next launch's (from its final state, other momenta)
                    rho_2 = chip_smoke._momenta(prng.fold_in(base, 1001),
                                                (n_draws, CHAINS, DIM), tail[1][None])
                    nxt = block(18, got_b[2], got_b[4], got_b[3], rho_2, *tail)[5]
                    nxt = nxt.to(torch.int64)
                    both = torch.stack([ng, nxt]).double()
                    top1 = torch.argsort(nxt, descending=True)[:CHAINS // 100]
                    top5 = torch.argsort(ng, descending=True)[:CHAINS // 20]
                    kept = float(torch.isin(top1, top5).float().mean())
                    print(f"[sweep] 5b's per-chain n_grads, this launch against "
                          f"the next: correlation "
                          f"{float(torch.corrcoef(both)[0, 1]):.3f}; of the next "
                          f"launch's top 1 %, {kept:.3f} were in this launch's top "
                          f"5 %; largest {int(ng.max())} and {int(nxt.max())}  "
                          f"[{card}]", flush=True)
                same_b = float((ng == first[0]).float().mean())
                same_a = float((ng_a == first[1]).all(0).float().mean())
                launched = (w == TRANSITION_GEOMETRIES[0][0] and order == ORDERS[0])
                star_b = " *" if launched and g == ft.FusedSampleBlock.GROUP_WARPS else ""
                star_a = " *" if launched and g == ft.FusedTransition.GROUP_WARPS else ""
                print(f"[sweep] 5a / 5b logreg body, {w} warps, {g} warps a chain, "
                      f"{order} order: 5b (100 draws){star_b} "
                      f"{', '.join(f'{m:.3f}' for m in ms_b)} ms, bound "
                      f"{bound_b:.3f} ms, {bound_b / np.mean(ms_b):.4f} of it, "
                      f"largest per-chain n_grads {int(ng.max())}; 5a{star_a} "
                      f"{np.mean(ms_a):.4f} ms a launch (largest {max(ms_a):.4f}), "
                      f"bound {bound_a * 1e3:.3f} us, {bound_a / np.mean(ms_a):.4f} "
                      f"of it; n_grads equal to the first geometry's on "
                      f"{same_a:.4f} / {same_b:.4f} of the chains; registers "
                      f"{rep.get('registers')}, spill stores "
                      f"{rep.get('spill_stores')} bytes  [{card}]", flush=True)
                print(f"[sweep]   5b's trace: {where_b}", flush=True)
    finally:
        ft._MEASURED[:] = [None, None]
        if saved is None:
            _cuda._LIBRARIES.pop("fused_transition", None)
        else:
            _cuda._LIBRARIES["fused_transition"] = saved


# chains per CUDA block of the fused pass; the first is the default
PASS_TILES = (8, 4, 16, 32)
# a chain of dependent hashes in one thread, for the cycles a hash takes
_PROBE = """#include "{src}"
__global__ void probe_kernel(uint32_t k0, uint32_t k1, int n, int at,
                             long long* cycles, uint32_t* sink) {{
  uint32_t a0 = k0, a1 = k1, u0 = 0u, u1 = 0u;
  long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long t0 = clock64();
  if (at < 0) {{
    for (int j = 0; j < n; ++j) wt::threefry2x32(a0, a1, 0u, 0u, a0, a1);
  }} else {{
{replay}
  }}
  const long long t1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  cycles[0] = t1 - t0;
  cycles[1] = g1 - g0;
  sink[0] = a0 ^ a1 ^ u0 ^ u1;
}}
extern "C" int probe(uint32_t k0, uint32_t k1, int n, int at, void* cycles,
                     void* sink, void* stream) {{
  probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, n, at, static_cast<long long*>(cycles), static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}}
"""
# the replay's round as the probe runs it: the parent's latch inside the
# loop, or the shared replay_chain where threefry.cuh has it
_PROBE_LATCH = """    for (int j = 0; j < n; ++j) {
      if (at == j + 1) wt::threefry2x32(a0, a1, 0u, 1u, u0, u1);
      wt::threefry2x32(a0, a1, 0u, 0u, a0, a1);
    }"""
_PROBE_CHAIN = "    wt::replay_chain(a0, a1, u0, u1, n, at);"


def resident_warps(regs: int, warps: int, smem: int = 0) -> int:
    """Warps of ``warps``-warp blocks resident on one H100 SM at ``regs``
    registers a thread and ``smem`` bytes of shared memory a block (64
    warps, 32 blocks, 65536 registers allocated 256 a warp, 228 KB of
    shared memory with 1 KB reserved a block)."""
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(32, 64 // warps, 65536 // per_warp // warps)
    if smem:
        blocks = min(blocks, 233472 // (-(-smem // 128) * 128 + 1024))
    return blocks * warps


def probe_cycles(card: str) -> dict:
    """SM cycles of one threefry2x32 in a chain of dependent hashes, and of
    a replay round (the main split and subkey 1's latch)."""
    src = _cuda._CSRC / "threefry.cuh"
    chain = "replay_chain" in src.read_text()
    out_dir = _cuda.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "sweep_threefry.cu"
    cu.write_text(_PROBE.format(src=src, replay=_PROBE_CHAIN if chain else _PROBE_LATCH))
    lib_path = out_dir / "libsweep_threefry.so"
    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    proc = subprocess.run([_cuda._nvcc(), *flags, "-o", str(lib_path), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    cycles = torch.zeros(2, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(n, at):
        best = None
        for _ in range(5):
            err = lib.probe(ctypes.c_uint32(0x12345678), ctypes.c_uint32(0x9abcdef0),
                            n, at, ctypes.c_void_p(cycles.data_ptr()),
                            ctypes.c_void_p(sink.data_ptr()), ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"probe: cudaError_t {err}")
            torch.cuda.synchronize()
            best = int(cycles[0]) if best is None else min(best, int(cycles[0]))
        return best

    how = ("replay_chain: both hashes, then a select" if chain
           else "the latch inside the loop")
    hash_c = (run(1012, -1) - run(12, -1)) / 1000
    round_c = (run(1012, 6) - run(12, 6)) / 1000
    run(200_000, -1)
    ghz = float(cycles[0]) / float(cycles[1])
    print(f"[sweep] threefry2x32 in a chain of dependent hashes: {hash_c:.1f} "
          f"cycles a hash; a replay round ({how}"
          f"): {round_c:.1f} cycles, the round that latches included; 12 rounds "
          f"{run(12, 6)} cycles; the SM clock {ghz:.3f} GHz under a long chain  "
          f"[{card}]", flush=True)
    return dict(hash_cycles=hash_c, round_cycles=round_c, ghz=ghz)


def _load_parent(parent: Path):
    """The parent tree's fused-pass module and its kernel libraries, built
    from its sources: ``(module, {"fused_pass": lib, "replay": lib})``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "parent_fused_pass", parent / "walnuts_tpu_torch" / "ops" / "fused_pass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    libs = {}
    out_dir = _cuda.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in ("fused_pass", "replay"):
        src = parent / "walnuts_tpu_torch" / "csrc" / f"{name}.cu"
        out = out_dir / f"lib{name}.so"
        flags = _cuda.NVCC_FLAGS + _cuda._EXTRA_FLAGS.get(name, ())
        proc = subprocess.run([_cuda._nvcc(), *flags, "-o", str(out), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _cuda._SIGNATURES[name].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        for kernel, regs, spill in chip_smoke.ptxas_report(proc.stderr):
            print(f"[sweep] parent {name}: {kernel}: {regs} registers, {spill} bytes "
                  f"spill stores", flush=True)
    return mod, libs


def _pass_outputs(st, out):
    from walnuts_tpu_torch.ops import fused_pass as fp

    return [fp.lane_field(st, n) for n in fp.RW_FIELDS] + list(out)


def sweep_pass(card: str, parent: Path | None) -> None:
    """Kernel 4 at each pass_tile on the smoke's synthetic state (D = 25
    and 101) with a traced launch, kernel 1 beside the empty kernel and the
    hash's cycles, registers and resident warps; with ``parent``, the
    parent tree's kernels against these, in turns, outputs compared."""
    from walnuts_tpu_torch.ops import fused_pass as fp

    for name in ("fused_pass", "replay"):
        _cuda.library(name)
        for kernel, regs, spill in chip_smoke.ptxas_report(_cuda.BUILD_INFO[name]["log"]):
            if name == "replay":
                warps = f"{resident_warps(regs, 4)} at 4 warps a block"
            else:  # the smoke's D = 25, n_slots 4: the block's control
                # columns and 25 staged rows of 32 features a warp
                size = 8 if "double" in kernel else 4
                ctl = -(-(12 * 32 * size + 26 * 32 * 4) // 16) * 16
                warps = ", ".join(
                    f"{resident_warps(regs, w, ctl + w * 25 * 32 * size)} at {w}"
                    for w in PASS_TILES)
            print(f"[sweep] {name}: {kernel}: {regs} registers, {spill} bytes spill "
                  f"stores; warps resident an SM (by registers and shared memory) "
                  f"at warps a block: {warps}", flush=True)
    probe = probe_cycles(card)
    old = _load_parent(parent) if parent else None

    # kernel 1 beside the empty kernel, on the smoke's replay input
    rng = np.random.default_rng(chip_smoke.SEED)
    kd = rng.integers(0, 2**32, size=(CHAINS, 2), dtype=np.uint64).astype(np.uint32)
    ku = rng.integers(0, 2**32, size=(CHAINS, 2), dtype=np.uint64).astype(np.uint32)
    n_ends = rng.integers(0, 13, size=CHAINS).astype(np.int32)
    at = (rng.random(CHAINS) * (n_ends + 1)).astype(np.int32)
    from walnuts_tpu_torch.convert import key_data_torch

    args = [key_data_torch(kd, "cuda"), key_data_torch(ku, "cuda"),
            torch.from_numpy(n_ends).cuda(), torch.from_numpy(at).cuda()]
    rlib = _cuda.library("replay")
    stream = torch.cuda.current_stream().cuda_stream
    empty = lambda: rlib.wt_empty_kernel(32, 128, ctypes.c_void_p(stream))
    runs = [("kernel 1", lambda: prng.replay_split_chain(*args)), ("empty", empty)]
    if old:
        k_out, u_out = torch.empty_like(args[0]), torch.empty_like(args[1])

        def parent_replay():
            err = old[1]["replay"].wt_replay_split_chain(
                *(ctypes.c_void_p(t.data_ptr()) for t in args + [k_out, u_out]),
                CHAINS, ctypes.c_void_p(stream))
            if err:
                raise RuntimeError(f"parent replay: cudaError_t {err}")

        parent_replay()
        got = prng.replay_split_chain(*args)
        torch.cuda.synchronize()
        same = torch.equal(got[0], k_out) and torch.equal(got[1], u_out)
        print(f"[sweep] kernel 1 and the parent's replay bitwise equal: {same}  "
              f"[{card}]", flush=True)
        runs = [("parent kernel 1", parent_replay)] + runs + [("parent kernel 1", parent_replay)]
    for what, fn in runs + runs[::-1][1:]:
        print(f"[sweep] {what}: {chip_smoke.time_ms(fn):.4f} ms a launch (back to "
              f"back behind a sleep, the smoke's measure)  [{card}]", flush=True)
    hz = probe["ghz"] * 1e9
    print(f"[sweep] kernel 1's longest lane: {int(n_ends.max())} rounds, "
          f"{int(n_ends.max()) * probe['round_cycles']:.0f} cycles "
          f"({int(n_ends.max()) * probe['round_cycles'] / hz * 1e6:.3f} us at "
          f"{hz / 1e9:.3f} GHz)  [{card}]", flush=True)

    # kernel 4 at each tile, D = 25 and 101
    cap, R, max_depth = 5, 6, 5
    for dim in (chip_smoke.DIM, 101):
        st, params, out = chip_smoke._pass_case(dim, chip_smoke.SEED + dim)
        pristine, _, _ = chip_smoke._pass_case(dim, chip_smoke.SEED + dim)
        pend = (pristine.draws_done < cap) & pristine.leaf_done

        def reset():
            for n in fp.RW_FIELDS:
                fp.lane_field(st, n).copy_(fp.lane_field(pristine, n))
            for t in out:
                t.zero_()

        variants = [(f"pass_tile {t}", lambda t=t: fp.fused_pass(
            st, *params, cap, R, max_depth, out, pass_tile=t)) for t in PASS_TILES]
        if old:
            mod, libs = old

            def parent_pass():
                saved = _cuda._LIBRARIES["fused_pass"]
                _cuda._LIBRARIES["fused_pass"] = libs["fused_pass"]
                try:
                    mod.fused_pass(st, *params, cap, R, max_depth, out)
                finally:
                    _cuda._LIBRARIES["fused_pass"] = saved

            reset()
            parent_pass()
            want = [t.clone() for t in _pass_outputs(st, out)]
            reset()
            variants[0][1]()
            got = _pass_outputs(st, out)
            torch.cuda.synchronize()
            diff = max(float((g.double() - w.double()).abs().nan_to_num(0.0).max())
                       if g.numel() else 0.0 for g, w in zip(got, want))
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"[sweep] kernel 4, D={dim}: outputs bitwise equal to the parent's: "
                  f"{same}; largest difference {diff:.3e}  [{card}]", flush=True)
            variants = [("parent", parent_pass)] + variants[:1] + variants[:1] + \
                [("parent", parent_pass)] + variants[1:]
        if old:  # the wrappers' host time alone: 8 rounds of 100 calls each
            times = {"parent": [], variants[1][0]: []}
            for r in range(8):
                for what, fn in variants[:2][::1 if r % 2 else -1]:
                    reset()
                    torch.cuda.synchronize()
                    for _ in range(100):
                        t0 = time.perf_counter()
                        fn()
                        times[what].append(time.perf_counter() - t0)
                    torch.cuda.synchronize()
            print(f"[sweep] kernel 4, D={dim}: the wrappers' host time, median of 800 "
                  f"calls back to back in 8 alternating rounds: " + ", ".join(
                      f"{w} {np.median(t) * 1e3:.4f} ms" for w, t in times.items())
                  + f"  [{card}]", flush=True)
        for what, fn in variants:
            ms, host = chip_smoke.timed_single(fn, reset, 30)
            line = (f"[sweep] kernel 4, D={dim}, {what}: {ms:.4f} ms a launch (the "
                    f"smoke's measure), the wrapper's host time {host:.4f} ms")
            if what.startswith("pass_tile"):
                tile = int(what.split()[1])
                trace = torch.zeros((CHAINS, fp.TRACE_COLS), dtype=torch.int64,
                                    device="cuda")
                reset()
                fp.fused_pass(st, *params, cap, R, max_depth, out, pass_tile=tile,
                              trace=trace)
                torch.cuda.synchronize()
                summary = chip_smoke.pass_trace_summary(trace, pend)
                line += f"; traced: {chip_smoke.format_trace(summary)}"
            print(line + f"  [{card}]", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("torch_logreg_sweep.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    argv = sys.argv[1:]
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = Path(argv[i + 1])
        del argv[i:i + 2]
    parts = {"logreg": sweep_logreg, "integrator": sweep_integrator,
             "transition": sweep_transition,
             "pass": lambda card: sweep_pass(card, parent)}
    for name in argv or parts:
        parts[name](card)


if __name__ == "__main__":
    main()
