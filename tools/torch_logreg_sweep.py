"""Time launch geometries of the port's logistic-regression kernels on a card.

Kernel 2 (``walnuts_tpu_torch/csrc/logreg.cu``) and the logistic-regression
body of kernel 3 (``csrc/integrator.cu``) and of kernels 5a and 5b
(``csrc/fused_transition.cu``), all three through ``csrc/logreg_chain.cuh``,
are templates over their warps per block. This script builds one library
per source that includes it and exports a launcher per warp count (kernel
2 also without its log-sigmoid terms: the two products alone),
then at ``chip_smoke.py``'s shapes (kernel 2: theta 4096 x 25, X 1000 x 25;
kernel 3: the synthetic attempt of 4096 chains, n_steps in 0..256; 5a and
5b: the synthetic transition of 4096 chains, 5b with 8 draws) times each
with CUDA events behind a sleep kernel, holds it against the plain version,
and prints ptxas' registers and spill stores for it. The geometry the
sources launch is marked ``*``. Needs ``nvcc`` and a CUDA card.

Run from the root of a checkout:  python3 tools/torch_logreg_sweep.py
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from walnuts_tpu_torch.models import kernels  # noqa: E402
from walnuts_tpu_torch.models.targets import logistic_regression_data  # noqa: E402
from walnuts_tpu_torch.ops import _cuda  # noqa: E402
from walnuts_tpu_torch.ops import fused_transition as ft  # noqa: E402
from walnuts_tpu_torch.ops import integrator as integ  # noqa: E402
from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad_plain  # noqa: E402

CHAINS, DIM, ROWS = 4096, 25, 1000
KP = 28  # DIM rounded up to 4
LEAD_CYCLES = 20_000_000

# warps per block; the first is the count the source launches. Kernel 2's
# second entry: False leaves out the log-sigmoid terms (the two products
# alone, not a correct result)
LOGREG_GEOMETRIES = [(16, True), (16, False), (8, True), (12, True)]
INTEGRATOR_GEOMETRIES = [(16,), (8,), (12,)]
TRANSITION_GEOMETRIES = [(16,), (8,)]

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
extern "C" int sweep(int v, const void* args, void* stream) {{
  const TransitionArgs& a = *static_cast<const TransitionArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (v) {{
{cases}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}
""",
}
_CASE = {
    "logreg": "    case {i}: return static_cast<int>(launch<{kp}, {w}, {terms}>("
              "t, xx, yy, l, g, B, P, N, s));",
    "integrator": "    case {i}: return static_cast<int>(launch_logreg_width<{kp}, {w}>("
                  "c, im, h, n, xx, yy, co, lo, nc, C, P, N, s));",
    "fused_transition": "    case {i}: return static_cast<int>("
                        "launch_logreg<{kp}, {w}>(a, s));",
}
_KERNEL = {"logreg": "logreg_kernel", "integrator": "integrate_logreg_kernel",
           "fused_transition": "transition_logreg_kernel"}


def build(name: str, geometries) -> tuple:
    """The harness library of csrc/<name>.cu and ptxas' report per geometry."""
    src, flags, _ = _cuda._target(name)
    cases = "\n".join(_CASE[name].format(i=i, kp=KP, w=g[0],
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

    def wt_fused_transition(self, args: int, stream: int) -> int:
        return self.lib.sweep(self.v, ctypes.c_void_p(args), ctypes.c_void_p(stream))

    wt_fused_sample_block = wt_fused_transition


def sweep_transition(card: str) -> None:
    lib, report = build("fused_transition", TRANSITION_GEOMETRIES)
    model = kernels.logistic_regression_vg(ROWS, DIM, device="cuda")
    vg = model[0]
    n_draws, md, mh = 8, 5, 8
    inp = ft.synthetic_transition_inputs(CHAINS, DIM, 2031, num_draws=n_draws,
                                         theta_scale=0.3, inv_mass_scale=0.005,
                                         step_range=(0.3, 1.0))
    t = ft.transition_tensors(vg, inp, "cuda")
    tail = (t["step"], t["inv_mass"], t["min_micro"], 0.5)
    static = dict(max_depth=md, max_step_halvings=mh)
    one_args = (5, t["theta"], t["rho"][0].contiguous(), t["logp0"], t["grad0"], *tail)
    block_args = (5, t["theta"], t["logp0"], t["grad0"], t["rho"], *tail)
    want_one = ft.fused_transition_plain(vg, *one_args, **static)
    want_block = ft.fused_sample_block_plain(vg, *block_args, **static)
    saved = _cuda._LIBRARIES.get("fused_transition")
    try:
        for i, (w,) in enumerate(TRANSITION_GEOMETRIES):
            _cuda._LIBRARIES["fused_transition"] = _Variant(lib, i)
            one = ft.make_fused_transition(model, DIM, md, mh)
            block = ft.make_fused_sample_block(model, DIM, md, mh, n_draws)
            got_one, got_block = one(*one_args), block(*block_args)
            torch.cuda.synchronize()
            same_one = float(((got_one[3] == want_one[3])
                              & (got_one[4] == want_one[4])).float().mean())
            same_block = float((got_block[5] == want_block[5]).float().mean())
            ms_one = time_ms(lambda: one(*one_args), 5, warmup=1)
            ms_block = time_ms(lambda: block(*block_args), 3, warmup=1)
            rep = report.get((w, True), {})
            print(f"[sweep] 5a / 5b logreg body, {w} warps"
                  f"{' *' if i == 0 else ''}: 5a {ms_one:.4f} ms, 5b ({n_draws} "
                  f"draws) {ms_block:.4f} ms; depth and n_grads equal to plain on "
                  f"{same_one:.4f} / {same_block:.4f} of the chains; registers "
                  f"{rep.get('registers')}, spill stores {rep.get('spill_stores')} "
                  f"bytes  [{card}]", flush=True)
    finally:
        if saved is None:
            _cuda._LIBRARIES.pop("fused_transition", None)
        else:
            _cuda._LIBRARIES["fused_transition"] = saved


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("torch_logreg_sweep.py needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sweep_logreg(card)
    sweep_integrator(card)
    sweep_transition(card)


if __name__ == "__main__":
    main()
