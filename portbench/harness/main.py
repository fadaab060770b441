"""One run of one cell: set-up, the window, the comparison, the result line.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
device's busy seconds over the traced slice. The run needs as many CUDA
devices as the cell's chips and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from portbench.harness import spec as spec_mod

#: top-level module names that must not be loaded: JAX and the package
#: the program was ported from (compared whole: the program's own name
#: begins with the latter)
FORBIDDEN = ("jax", "jaxlib", "flax", "walnuts_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _fixed_caches() -> None:
    """Every build or kernel cache at a fixed path inside the checkout."""
    build = spec_mod.ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))


def card_state() -> str:
    """``nvidia-smi``'s name, power limit, clocks and draw of each card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return " | ".join(line.strip() for line in out.stdout.splitlines() if line.strip())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def _nonfinite_draws(draws, logps) -> int:
    """Draws whose position is not finite or whose log density is NaN or
    +inf (-inf is a density float32 cannot hold, which the comparison
    holds to the reference)."""
    import torch

    bad = (~torch.isfinite(draws).all(dim=-1) | torch.isnan(logps)
           | (logps == float("inf")))
    return int(bad.sum())


def _ess(draws) -> dict:
    """Median and smallest ESS over dimensions of the window's sampling
    draws, pooled over chains (the frozen Geyer copy), printed beside the
    metrics."""
    from portbench.reference import ess as ess_ref

    e = ess_ref.ess(draws.cpu().numpy())
    return {"median": float(np.median(e)), "min": float(np.min(e)),
            "draws": int(draws.shape[0] * draws.shape[1])}


def run_cell(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print, variants=()) -> dict:
    """Set-up, window and comparison of ``cell`` on ``device``; returns the
    result's fields (without the chip look and the module check).
    ``variants`` (``"control"``, ``"stuck"``) adds the numbers of the
    control and of the stuck-chain fault on the same outputs, under
    ``"variants"``; the benchmark's own runs take none."""
    import torch

    from portbench.harness.trace import Tracer
    from portbench.harness import window as win_mod

    model_mod = spec_mod.model_module(cell)
    traffic, config = cell.traffic, cell.config
    chains = int(traffic["chains"])
    dev = torch.device(device)
    # the precision the configuration states, for every matrix product
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    if dev.type == "cuda":
        from walnuts_tpu_torch.ops import _cuda

        _cuda.build(*model_mod.LIBRARIES)
        for name in model_mod.LIBRARIES:
            _cuda.library(name)
    model = model_mod.build(config, seed, dev)
    theta0 = model_mod.initial_points(model, chains, seed, dev, traffic["init"])
    state = win_mod.initial_state(model["logp_grad"], theta0, seed, traffic)
    win_mod.warm_up(model["logp_grad"], state, traffic, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] card before the window: {card_state() if dev.type == 'cuda' else 'cpu'}")

    win = win_mod.measure(model["logp_grad"], state, traffic, seconds, dev)

    card_after = card_state() if dev.type == "cuda" else "cpu"
    log(f"[portbench] card after the window: {card_after}")
    tracer = Tracer(dev) if trace else None
    if tracer is not None:
        win_mod.traced_slice(model["logp_grad"], win, traffic, tracer)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    if win.reached_max:
        log("[portbench] warning: the sampling reached max_iter before the "
            "window's seconds")
    bad_draws = _nonfinite_draws(win.draws, win.logps)
    ess = _ess(win.draws)
    got = model_mod.collect(model, win, theta0, traffic["check"], seed)
    # the program's state is freed before the reference runs
    win.state = win.draws = win.logps = None
    del state, model["logp_grad"]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    readings = model_mod.compare(model, got, traffic["check"], seed, dev)
    other = {v: model_mod.compare(model, got, traffic["check"], seed, dev, **{v: True})
             for v in variants}
    transitions = (win.warmup_iters + win.sampling_iters) * chains
    record = {
        "config": config,
        "traffic": traffic,
        "chains": chains,
        "setup_s": setup_s,
        "window_s": win.seconds,
        "warmup_s": win.warmup_s,
        "sampling_s": win.sampling_s,
        "counters": {
            "grads": win.grads, "warmup_grads": win.warmup_grads, "trips": win.trips,
            "passes": win.passes, "syncs": win.syncs, "blocks": win.blocks,
            "transitions": transitions, "nonfinite": win.nonfinite,
            "warmup_iters": win.warmup_iters, "sampling_iters": win.sampling_iters,
        },
        "ess": ess,
        "flops_per_grad": model_mod.flops_per_grad(config),
        "trace": tracer.result if tracer is not None else None,
    }
    return {"record": record, "readings": readings, "failed": win.nonfinite,
            "nonfinite_draws": bad_draws, "attempted": transitions, "peak": peak,
            "card_after": card_after, "variants": other}


def judge(readings: dict, limits: dict):
    """``(correct, checks)``: every number at or under its limit (a number
    that is not one fails; JSON has no infinity, so such a reading is
    given as its name)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        checks[name] = {"value": value if math.isfinite(value) else str(value),
                        "limit": limit}
        ok = ok and (value <= limit)
    return ok, checks


def metrics_of(cell: spec_mod.Cell, record: dict, trace: bool) -> dict:
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec_mod.metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    _fixed_caches()
    cell = spec_mod.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[portbench] {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {have}. No result.", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start,
                   log=lambda s: print(s, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] modules that must not be loaded are loaded: {bad}. "
              f"No result.", file=sys.stderr)
        return 3
    correct, checks = judge(out["readings"], cell.limits)
    checks["nonfinite_draws"] = {"value": out["nonfinite_draws"], "limit": 0}
    correct = correct and out["nonfinite_draws"] == 0
    rec = out["record"]
    result = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics_of(cell, rec, bool(args.trace)),
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(device),
            "count": cell.chips,
            "memory_peak_bytes": out["peak"],
        },
    }
    if args.trace and rec["trace"] is not None:
        result["device"]["busy_s"] = rec["trace"]["busy_s"]
        result["device"]["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = checks
    print(f"# card: {out['card_after']}")
    print(f"# counters: {json.dumps(rec['counters'])} window_s {rec['window_s']} "
          f"warmup_s {rec['warmup_s']} sampling_s {rec['sampling_s']} "
          f"setup_s {rec['setup_s']} ess {json.dumps(rec['ess'])}")
    print(json.dumps(result))
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0
