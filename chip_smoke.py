"""Chip smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version at the main path's shapes, then
drives the port's main path once through ``walnuts_tpu_torch.walnuts``:
batched adaptive WALNUTS on the 25-coefficient logistic regression (1000
rows) with the fused kernel, 4096 chains, 100 warmup and 100 sampling
iterations. It checks that both kernels ran on that path, that the draws
are finite, and that the pooled posterior mean and sd agree with NumPy
references (a Newton MAP, its Laplace sd, and the importance-reweighted
Laplace mean).

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

``--profile`` adds a ``torch.profiler`` window over a short run and prints
device time by kernel. Any failed phase raises (non-zero exit). The last
line of standard output is ``{"ok": true, "device": {...}}``; the line
before it lists each kernel's route, launches on the main path, error
against its plain version and time.
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


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int = 100, warmup: int = 5) -> float:
    """Device milliseconds per call of ``fn`` (CUDA events over ``reps``
    calls after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
    plain_ms = time_ms(lambda: prng.replay_split_chain_plain(*args), reps=20)
    print(f"[replay] kernel bitwise equal to plain at C={CHAINS}, n_ends in "
          f"[0, 12]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    return dict(name="replay_split_chain", route="cuda",
                source="walnuts_tpu_torch/csrc/replay.cu",
                replaces="walnuts_tpu/ops/prng.py:170",
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms)


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
    plain_ms = time_ms(lambda: logreg_value_grad_plain(theta, x_t, y_t))
    print(f"[logreg] kernel within lp rtol 1e-5, grad rtol 1e-4 atol 2e-3 of "
          f"plain at ({CHAINS}, {DIM}) x ({ROWS}, {DIM}): max abs err {err:.3e}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    return dict(name="logreg_value_grad", route="cuda",
                source="walnuts_tpu_torch/csrc/logreg.cu",
                replaces="walnuts_tpu/ops/pallas_kernels.py:31",
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


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


def run_main_path(card: str) -> dict:
    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.models.targets import logistic_regression_data
    from walnuts_tpu_torch.ops import prng
    from walnuts_tpu_torch.ops.logreg_fused import (
        logistic_regression_fused,
        logreg_value_grad,
    )

    logp_grad, dim = logistic_regression_fused(ROWS, DIM, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prng.replay_split_chain.launches = 0
    logreg_value_grad.launches = 0
    t0 = time.perf_counter()
    out, info = wtt.walnuts(
        logp_grad, fused=True, num_params=dim, num_chains=CHAINS,
        dtype=torch.float32, seed=SEED, device=DEVICE,
        min_warmup_iter=100, max_warmup_iter=100,
        min_sampling_iter=100, max_sampling_iter=100,
        block_size=50, return_info=True, max_step_halvings=HALVINGS,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"replay_split_chain": prng.replay_split_chain.launches,
                "logreg_value_grad": logreg_value_grad.launches}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")

    draws = np.stack([np.asarray(c) for c in out])  # (C, R, D)
    if draws.shape != (CHAINS, 100, DIM) or not np.isfinite(draws).all():
        raise AssertionError(f"bad draws: shape {draws.shape}, "
                             f"finite {np.isfinite(draws).all()}")
    design, y = logistic_regression_data(ROWS, DIM)
    mode, sd, post_mean = laplace(design, y)
    pooled = draws.reshape(-1, DIM).astype(np.float64)
    z_mean = np.abs(pooled.mean(0) - post_mean) / sd
    z_map = np.abs(pooled.mean(0) - mode) / sd
    sd_ratio = pooled.std(0) / sd
    print(f"[posterior] pooled mean vs reweighted Laplace mean: max "
          f"|diff| / laplace sd = {z_mean.max():.4f} (limit 0.15); vs Newton "
          f"MAP {z_map.max():.4f} (reported only); pooled sd / laplace sd in "
          f"[{sd_ratio.min():.4f}, {sd_ratio.max():.4f}] (limit 20 %)  [{card}]")
    if z_mean.max() > 0.15 or np.abs(sd_ratio - 1.0).max() > 0.2:
        raise AssertionError("posterior disagrees with the Laplace approximation")

    from walnuts_tpu_torch import summary

    ess = summary.ess(list(draws))
    rhat = summary.r_hat(list(draws))
    w_s, s_s = info.seconds["warmup"], info.seconds["sampling"]
    n_grads = float(np.sum(info.n_grads))
    print(f"[main path] logreg({DIM}) x {CHAINS} chains, fused, float32, "
          f"100 + 100 iterations, block 50, max_step_halvings {HALVINGS}  [{card}]")
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    card = card_label()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    from walnuts_tpu_torch.ops import _cuda

    for name in ("replay", "logreg"):
        _cuda.library(name)
        b = _cuda.BUILD_INFO[name]
        print(f"[build] {name}: {b['seconds']:.2f} s -> {b['path']}")
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")

    kernels = [check_replay(card), check_logreg(card)]
    launches = run_main_path(card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if args.profile:
        profile_window(card)
    print(json.dumps({"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms")}
        for k in kernels
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
