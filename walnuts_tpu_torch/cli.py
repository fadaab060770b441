"""Command-line sampler of the PyTorch port, the counterpart of the JAX
package's ``examples/walnuts_cli.py`` (the reference's ``stan_cli``,
examples/stan_cli.cpp:180-366).

Samples a target of ``walnuts_tpu_torch.models`` or a compiled BridgeStan
model shared object, prints a summary table, and reports the built-in
profile: wall time, gradient evaluations, gradients per second (the
instrumentation the reference CLI wraps around its model callback,
stan_cli.cpp:121-139).

Usage:
  python -m walnuts_tpu_torch.cli --model funnel --dim 25 --chains 8
  python -m walnuts_tpu_torch.cli --stan-so model_model.so --data data.json
  python -m walnuts_tpu_torch.cli --model std_normal --device cpu
"""

from __future__ import annotations

import argparse
import inspect
import sys
import time

import numpy as np


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WALNUTS sampler CLI (PyTorch port)")
    p.add_argument("--model", default="std_normal",
                   help="target of walnuts_tpu_torch.models: std_normal, "
                        "ill_conditioned_normal, condition_gaussian, ar1_normal, "
                        "funnel, eight_schools, logistic_regression, "
                        "stochastic_volatility")
    p.add_argument("--dim", type=int, default=10, help="dimension for sized targets")
    p.add_argument("--stan-so", default=None,
                   help="path to a compiled BridgeStan model .so (overrides --model)")
    p.add_argument("--data", default=None, help="JSON data file for the Stan model")
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--warmup", type=int, default=None,
                   help="fixed warmup iterations (sets min=max)")
    p.add_argument("--sampling", type=int, default=None,
                   help="fixed sampling iterations (sets min=max)")
    p.add_argument("--min-warmup", type=int, default=50)
    p.add_argument("--max-warmup", type=int, default=1000)
    p.add_argument("--min-sampling", type=int, default=50)
    p.add_argument("--max-sampling", type=int, default=1000)
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--max-step-halvings", type=int, default=5)
    p.add_argument("--max-error", type=float, default=0.5)
    p.add_argument("--init-radius", type=float, default=2.0)
    p.add_argument("--refresh", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the chains run (default cuda)")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    p.add_argument("--f64", action="store_true", help="use float64 (default float32)")
    p.add_argument("--out", default=None, help="write draws to this .npz file")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import torch

    from walnuts_tpu_torch import Summarizer, walnuts, walnuts_stan
    from walnuts_tpu_torch.models import targets

    device = "cpu" if args.cpu else args.device
    kwargs = dict(
        num_chains=args.chains,
        seed=args.seed,
        init_radius=args.init_radius,
        min_warmup_iter=args.warmup or args.min_warmup,
        max_warmup_iter=args.warmup or args.max_warmup,
        min_sampling_iter=args.sampling or args.min_sampling,
        max_sampling_iter=args.sampling or args.max_sampling,
        max_trajectory_doublings=args.max_depth,
        max_step_halvings=args.max_step_halvings,
        max_hamiltonian_error=args.max_error,
        refresh=args.refresh,
        dtype=torch.float64 if args.f64 else torch.float32,
        device=device,
        return_info=True,
    )

    t0 = time.perf_counter()
    if args.stan_so:
        data = None
        if args.data:
            with open(args.data) as f:
                data = f.read()
        outputs, info = walnuts_stan(args.stan_so, data=data, **kwargs)
        names = outputs[0].parameters
        chains = [o.data for o in outputs]
    else:
        factory = getattr(targets, args.model, None)
        if factory is None or args.model.startswith("_"):
            print(f"unknown model {args.model!r}", file=sys.stderr)
            return 2
        model_kw = ({"device": device}
                    if "device" in inspect.signature(factory).parameters else {})
        try:
            logp, dim = factory(args.dim, **model_kw)
        except TypeError:
            logp, dim = factory(**model_kw)
        outputs, info = walnuts(logp, num_params=dim, **kwargs)
        names = [f"theta[{i}]" for i in range(dim)]
        chains = [np.asarray(o) for o in outputs]
    elapsed = time.perf_counter() - t0

    s = Summarizer(chains)
    mean, sd, ess, rhat = s.mean(), s.standard_deviation(), s.ess(), s.r_hat()
    mcse = sd / np.sqrt(ess)
    print(f"{'parameter':>14} {'mean':>10} {'sd':>10} {'mcse':>10} "
          f"{'ess':>10} {'rhat':>8}")
    show = min(len(names), 20)
    for i in range(show):
        print(f"{names[i]:>14} {mean[i]:>10.4f} {sd[i]:>10.4f} "
              f"{mcse[i]:>10.4f} {ess[i]:>10.1f} {rhat[i]:>8.4f}")
    if len(names) > show:
        print(f"  ... ({len(names) - show} more parameters)")

    print(f"\nchains: {len(chains)}  draws/chain: {chains[0].shape[0]}  "
          f"device: {device}")
    print(f"total wall time: {elapsed:.2f}s")
    total_grads = int(np.sum(info.n_grads))
    print(f"warmup iterations: {info.warmup_iters}  "
          f"sampling iterations: {info.sampling_iters}")
    print(f"gradient evaluations: {total_grads}  "
          f"({total_grads / elapsed:.0f}/s)  "
          f"time/gradient: {1e6 * elapsed / max(total_grads, 1):.2f}us")

    if args.out:
        np.savez(args.out, draws=np.stack(chains), parameters=names)
        print(f"draws written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
