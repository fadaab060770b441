"""Readings the limits of a cell are set from, for many seeds in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds <s>

For each seed: the cell's set-up and window as ``run.py`` runs them, then
the comparison's numbers three times over the same outputs: the program's
(the lower readings), the control's (the reference in the precision just
below the configuration's, put in the program's place) and the stuck-chain
fault's (every chain left at its initial point). One JSON line per seed;
``run.py`` never runs the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or os.curdir) not in (HERE, ROOT)]

from portbench.harness import main as run_main  # noqa: E402
from portbench.harness import spec  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    run_main._fixed_caches()
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("[calibrate] no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.ones(1, device=device)
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats(device)
        out = run_main.run_cell(cell, seed, args.seconds, False, device, t_start,
                                log=lambda s: print(s, file=sys.stderr),
                                variants=("control", "stuck"))
        rec = out["record"]
        print(json.dumps({
            "seed": seed, "program": out["readings"], **out["variants"],
            "failed": out["failed"], "attempted": out["attempted"],
            "metrics": run_main.metrics_of(cell, rec, False),
            "counters": rec["counters"], "window_s": rec["window_s"],
            "peak": out["peak"], "card": out["card_after"]}))
        sys.stdout.flush()
        del out
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
