"""One rank of the port's chain mesh on the CPU, for test_torch_sharding.py.

Run as ``python -m tests.torch_mesh_ranks RANK WORLD INIT_FILE OUT_DIR``
from the root of the repository, once per rank: it joins a gloo process
group at the ``file://`` rendezvous ``INIT_FILE``, builds the mesh
``init_device_mesh("cpu", (WORLD,), mesh_dim_names=("chains",))``, runs
every case of ``CASES`` (and the interrupt, checkpoint and refusal cases)
under it, and writes what this rank got to ``OUT_DIR/<case>_r<RANK>.npz``
(``refusals_r<RANK>.json`` for the refusals). Last, rank 1 exits with
DEATH_CODE in the middle of a run, and rank 0 records the error its next
collective raised. Every collective times out after ``TIMEOUT_S``; any
other failure exits non-zero with its traceback. The test file runs the
same cases without a mesh and compares. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import sys
from datetime import timedelta

import numpy as np
import torch

import walnuts_tpu_torch as wtt
from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
from walnuts_tpu_torch.core.adapt import nutpie_init_mass
from walnuts_tpu_torch.core.sampler import (
    freeze_params,
    init_sample_state,
    init_warmup_state,
)
from walnuts_tpu_torch.models import std_normal
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.math import make_logp_grad
from walnuts_tpu_torch.parallel import checkpoint as ck_mod
from walnuts_tpu_torch.parallel.runtime import run_sampling, run_warmup, shard_chains

TIMEOUT_S = 60
# walnuts() cases, each on std_normal(dim) in float64 on the CPU; the first
# three mirror tests/test_sharding.py (its :62-77, :110-129, :131-141)
CASES = {
    "base": dict(dim=2, num_chains=8, seed=321, min_warmup_iter=10,
                 max_warmup_iter=10, min_sampling_iter=10, max_sampling_iter=10),
    "batched_block6": dict(dim=3, num_chains=16, seed=99, min_warmup_iter=12,
                           max_warmup_iter=12, min_sampling_iter=12,
                           max_sampling_iter=12, block_size=6, batched=True),
    "early_stop": dict(dim=2, num_chains=8, seed=11, min_warmup_iter=20,
                       max_warmup_iter=200, min_sampling_iter=20,
                       max_sampling_iter=500, block_size=10),
    "classic": dict(dim=2, num_chains=8, seed=321, min_warmup_iter=10,
                    max_warmup_iter=10, min_sampling_iter=10, max_sampling_iter=10,
                    batched=False),
    "thin_average": dict(dim=2, num_chains=8, seed=321, min_warmup_iter=10,
                         max_warmup_iter=10, min_sampling_iter=10,
                         max_sampling_iter=10, block_size=10, thin=2,
                         average_masses=True, save_warmup=True),
}
# the checkpoint case: blocks of 2, crashed right after the first sampling
# block's save
CKPT = dict(dim=3, num_chains=8, seed=77, min_warmup_iter=4, max_warmup_iter=4,
            min_sampling_iter=6, max_sampling_iter=6, block_size=2,
            save_warmup=True)
CKPT_CRASH = ("sampling", 2)
# the interrupt case: run_warmup / run_sampling of 4 chains, blocks of 2;
# the run stops at the boundary after INTERRUPT_AT iterations
INTERRUPT_AT = 4
# the last case: rank 1 exits with this code in the middle of a warmup
DEATH_CODE = 17


def run_case(kw: dict, mesh=None, **extra):
    """``walnuts`` on a case: its draws, log densities... as a dict of
    arrays (every chain)."""
    kw = dict(kw, **extra)
    logp, dim = std_normal(kw.pop("dim"))
    out, info = wtt.walnuts(logp, num_params=dim, dtype=torch.float64, device="cpu",
                            mesh=mesh, return_info=True, save_inv_metric=True, **kw)
    res = dict(
        draws=np.stack([np.asarray(c) for c in out]),
        stepsize=np.array([c.warmup.stepsize for c in out]),
        inv_metric=np.stack([c.warmup.inv_metric for c in out]),
        iters=np.array([info.warmup_iters, info.sampling_iters]),
        rhat_trace=np.asarray(info.rhat_trace, dtype=np.float64),
        converged=np.array([info.converged_warmup, info.converged_sampling]),
    )
    for k in ("n_grads", "n_halve_fail", "n_nonfinite", "n_depth_exhausted"):
        res[k] = getattr(info, k)
    if out[0].warmup.warmup_draws is not None:
        res["warmup_draws"] = np.stack([c.warmup.warmup_draws for c in out])
        res["warmup_logps"] = np.stack([c.warmup.warmup_logps for c in out])
    return res


def _warmup_setup():
    """A warmup state of 4 chains (made alike on every rank), blocks of 2."""
    logp, dim = std_normal(3)
    lg = make_logp_grad(logp)
    wcfg = WarmupConfig(min_iter=8, max_iter=8, block_size=2)
    scfg = SamplingConfig(min_iter=8, max_iter=8, block_size=2)
    C = 4
    base = prng.key(3, "cpu")
    keys = prng.fold_in(base, torch.arange(C))
    theta0 = 2.0 * prng.normal(prng.fold_in(base, 99), (C, dim), torch.float64)
    mass = nutpie_init_mass(lg(theta0)[1], torch.tensor(1e-5, dtype=torch.float64))
    ws = init_warmup_state(keys, theta0, mass, torch.full((C,), 0.5, dtype=torch.float64),
                           wcfg, scfg)
    return lg, ws, wcfg, scfg


def interrupt_case(mesh=None, stop_rank=None, sigint_rank=None):
    """``run_warmup`` then ``run_sampling`` of ``_warmup_setup``, each
    stopped at the boundary after INTERRUPT_AT iterations: by a
    ``KeyboardInterrupt`` raised from ``progress`` in warmup on
    ``stop_rank`` (every rank for None), by a SIGINT sent from ``progress``
    in sampling on ``sigint_rank`` (a ``KeyboardInterrupt`` on every rank
    for None)."""
    lg, ws, wcfg, scfg = _warmup_setup()
    rank = None if mesh is None else mesh.get_local_rank()

    def progress(stop, how):
        def call(phase, it):
            if it == INTERRUPT_AT and stop in (None, rank):
                if how == "sigint":
                    os.kill(os.getpid(), signal.SIGINT)
                else:
                    raise KeyboardInterrupt
        return call

    ws, wd, _, wi = run_warmup(lg, ws, wcfg, scfg, save_warmup=True, mesh=mesh,
                               batched=True, progress=progress(stop_rank, "raise"))
    params = freeze_params(ws)
    how = "raise" if sigint_rank is None else "sigint"
    ss, sd, slp, si = run_sampling(lg, init_sample_state(ws), params, scfg, mesh=mesh,
                                   batched=True, device_draws=True,
                                   progress=progress(sigint_rank, how))
    return dict(warmup_draws=wd.numpy(), draws=sd.numpy(), logps=slp.numpy(),
                theta=ss.theta.numpy(), step=params.step_size.numpy(),
                n_grads=si.n_grads,
                iters=np.array([wi.warmup_iters, si.sampling_iters]),
                interrupted=np.array([wi.interrupted, si.interrupted]))


def crash_and_resume(mesh, directory: str, copy_to: str):
    """The checkpoint case under ``mesh``: crashed right after CKPT_CRASH's
    save on every rank, the directory copied to ``copy_to`` by rank 0, then
    resumed."""
    real = ck_mod.BlockCheckpointer.block

    def block(self, phase, it, *args, **kwargs):
        real(self, phase, it, *args, **kwargs)
        if (phase, it) == CKPT_CRASH:
            raise RuntimeError("simulated preemption")

    ck_mod.BlockCheckpointer.block = block
    try:
        run_case(CKPT, mesh, checkpoint_dir=directory)
    except RuntimeError as e:
        if "simulated preemption" not in str(e):
            raise
    else:
        raise AssertionError("the staged crash was not raised")
    finally:
        ck_mod.BlockCheckpointer.block = real
    if mesh.get_local_rank() == 0:
        shutil.copytree(directory, copy_to)
    torch.distributed.barrier()
    return run_case(CKPT, mesh, checkpoint_dir=directory)


def rank_dies(mesh) -> str:
    """Rank 1 exits (DEATH_CODE) from ``progress`` after the first block of
    a warmup; on the other ranks the next collective must raise: its
    message."""
    lg, ws, wcfg, scfg = _warmup_setup()

    def progress(phase, it):
        if mesh.get_local_rank() == 1:
            os._exit(DEATH_CODE)

    try:
        run_warmup(lg, ws, wcfg, scfg, mesh=mesh, batched=True, progress=progress)
    except RuntimeError as e:
        return f"{type(e).__name__}: {e}"
    raise AssertionError("the rank's death did not raise")


def refusals(mesh) -> dict:
    """The message of each refusal of a mesh (None if nothing raised)."""
    from torch.distributed.device_mesh import init_device_mesh

    other = init_device_mesh("cpu", (mesh.size(),), mesh_dim_names=("dp",))
    cases = {
        "batched_groups": dict(batched_groups=2),
        "indivisible": dict(num_chains=7),
        "device": dict(device="cuda"),
        "dim_name": dict(mesh=other),
        "chain_groups": dict(chain_groups=2),
    }
    out = {}
    for name, extra in cases.items():
        kw = dict(dict(num_params=2, num_chains=8, seed=1, device="cpu", mesh=mesh,
                       min_warmup_iter=1, max_warmup_iter=1, min_sampling_iter=1,
                       max_sampling_iter=1), **extra)
        try:
            wtt.walnuts(std_normal(2)[0], **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["shard_rows"] = shard_chains(torch.arange(8.0), mesh).tolist()
    return out


def main(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("chains",))

        def save(name, res):
            np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"), **res)

        for name, kw in CASES.items():
            save(name, run_case(kw, mesh))
        save("interrupt", interrupt_case(mesh, stop_rank=1, sigint_rank=0))
        save("checkpoint_plain", run_case(CKPT, mesh))
        save("checkpoint_resumed", crash_and_resume(
            mesh, os.path.join(out_dir, "ckpt"), os.path.join(out_dir, "ckpt_copy")))
        found = refusals(mesh)
        found["death"] = rank_dies(mesh)
        with open(os.path.join(out_dir, f"refusals_r{rank}.json"), "w") as f:
            json.dump(found, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
