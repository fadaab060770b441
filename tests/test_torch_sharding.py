"""Chains sharded over a mesh of ranks (``walnuts(mesh=...)``), on the CPU.

The port's mirror of ``tests/test_sharding.py``. The JAX package shards
the chain axis over an 8-device virtual mesh from one process; the port
runs one process per device under ``torch.distributed``. One pair of gloo
ranks (``tests/torch_mesh_ranks.py``, a ``file://`` rendezvous under a
temporary directory) is started once for the module and runs every case
under ``init_device_mesh("cpu", (2,), mesh_dim_names=("chains",))``, while
this process runs the same cases with ``mesh=None``. Sharding must not
change the math: every rank returns every chain, and its draws, step
sizes, inverse metrics, counters, early-stop iterations and interrupt
block equal the unsharded run's bit for bit (a chain's arithmetic does not
depend on the chain count on the CPU, and the cross-chain statistics are
gathered, then reduced as without a mesh). The base case also equals the
JAX package's run on its 8-device mesh: counts exact, floats to atol
1e-10 in float64, the tolerance of ``tests/test_sharding.py``. The ranks
get RANKS_TIMEOUT_S; one that fails takes the test down with its
traceback, and the others are killed.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import walnuts_tpu as wt
from tests import torch_mesh_ranks as ranks
from walnuts_tpu.models import std_normal as jax_std_normal
from walnuts_tpu_torch.parallel import runtime

WORLD = 2
RANKS_TIMEOUT_S = 180
ROOT = Path(__file__).resolve().parents[1]
_COMPARED = ("draws", "stepsize", "inv_metric", "iters", "rhat_trace", "converged",
             "n_grads", "n_halve_fail", "n_nonfinite", "n_depth_exhausted")


def _wait(procs, logs, deadline: float) -> None:
    """Wait for every rank (rank 1 ends with ``ranks.DEATH_CODE``, the
    others with 0); on a failure or the deadline kill the rest and fail
    with the failed rank's output."""
    codes = [ranks.DEATH_CODE if r == 1 else 0 for r in range(WORLD)]
    while any(p.poll() is None for p in procs):
        failed = [r for r, p in enumerate(procs) if p.poll() not in (None, codes[r])]
        if failed or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            r = failed[0] if failed else 0
            pytest.fail(f"mesh rank {r} {'failed' if failed else 'timed out'}:\n"
                        f"{logs[r].read_text()[-6000:]}")
        time.sleep(0.2)
    for r, p in enumerate(procs):
        if p.returncode != codes[r]:
            pytest.fail(f"mesh rank {r} failed:\n{logs[r].read_text()[-6000:]}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results (``mesh[case][rank]``) and this process's
    unsharded runs of the same cases (``single[case]``)."""
    out = tmp_path_factory.mktemp("mesh")
    logs = [out / f"rank{r}.log" for r in range(WORLD)]
    procs = []
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        for r in range(WORLD):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_mesh_ranks", str(r), str(WORLD),
                     str(out / "rendezvous"), str(out)],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        single = {name: ranks.run_case(kw) for name, kw in ranks.CASES.items()}
        single["checkpoint_plain"] = ranks.run_case(ranks.CKPT)
        single["interrupt"] = ranks.interrupt_case()
        _wait(procs, logs, deadline)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    mesh = {}
    for f in out.glob("*_r*.npz"):
        case, r = f.stem.rsplit("_r", 1)
        with np.load(f) as z:
            mesh.setdefault(case, {})[int(r)] = dict(z)
    refusals = [json.loads((out / f"refusals_r{r}.json").read_text())
                for r in range(WORLD) if r != 1]
    # the checkpoint the ranks wrote, as it was at the crash, resumed here
    # without a mesh: its state is the whole chain axis
    single["resumed_unsharded"] = ranks.run_case(
        ranks.CKPT, checkpoint_dir=str(out / "ckpt_copy"))
    return mesh, single, refusals


def _assert_equal(got: dict, want: dict, keys=_COMPARED) -> None:
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharding_helpers_without_mesh():
    assert runtime.CHAIN_AXIS == "chains"
    assert runtime.chain_sharding(None) is None
    tree = runtime.FrozenParams(torch.ones(4), torch.ones(4, 2), torch.ones(4))
    assert runtime.shard_chains(tree, None) is tree
    assert {"CHAIN_AXIS", "chain_sharding", "shard_chains"} <= set(runtime.__all__)


@pytest.mark.parametrize("case", [*ranks.CASES, "checkpoint_plain"])
def test_mesh_matches_single_device(runs, case):
    """Every rank returns every chain, bitwise the unsharded run's: draws,
    step sizes, inverse metrics, iterations, R-hat trace and counters."""
    mesh, single, _ = runs
    for r in range(WORLD):
        _assert_equal(mesh[case][r], single[case])
        if "warmup_draws" in single[case]:
            _assert_equal(mesh[case][r], single[case], ("warmup_draws", "warmup_logps"))


def test_mesh_matches_jax_mesh(runs):
    """The base case against the JAX package's run on its 8-device virtual
    mesh (tests/test_sharding.py::test_mesh_matches_single_device's
    configuration): counts exact, floats to atol 1e-10."""
    devices = jax.devices()
    assert len(devices) == 8, "conftest should provide 8 virtual CPU devices"
    kw = dict(ranks.CASES["base"])
    logp, dim = jax_std_normal(kw.pop("dim"))
    out, info = wt.walnuts(logp, num_params=dim, dtype=jnp.float64, return_info=True,
                           save_inv_metric=True, mesh=Mesh(np.array(devices), ("chains",)),
                           **kw)
    got = runs[0]["base"][1]
    assert tuple(got["iters"]) == (info.warmup_iters, info.sampling_iters)
    for k in ("n_grads", "n_halve_fail", "n_nonfinite", "n_depth_exhausted"):
        np.testing.assert_array_equal(got[k], getattr(info, k), err_msg=k)
    np.testing.assert_allclose(got["draws"], np.stack([np.asarray(c) for c in out]),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["stepsize"], [c.warmup.stepsize for c in out],
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["inv_metric"],
                               np.stack([c.warmup.inv_metric for c in out]),
                               rtol=0, atol=1e-10)


def test_early_stopping_on_mesh(runs):
    """Both ranks stop warmup and sampling at the unsharded run's
    boundaries, inside [min, max] (tests/test_sharding.py:131-141)."""
    mesh, single, _ = runs
    w, s = single["early_stop"]["iters"]
    assert 20 <= w < 200 and 20 <= s <= 500
    for r in range(WORLD):
        assert tuple(mesh["early_stop"][r]["iters"]) == (w, s)
        assert mesh["early_stop"][r]["draws"].shape == (8, s, 2)


def test_interrupt_on_one_rank_stops_every_rank(runs):
    """A KeyboardInterrupt from ``progress`` on rank 1 only (warmup), and a
    SIGINT on rank 0 only (sampling, held until the block boundary): both
    ranks stop at the boundary after 4 iterations with ``interrupted``,
    and return the unsharded run's state and draws to there."""
    mesh, single, _ = runs
    want = single["interrupt"]
    assert tuple(want["iters"]) == (ranks.INTERRUPT_AT, ranks.INTERRUPT_AT)
    for r in range(WORLD):
        got = mesh["interrupt"][r]
        assert got["interrupted"].all()
        _assert_equal(got, want, tuple(want))


def test_checkpoint_resume_on_mesh(runs):
    """Crashed right after the first sampling block's save and resumed
    under the mesh: bitwise the uninterrupted mesh run. The checkpoint the
    ranks wrote holds the whole chain axis: resumed without a mesh it
    gives the same run."""
    mesh, single, _ = runs
    for r in range(WORLD):
        keys = (*_COMPARED[:3], "n_grads", "warmup_draws", "warmup_logps")
        _assert_equal(mesh["checkpoint_resumed"][r], mesh["checkpoint_plain"][r], keys)
    _assert_equal(single["resumed_unsharded"], single["checkpoint_plain"],
                  (*_COMPARED[:3], "n_grads"))


@pytest.mark.parametrize("case,match", [
    ("batched_groups", "batched_groups > 1 requires mesh=None"),
    ("indivisible", r"num_chains \(7\) must divide by the mesh size \(2\)"),
    ("device", "disagrees with the mesh's device"),
    ("dim_name", "mesh must be a one-dimensional"),
    ("chain_groups", "chain_groups requires mesh=None"),
])
def test_mesh_refusals(runs, case, match):
    """The refusals of a mesh: ValueError (rank 0's record)."""
    msg = runs[2][0][case]
    assert msg is not None, f"{case} did not raise"
    assert re.search(match, msg), msg


def test_a_rank_that_dies_makes_the_others_raise(runs):
    """Rank 1 exits in the middle of a warmup (and ends with its exit code,
    checked by the fixture); rank 0's next collective raises instead of
    waiting."""
    assert runs[2][0]["death"].startswith(("RuntimeError", "DistBackendError",
                                           "DistNetworkError")), runs[2][0]["death"]


def test_shard_chains_takes_the_rank_rows(runs):
    """``shard_chains``: rank 0's contiguous rows of the chain axis (rank
    1's are the other half: every case's whole result passes through
    them)."""
    assert runs[2][0]["shard_rows"] == [0.0, 1.0, 2.0, 3.0]
