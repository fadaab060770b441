"""Checkpoint and resume of the port (``parallel/checkpoint.py``, the
``checkpoint_dir`` options of ``walnuts``), on the CPU.

The port's mirror of ``tests/test_checkpoint.py`` (all but its mesh case):
a resumed run must return the draws, step sizes and inverse metrics of the
uninterrupted run bit for bit (the state holds the keys), and
checkpointing must not perturb the run that writes it. One case holds a
checkpointed run against the JAX package's ``walnuts`` at the same
arguments: counts exact, draws to rtol 1e-9 in float64. A crash is an
exception raised right after a block has been recorded (the reference's
tests shorten ``run_sampling`` instead; that runs an R-hat check at the
shortened ``min_iter`` which the uninterrupted run does not).
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as wtt
import walnuts_tpu_torch.api as api_mod
from walnuts_tpu.models import std_normal as jax_std_normal
from walnuts_tpu_torch.models import std_normal
from walnuts_tpu_torch.parallel import checkpoint as ck_mod

LOGP, DIM = std_normal(3)
# blocks of one iteration: a crash after the third sampling block leaves,
# with every 2, a durable checkpoint at the second and a written block lost
BASE = dict(num_params=DIM, num_chains=2, seed=77, min_warmup_iter=2,
            max_warmup_iter=2, min_sampling_iter=4, max_sampling_iter=4,
            block_size=1, save_warmup=True, save_inv_metric=True)


def run(tmp=None, **kwargs):
    args = {**BASE, "dtype": torch.float64, "device": "cpu", **kwargs}
    if tmp is not None:
        args["checkpoint_dir"] = str(tmp)
    return wtt.walnuts(LOGP, **args)


def assert_same(a, b, warmup=True):
    """Per chain: draws, step size, inverse metric (and warmup draws)
    bitwise equal."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert x.warmup.stepsize == y.warmup.stepsize
        np.testing.assert_array_equal(x.warmup.inv_metric, y.warmup.inv_metric)
        if warmup:
            np.testing.assert_array_equal(x.warmup.warmup_draws, y.warmup.warmup_draws)
            np.testing.assert_array_equal(x.warmup.warmup_logps, y.warmup.warmup_logps)


def assert_counters_equal(i, j):
    """Every RunInfo counter but the wall seconds."""
    for k in ("warmup_iters", "sampling_iters", "rhat_trace", "converged_warmup",
              "converged_sampling", "n_inner_trips", "n_outer_trips", "n_syncs",
              "n_pass_replays", "n_pass_captures", "n_blocks"):
        assert getattr(i, k) == getattr(j, k), k
    for k in ("n_grads", "n_halve_fail", "n_nonfinite", "n_depth_exhausted"):
        np.testing.assert_array_equal(getattr(i, k), getattr(j, k))


def crash_after(monkeypatch, phase: str, it: int):
    """The process dies right after the block of ``phase`` that ends at
    iteration ``it`` has been recorded (and, every ``every`` blocks,
    saved): what was durable then is all a resumed run finds."""
    real = ck_mod.BlockCheckpointer.block

    def block(self, ph, at, *args, **kwargs):
        real(self, ph, at, *args, **kwargs)
        if (ph, at) == (phase, it):
            raise RuntimeError("simulated preemption")

    monkeypatch.setattr(ck_mod.BlockCheckpointer, "block", block)


@pytest.fixture(scope="module")
def plain():
    return run(return_info=True)


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """A run that checkpoints every block, and its directory."""
    d = tmp_path_factory.mktemp("ck") / "run"
    out, info = run(d, return_info=True)
    return out, info, d


def test_checkpointing_does_not_perturb_the_run(plain, checkpointed):
    assert_same(plain[0], checkpointed[0])
    assert_counters_equal(plain[1], checkpointed[1])
    names = sorted(os.listdir(checkpointed[2] / "blocks"))
    assert names == ([f"sampling_{i:08d}.npz" for i in range(4)]
                     + [f"warmup_{i:08d}.npz" for i in range(2)])


def test_checkpointed_run_matches_reference(checkpointed):
    """The JAX package's walnuts at the same sampler arguments: counts
    exact, draws to rtol 1e-9. (Its own checkpointing does not perturb its
    run: tests/test_checkpoint.py.)"""
    jo, ji = wt.walnuts(jax_std_normal(DIM)[0], dtype=jnp.float64, return_info=True,
                        **BASE)
    to, ti = checkpointed[:2]
    assert (ti.warmup_iters, ti.sampling_iters) == (ji.warmup_iters, ji.sampling_iters)
    np.testing.assert_array_equal(ti.n_grads, ji.n_grads)
    np.testing.assert_array_equal(ti.n_halve_fail, ji.n_halve_fail)
    np.testing.assert_array_equal(ti.n_nonfinite, ji.n_nonfinite)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(a.warmup.warmup_draws, b.warmup.warmup_draws,
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(a.warmup.stepsize, b.warmup.stepsize, rtol=1e-9)


def test_completed_run_resumes_to_identical_output(checkpointed, tmp_path):
    """A second call finds the completed checkpoint: warmup is skipped,
    every sampling block comes from the store, and the restored counters
    are the whole run's."""
    d = tmp_path / "ck"
    shutil.copytree(checkpointed[2], d)
    out, info = run(d, return_info=True)
    assert_same(checkpointed[0], out)
    assert_counters_equal(checkpointed[1], info)


def test_state_slots_hold_copies_not_views(checkpointed):
    """Each saved tensor owns its storage: the sampling state's theta is a
    row of the draw tensor, and must not bring the whole tensor along."""
    for slot in ("state_a", "state_b"):
        flat = torch.load(checkpointed[2] / slot / "state.pt", weights_only=True)
        for name, t in flat.items():
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), name
        theta = flat["state/theta"]
        assert theta.shape == (BASE["num_chains"], DIM)


@pytest.mark.parametrize("every,kw", [
    (1, {}),
    # other run-ahead, cadence and cost-sorted groups: scheduling only on
    # a model without a matrix product, so the same draws
    (2, dict(batched_groups=2, runahead=4, tier2_every=3)),
], ids=["every1", "every2_groups"])
def test_crash_mid_sampling_resumes_bitwise(plain, tmp_path, monkeypatch, every, kw):
    crash_after(monkeypatch, "sampling", 3)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        run(tmp_path / "ck", checkpoint_every=every, **kw)
    monkeypatch.undo()
    out, info = run(tmp_path / "ck", checkpoint_every=every, return_info=True, **kw)
    assert_same(plain[0], out)
    np.testing.assert_array_equal(plain[1].n_grads, info.n_grads)
    assert info.sampling_iters == 4


def test_crash_mid_warmup_resumes_bitwise(plain, tmp_path, monkeypatch):
    crash_after(monkeypatch, "warmup", 1)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        run(tmp_path / "ck")
    monkeypatch.undo()
    out, info = run(tmp_path / "ck", return_info=True)
    assert_same(plain[0], out)
    assert_counters_equal(plain[1], info)


def test_early_stopped_sampling_does_not_extend_on_rerun(tmp_path):
    """A run that stopped on R-hat at 2 < max_iter returns the same 2
    draws when called again (the restored converged flag)."""
    kw = dict(min_sampling_iter=2, rhat_converge_tol=1e6)
    first = run(tmp_path / "ck", **kw)
    assert np.asarray(first[0]).shape[0] == 2
    assert_same(first, run(tmp_path / "ck", **kw))


def test_crash_after_converged_warmup_does_not_keep_adapting(tmp_path, monkeypatch):
    """A crash between the last (converged) warmup checkpoint and the
    sampling phase change resumes with warmup converged: the frozen
    tuning is the uninterrupted run's."""
    kw = dict(min_warmup_iter=1, max_warmup_iter=4, mass_converge_tol=1e6,
              step_size_converge_tol=1e6)
    plain = run(**kw)
    assert plain[0].warmup.warmup_draws.shape[0] == 1  # converged early
    real = api_mod.run_warmup

    def warmup_then_crash(*args, **kwargs):
        real(*args, **kwargs)
        raise RuntimeError("simulated preemption")

    monkeypatch.setattr(api_mod, "run_warmup", warmup_then_crash)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        run(tmp_path / "ck", **kw)
    monkeypatch.undo()
    assert_same(plain, run(tmp_path / "ck", **kw))


def test_changed_seed_refuses_resume_and_resume_false_starts_over(checkpointed,
                                                                  tmp_path):
    """resume=True with another seed must not replay the stored run (the
    fingerprint differs: a warning, and the run starts over), and
    resume=False starts over: both are the new seed's fresh run."""
    for name in ("a", "b"):
        shutil.copytree(checkpointed[2], tmp_path / name)
    with pytest.warns(UserWarning, match="different run arguments"):
        refused = run(tmp_path / "a", seed=78)
    fresh = run(tmp_path / "b", seed=78, resume=False)
    assert_same(refused, fresh)
    assert not np.array_equal(np.asarray(fresh[0]), np.asarray(checkpointed[0][0]))


@pytest.mark.parametrize("crash_mid_compaction", [False, True])
def test_keep_last_n_compaction(plain, tmp_path, monkeypatch, crash_mid_compaction):
    """keep_last_n bounds the block-file count without dropping draws; a
    crash that leaves both the merged file and a merged-away one still
    resumes to the exact draws."""
    d = tmp_path / "ck"
    if crash_mid_compaction:
        real_remove = os.remove
        crashed = []

        def failing_remove(path):
            # die before deleting the first merged leftover, once
            if "blocks" in str(path) and not crashed:
                crashed.append(path)
                raise RuntimeError("simulated crash mid-compaction")
            real_remove(path)

        monkeypatch.setattr(ck_mod.os, "remove", failing_remove)
        with pytest.raises(RuntimeError, match="mid-compaction"):
            run(d, checkpoint_keep_last_n=1)
        monkeypatch.undo()
        resumed = run(d, checkpoint_keep_last_n=1)
    else:
        run(d, checkpoint_keep_last_n=2)
        blocks = os.listdir(d / "blocks")
        for phase in ("warmup", "sampling"):
            n = sum(1 for b in blocks if b.startswith(phase))
            assert n <= 2, f"{phase}: {n} block files survived compaction"
        resumed = run(d, checkpoint_keep_last_n=2)
    assert_same(plain[0], resumed)


def test_checkpointer_validates_its_options(tmp_path):
    with pytest.raises(ValueError, match="every"):
        wtt.BlockCheckpointer(str(tmp_path), every=0)
    with pytest.raises(ValueError, match="keep_last_n"):
        wtt.BlockCheckpointer(str(tmp_path), keep_last_n=0)
    with pytest.raises(FileNotFoundError):
        wtt.BlockCheckpointer(str(tmp_path)).restore(None)
