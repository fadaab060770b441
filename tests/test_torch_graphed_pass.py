"""The unfused tier-2 pass over fixed buffers (``ops.fused_pass.GraphedPass``)
on the CPU, where it runs eagerly.

On the card the batched scheduler captures each shape's pass once as a
CUDA graph and replays it (``tests/test_torch_gpu.py`` holds the replays to
the eager route there). Here the same object computes the pass eagerly
into its fixed output buffers, so the CPU tests hold what the graph route
must keep: its results are :func:`leaf_apply`'s and :func:`bank_draws`'s
bit for bit, a run overwrites the buffers the run before filled, and what
a block hands back shares no storage with them.
"""

import numpy as np
import pytest
import torch

from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
from walnuts_tpu_torch.convert import lane_state_from_fields
from walnuts_tpu_torch.core import batched
from walnuts_tpu_torch.core.adapt import (
    adam_init,
    mass_estimator_init,
    mass_estimator_observe,
    min_micro_init,
)
from walnuts_tpu_torch.core.sampler import (
    freeze_params,
    init_sample_state,
    init_warmup_state,
)
from walnuts_tpu_torch.models import funnel
from walnuts_tpu_torch.ops import fused_pass as fp
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.math import make_logp_grad
from walnuts_tpu_torch.parallel.runtime import run_sampling, run_warmup

C, D, R, MAX_DEPTH = 48, 7, 6, 4


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns (floats as integers of their width)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32,
            torch.bfloat16: torch.int16}
    return t.view(ints[t.dtype]) if t.dtype in ints else t


def _assert_bitwise(got, want):
    got, want = fp._leaves(got), fp._leaves(want)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(_bits(a), _bits(b)), i


def _pass_args(seed, cap, warmup, bf16_ends):
    """A synthetic lane state and the pass's other arguments: sampling's
    frozen parameters, or warmup's estimators (``aux``) beside them."""
    fields, p = fp.synthetic_pass_inputs(C, D, MAX_DEPTH, R, seed)
    st = lane_state_from_fields(fields)
    step = torch.from_numpy(p["step"])
    inv_mass = torch.from_numpy(p["inv_mass"])
    min_micro = torch.from_numpy(p["min_micro"])
    st = st._replace(adam=adam_init(step))
    if bf16_ends:
        st = st._replace(stack_e=st.stack_e.to(torch.bfloat16))
    aux = None
    if warmup:
        rng = np.random.default_rng(seed + 1)
        mass = mass_estimator_init(1.0 / inv_mass, 5.0)
        iteration = torch.from_numpy(rng.integers(0, 40, C).astype(np.int32))
        theta, grad = (torch.from_numpy(rng.standard_normal((C, D))) for _ in "tg")
        mass = mass_estimator_observe(mass, theta, grad, iteration)
        mm = min_micro_init(C, 4.0, 1, torch.float64, "cpu")
        aux = (mass, mm._replace(total_macro_steps=torch.from_numpy(
            rng.integers(2, 60, C).astype(np.float64))), iteration)
    active = st.draws_done < cap
    return (st, active, step, inv_mass, min_micro, aux)


def _banked(results):
    out = (torch.zeros((R, C, D), dtype=torch.float64),
           torch.zeros((R, C), dtype=torch.float64),
           torch.zeros((R, C), dtype=torch.int32))
    fp.bank_draws(out, *results[1:6])
    return out


@pytest.mark.parametrize("cap", [3, R])
@pytest.mark.parametrize("defer_splits", [True, False],
                         ids=["deferred", "trip_splits"])
@pytest.mark.parametrize("bf16_ends", [False, True], ids=["f64_ends", "bf16_ends"])
@pytest.mark.parametrize("warmup", [False, True], ids=["sampling", "warmup"])
def test_graphed_pass_is_leaf_apply_and_bank_draws(warmup, bf16_ends, defer_splits,
                                                    cap):
    """Two states through one GraphedPass, the second overwriting the
    first's buffers: each run's results and banked draws equal
    ``leaf_apply`` + ``bank_draws`` on the same arguments bit for bit."""
    replay = prng.replay_split_chain if defer_splits else None
    kw = dict(max_depth=MAX_DEPTH, replay=replay, bf16_ends=bf16_ends)
    first = _pass_args(11, cap, warmup, bf16_ends)
    g = fp.GraphedPass(first, R, **kw)
    outputs = None
    for seed in (11, 12):
        args = _pass_args(seed, cap, warmup, bf16_ends)
        want = fp.leaf_apply(*args[:5], R, aux=args[5], **kw)
        got = g.run(args)
        _assert_bitwise(got, want)
        _assert_bitwise(_banked(got), _banked(want))
        assert g.key(args, R) == g.key(first, R)
        if outputs is not None:  # the same buffers, run after run
            assert all(a is b for a, b in zip(g.outputs, outputs))
        outputs = list(g.outputs)
    assert g.graph is None and g.captures == 0


def _funnel_start(c=16, dim=11):
    lg = make_logp_grad(funnel(dim)[0])
    wcfg = WarmupConfig(min_iter=6, max_iter=6, block_size=3)
    scfg = SamplingConfig(min_iter=6, max_iter=6, block_size=3, max_step_halvings=8)
    keys = prng.fold_in(prng.key(5), torch.arange(c))
    theta = prng.normal(prng.key(6), (c, dim), torch.float64)
    ws = init_warmup_state(keys, theta, torch.ones_like(theta),
                           torch.full((c,), 0.4, dtype=torch.float64), wcfg, scfg)
    return lg, wcfg, scfg, ws


def _run_both_phases(groups):
    lg, wcfg, scfg, ws = _funnel_start()
    kw = dict(batched=True, batched_groups=groups, block_budget=0)
    ws, wd, wl, info = run_warmup(lg, ws, wcfg, scfg, save_warmup=True, **kw)
    ss, d, lp, info = run_sampling(lg, init_sample_state(ws), freeze_params(ws), scfg,
                                   info=info, device_draws=True, **kw)
    return (ws, wd, wl, ss, d, lp), info


def test_pass_counters_are_zero_on_the_cpu():
    """CPU tensors keep the eager pass: no GraphedPass, no replay, no
    capture, in either phase."""
    _, info = _run_both_phases(1)
    assert min(info.n_outer_trips.values()) > 0
    assert info.n_pass_replays == {"warmup": 0, "sampling": 0}
    assert info.n_pass_captures == {"warmup": 0, "sampling": 0}


def _force_graphed(monkeypatch) -> list:
    """The card's route forced on CPU tensors; returns the list of the
    GraphedPass objects the blocks make."""
    made = []

    class Kept(fp.GraphedPass):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(batched, "_graph_passes", lambda device: True)
    monkeypatch.setattr(batched, "GraphedPass", Kept)
    return made


def test_fixed_buffer_route_is_the_eager_route(monkeypatch):
    """The route the card takes, run eagerly here: warmup and sampling in
    two cost-sorted groups (the second group's passes overwrite the
    buffers the first group's returned state came from) give the eager
    route's draws, log densities, states and counters bit for bit; every
    pass runs on the buffers, one GraphedPass a phase."""
    want, info_w = _run_both_phases(2)
    made = _force_graphed(monkeypatch)
    got, info_g = _run_both_phases(2)
    _assert_bitwise(got, want)
    assert len(made) == 2
    for k in ("n_inner_trips", "n_outer_trips", "n_syncs", "n_blocks"):
        assert getattr(info_g, k) == getattr(info_w, k), k
    assert info_g.n_pass_replays == info_g.n_outer_trips
    assert info_g.n_pass_captures == {"warmup": 0, "sampling": 0}
    for k in ("n_grads", "n_halve_fail", "n_nonfinite", "n_depth_exhausted"):
        np.testing.assert_array_equal(getattr(info_g, k), getattr(info_w, k))


def test_block_state_shares_no_storage_with_pass_buffers(monkeypatch):
    """What a warmup block and a sampling block hand back (end keys,
    counters, the warmup state's estimators and Adam) shares no storage
    with the pass's input or output buffers, which the next block's runs
    overwrite."""
    made = _force_graphed(monkeypatch)
    lg, wcfg, scfg, ws = _funnel_start()
    wblock = batched.make_batched_warmup_block(lg, scfg, runahead=4, tier2_every=12)
    ws, wres = wblock(ws, 3)
    start, sample = batched.make_batched_sample_block(
        lg, scfg.max_trajectory_doublings, scfg.max_step_halvings)
    params = freeze_params(ws)
    st = start(ws.key, ws.theta, ws.n_grads, ws.fails, *params)
    sres = sample(st, *params, scfg.max_hamiltonian_error, 3)
    assert wres.n_pass_replays == wres.n_outer_trips > 0
    assert sres.n_pass_replays == sres.n_outer_trips > 0
    buffers = {t.untyped_storage().data_ptr()
               for g in made for t in g.inputs + g.outputs}
    assert len(made) == 2
    for what, tree in (("warmup state", ws), ("warmup block", wres),
                       ("sampling block", sres)):
        for i, t in enumerate(fp._leaves(tree)):
            if isinstance(t, torch.Tensor):
                assert t.untyped_storage().data_ptr() not in buffers, (what, i)
