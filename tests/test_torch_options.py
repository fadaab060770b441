"""The reference's scheduler options and runtime keywords in the port (CPU).

Funnel(4), 6 chains, float64, one sampling block of 6 draws from the same
start state in both packages (converted with ``walnuts_tpu_torch.convert``).
The JAX package runs its classic sampler (with ``bf16_ends``, and its
flattened sampler) and a 4-iteration classic warmup with ``bf16_ends``;
its tests hold every scheduling option to the classic path bit for bit
(``tests/test_batched.py``, ``tests/test_runtime.py``,
``tests/test_transition.py``), so each of the port's options is held:

- to the port's own reference route bit for bit (``torch.equal``) where
  the JAX package asserts bitwise equality: every batched option against
  the default batched block, the batched block against the classic path,
  ``chain_groups`` and ``flatten`` against the classic path;
- to the JAX package's run: integers (keys, gradient counts, failure
  counters) exactly, floats to rtol 1e-10 with an absolute floor of
  1e-12 (summation order and the normals' last ulps, see
  ``test_torch_prng.py``).
"""

import inspect
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as wtt
from walnuts_tpu.config import SamplingConfig, WarmupConfig
from walnuts_tpu.core import batched as jax_batched
from walnuts_tpu.core import sampler as jax_sampler
from walnuts_tpu.core import transition as jax_transition
from walnuts_tpu.models import funnel as jax_funnel
from walnuts_tpu.ops.math import make_logp_grad as jax_logp_grad
from walnuts_tpu.parallel import runtime as jax_runtime
from walnuts_tpu_torch import convert
from walnuts_tpu_torch.config import SamplingConfig as TSamplingConfig
from walnuts_tpu_torch.config import WarmupConfig as TWarmupConfig
from walnuts_tpu_torch.core import batched, sampler, transition
from walnuts_tpu_torch.core.sampler import freeze_params
from walnuts_tpu_torch.core.transition import round_bf16
from walnuts_tpu_torch.models import funnel
from walnuts_tpu_torch.models.kernels import funnel_vg
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.integrator import make_fused_integrator
from walnuts_tpu_torch.ops.math import make_logp_grad
from walnuts_tpu_torch.parallel import runtime
from walnuts_tpu_torch.parallel.runtime import _BlockBudget

C, DIM, DRAWS = 6, 4, 6
TOL = dict(rtol=1e-10, atol=1e-12)
_SCFG = dict(min_iter=DRAWS, max_iter=DRAWS, block_size=DRAWS,
             max_trajectory_doublings=5, max_step_halvings=6)
_WCFG = dict(min_iter=4, max_iter=4, block_size=4)


def _np_tree(tree):
    return jax.tree.map(
        lambda x: np.asarray(jax.random.key_data(x))
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else np.asarray(x),
        tree)


def _copy(tree):  # the JAX runtime donates its state buffers
    return jax.tree.map(jnp.array, tree)


@pytest.fixture(scope="module")
def ref():
    """The start state, the JAX package's runs from it, and its bf16 warmup."""
    lg = jax_logp_grad(jax_funnel(DIM)[0])
    wcfg, scfg = WarmupConfig(**_WCFG), SamplingConfig(**_SCFG)
    base = jax.random.key(31)
    keys = jax.vmap(lambda c: jax.random.fold_in(base, c))(jnp.arange(C))
    theta0 = jax.random.normal(jax.random.fold_in(base, 99), (C, DIM))
    step0 = jnp.exp(0.3 * jax.random.normal(jax.random.fold_in(base, 98), (C,))) * 0.4
    ws = jax.vmap(lambda k, t, s: jax_sampler.init_warmup_state(
        k, t, jnp.ones(DIM), s, wcfg, scfg))(keys, theta0, step0)
    params = jax.vmap(jax_sampler.freeze_params)(ws)
    ss = jax.vmap(jax_sampler.init_sample_state)(ws)
    out = dict(ws=_np_tree(ws), ss=_np_tree(ss), params=_np_tree(params))
    for name, kw in (("classic", {}), ("bf16", dict(bf16_ends=True)),
                     ("flat", dict(flatten=True))):
        st, d, lp, info = jax_runtime.run_sampling(lg, _copy(ss), params, scfg, **kw)
        out[name] = (_np_tree(st), np.asarray(d), np.asarray(lp), info)
    wsb, _, _, winfo = jax_runtime.run_warmup(lg, _copy(ws), wcfg, scfg,
                                              bf16_ends=True)
    out["warm_bf16"] = (_np_tree(wsb), winfo)
    return out


def _lg():
    return make_logp_grad(funnel(DIM)[0])


def _run(ref, lg=None, **kw):
    """The port's ``run_sampling`` from the reference's start state."""
    return runtime.run_sampling(lg or _lg(), convert.sample_state(ref["ss"]),
                                convert.frozen_params(ref["params"]),
                                TSamplingConfig(**{**_SCFG, **kw.pop("scfg", {})}),
                                **kw)


@pytest.fixture(scope="module")
def classic(ref):
    return _run(ref)


@pytest.fixture(scope="module")
def batched_run(ref):
    return _run(ref, batched=True)


def _assert_like_reference(port, jref, n_grads=True):
    """A port run against a JAX run: keys and counters exactly, floats to
    TOL."""
    st, d, lp, info = port
    jst, jd, jlp, jinfo = jref
    np.testing.assert_array_equal(convert.key_data_numpy(st.key), jst.key)
    if n_grads:
        np.testing.assert_array_equal(info.n_grads, jinfo.n_grads)
    for name in ("n_halve_fail", "n_nonfinite", "n_depth_exhausted"):
        np.testing.assert_array_equal(getattr(info, name), getattr(jinfo, name))
    np.testing.assert_allclose(d.numpy(), jd, **TOL)
    np.testing.assert_allclose(lp.numpy(), jlp, **TOL)


def _assert_same(a, b, keys=True):
    """Two port runs bit for bit: draws, log densities, (end keys)."""
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    if keys:
        assert torch.equal(a[0].key, b[0].key)


# ---------------------------------------------------------------------------
# the runtime's default and the signatures
# ---------------------------------------------------------------------------

def test_run_sampling_defaults_to_the_classic_scheduler(ref, classic):
    """Without ``batched`` both runtimes run the classic sampler: the same
    chain, the same gradient count (one evaluation more a draw than the
    batched block but the block's first)."""
    _assert_like_reference(classic, ref["classic"])
    assert classic[3].n_outer_trips["sampling"] > 0  # attempts
    assert sum(classic[3].n_syncs.values()) >= classic[3].n_outer_trips["sampling"]


@pytest.mark.parametrize("ours,theirs", [
    (wtt.walnuts, wt.walnuts),
    (runtime.run_warmup, jax_runtime.run_warmup),
    (runtime.run_sampling, jax_runtime.run_sampling),
    (batched.make_batched_sample_block, jax_batched.make_batched_sample_block),
    (batched.make_batched_warmup_block, jax_batched.make_batched_warmup_block),
    (transition.make_transition, jax_transition.make_transition),
    (transition.make_flat_sample_block, jax_transition.make_flat_sample_block),
    (sampler.make_warmup_step, jax_sampler.make_warmup_step),
    (sampler.make_sample_step, jax_sampler.make_sample_step),
], ids=lambda f: f.__module__.split(".")[0] + "." + f.__name__)
def test_every_reference_keyword_with_its_default(ours, theirs):
    mine = inspect.signature(ours).parameters
    for name, p in inspect.signature(theirs).parameters.items():
        assert name in mine, name
        assert repr(mine[name].default) == repr(p.default), name


# ---------------------------------------------------------------------------
# the batched scheduler's options (tests/test_batched.py)
# ---------------------------------------------------------------------------

def test_batched_block_is_the_classic_chain(ref, classic, batched_run):
    _assert_same(classic, batched_run)
    # the block caches every draw's start gradient but its first
    np.testing.assert_array_equal(classic[3].n_grads - batched_run[3].n_grads,
                                  DRAWS - 1)
    _assert_like_reference(batched_run, ref["classic"], n_grads=False)


@pytest.mark.parametrize("kw", [
    dict(min_latched=0), dict(min_latched=5), dict(min_latched=C),
    dict(min_latched=5, tier2_every=2),
    dict(defer_splits=False), dict(defer_splits=False, tier2_every=0),
    dict(pallas_replay=True), dict(fresh_cur=True),
    dict(fresh_cur=True, runahead=1, tier2_every=0),
    dict(bounded_sweeps=False), dict(bounded_sweeps=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_batched_option_is_scheduling_only(ref, batched_run, kw):
    """Every batched option but bf16_ends gives the default block's draws,
    log densities, end keys and gradient counts bit for bit, and so the
    JAX package's classic chain."""
    run = _run(ref, batched=True, **kw)
    _assert_same(run, batched_run)
    np.testing.assert_array_equal(run[3].n_grads, batched_run[3].n_grads)
    _assert_like_reference(run, ref["classic"], n_grads=False)


def test_min_latched_defers_passes(ref, batched_run):
    """A pass waits for C latched lanes: fewer passes, more trips, one read
    a trip still."""
    run = _run(ref, batched=True, min_latched=C, tier2_every=1)
    strict = _run(ref, batched=True, tier2_every=1)
    _assert_same(run, strict)
    assert run[3].n_outer_trips["sampling"] < strict[3].n_outer_trips["sampling"]


def test_per_trip_split_is_the_split():
    """defer_splits=False splits every ending lane's key in the trip by a
    one-round replay: the key and subkey of ``prng.split``."""
    key = prng.fold_in(prng.key(5), torch.arange(16))
    ku = prng.fold_in(prng.key(6), torch.arange(16))
    ends = torch.tensor([0, 1] * 8, dtype=torch.int32)
    latch = ends * torch.tensor([1, 1, 0, 0] * 4, dtype=torch.int32)
    k2, ku2 = prng.replay_split_chain(key, ku, ends, latch)
    ks = prng.split(key)
    assert torch.equal(k2, torch.where(ends[:, None] > 0, ks[:, 0], key))
    assert torch.equal(ku2, torch.where(latch[:, None] > 0, ks[:, 1], ku))


def test_fresh_cur_matches_reference_eager(ref):
    """fresh_cur against the JAX package's batched block with fresh_cur in
    eager mode (``jax.disable_jit()``, where it is bitwise its default), one
    draw (an eager JAX block is slow): keys exactly, draws to TOL."""
    lg = jax_logp_grad(jax_funnel(DIM)[0])
    ss, p = ref["ss"], ref["params"]
    # a shallow configuration: eager JAX dispatches every operation
    start, sample = jax_batched.make_batched_sample_block(
        lg, 3, 4, runahead=8, tier2_every=6, fresh_cur=True)
    with jax.disable_jit():
        jkeys = jax.random.wrap_key_data(jnp.asarray(ss.key))
        st = start(jkeys, jnp.asarray(ss.theta), jnp.asarray(ss.n_grads),
                   jax_transition.FailStats(*map(jnp.asarray, ss.fails)),
                   jnp.asarray(p.step_size), jnp.asarray(p.inv_mass),
                   jnp.asarray(p.min_micro))
        res = sample(st, jnp.asarray(p.step_size), jnp.asarray(p.inv_mass),
                     jnp.asarray(p.min_micro), jnp.asarray(0.5), 1)
    tp = convert.frozen_params(p)
    t_ss = convert.sample_state(ss)
    t_start, t_sample = batched.make_batched_sample_block(
        _lg(), 3, 4, runahead=8, tier2_every=6, fresh_cur=True)
    t_st = t_start(t_ss.key, t_ss.theta, t_ss.n_grads, t_ss.fails, tp.step_size,
                   tp.inv_mass, tp.min_micro)
    t_res = t_sample(t_st, tp.step_size, tp.inv_mass, tp.min_micro, 0.5, 1)
    np.testing.assert_array_equal(convert.key_data_numpy(t_res.key),
                                  np.asarray(jax.random.key_data(res.key)))
    np.testing.assert_array_equal(t_res.depths.numpy(), np.asarray(res.depths))
    np.testing.assert_allclose(t_res.draws.numpy(), np.asarray(res.draws), **TOL)
    np.testing.assert_array_equal(t_res.n_inner_trips, int(res.n_inner_trips))


# ---------------------------------------------------------------------------
# bf16_ends (tests/test_transition.py:96-116)
# ---------------------------------------------------------------------------

def test_bf16_rounding_is_jax_rounding():
    """round_bf16 is jnp.astype(bfloat16) and back, float64 and float32,
    on random values and on values next to a bfloat16 midpoint."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(100_000) * np.exp(rng.uniform(-20, 20, 100_000))
    mid = (np.arange(1, 2001, dtype=np.float64) * 2.0 ** -7 + 2.0 ** -8 + 1.0)
    x = np.concatenate([x, mid, np.nextafter(mid, 0), np.nextafter(mid, 2), -mid])
    for dt in (np.float64, np.float32):
        v = x.astype(dt)
        want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(dt))
        got = round_bf16(torch.from_numpy(v)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == dt


def test_bf16_classic_matches_reference(ref):
    run = _run(ref, bf16_ends=True)
    _assert_like_reference(run, ref["bf16"])
    # full-precision draws, not bfloat16-quantized
    d = run[1].numpy()
    assert d.dtype == np.float64
    assert not np.array_equal(d, d.astype(ml_dtypes.bfloat16).astype(np.float64))


def test_bf16_batched_is_the_classic_bf16_chain(ref):
    classic = _run(ref, bf16_ends=True)
    run = _run(ref, batched=True, bf16_ends=True)
    _assert_same(run, classic)
    _assert_like_reference(run, ref["bf16"], n_grads=False)
    bounded = _run(ref, batched=True, bf16_ends=True, bounded_sweeps=True)
    _assert_same(bounded, run)


def test_bf16_warmup_matches_reference(ref):
    wsb, winfo = ref["warm_bf16"]
    ws, _, _, info = runtime.run_warmup(_lg(), convert.warmup_state(ref["ws"]),
                                        TWarmupConfig(**_WCFG),
                                        TSamplingConfig(**_SCFG), bf16_ends=True)
    np.testing.assert_array_equal(convert.key_data_numpy(ws.key), wsb.key)
    np.testing.assert_array_equal(ws.n_grads.numpy(), wsb.n_grads)
    np.testing.assert_allclose(ws.theta.numpy(), wsb.theta, **TOL)
    np.testing.assert_allclose(ws.adam.log_step.numpy(), wsb.adam.log_step, rtol=1e-9)
    assert info.warmup_iters == winfo.warmup_iters == 4


# ---------------------------------------------------------------------------
# flatten and chain_groups (tests/test_runtime.py:146-263)
# ---------------------------------------------------------------------------

def test_flatten_matches_reference(ref, classic):
    """The flattened sampler: the reference's keys (the bank's, run ahead),
    gradient counts (the bank's start, no re-evaluation per transition)
    and Welford statistics; the classic path's draws bit for bit."""
    run = _run(ref, flatten=True)
    _assert_like_reference(run, ref["flat"])
    np.testing.assert_allclose(run[0].lp_mean.numpy(), ref["flat"][0].lp_mean, **TOL)
    np.testing.assert_allclose(run[0].lp_m2.numpy(), ref["flat"][0].lp_m2, rtol=1e-9)
    _assert_same(run, classic, keys=False)
    # DRAWS start evaluations saved, the bank's one paid, and the banked
    # run-ahead into the next transition counted
    assert np.all(run[3].n_grads - classic[3].n_grads >= 1 - DRAWS)


def test_flatten_across_blocks_and_with_an_integrator(ref):
    """Blocks of 3 (the bank carries over), and an attempt integrator whose
    value-and-gradient is also the model: the classic chain bit for bit."""
    vg = funnel_vg(DIM)[0]
    kw = dict(lg=vg, integrator=make_fused_integrator(vg),
              scfg=dict(min_iter=6, max_iter=6, block_size=2))
    flat = _run(ref, flatten=True, **dict(kw, scfg=dict(kw["scfg"])))
    classic = _run(ref, **kw)
    _assert_same(flat, classic, keys=False)
    assert flat[3].n_blocks["sampling"] == 3


@pytest.mark.parametrize("groups", [2, 3])
def test_chain_groups_is_the_ungrouped_chain(ref, classic, groups):
    run = _run(ref, chain_groups=groups)
    _assert_same(run, classic)
    np.testing.assert_array_equal(run[3].n_grads, classic[3].n_grads)
    assert torch.equal(run[0].lp_m2, classic[0].lp_m2)
    _assert_like_reference(run, ref["classic"])


def test_chain_groups_sort_is_numpy_argsort(ref):
    """The groups follow NumPy's argsort of the float64 adapted cost, as the
    reference's: the slowest chains share the last group."""
    p = ref["params"]
    cost = np.asarray(p.min_micro, np.float64) / np.asarray(p.step_size, np.float64)
    order = np.argsort(cost)
    seen = []
    real = runtime._tree_take

    def spy(tree, idx):
        seen.append(idx.cpu().numpy())
        return real(tree, idx)

    runtime._tree_take = spy
    try:
        _run(ref, chain_groups=2, scfg=dict(min_iter=1, max_iter=1, block_size=1))
    finally:
        runtime._tree_take = real
    np.testing.assert_array_equal(seen[0], order)


# ---------------------------------------------------------------------------
# device_draws, block_budget, unroll
# ---------------------------------------------------------------------------

def test_device_draws_places_the_same_draws(ref, batched_run):
    """device_draws=True writes the draws in place into the preallocated
    tensor (the state's theta is its last row); False (the default) copies
    each block to the host: the same values (on a card, the card test
    checks the placement)."""
    run = _run(ref, device_draws=True, batched=True)
    _assert_same(run, batched_run)
    assert run[0].theta.data_ptr() == run[1][-1].data_ptr()
    assert batched_run[0].theta.data_ptr() != batched_run[1][-1].data_ptr()
    assert not batched_run[1].is_pinned()  # pinned only beside a card


def test_block_budget_shrinks_on_an_over_budget_block():
    b = _BlockBudget(0.001, 50, "cpu")
    b.start()
    time.sleep(0.05)
    b.finish(50)
    assert 1 <= b.cap < 50


def test_block_budget_keeps_the_cap_under_budget():
    b = _BlockBudget(1000.0, 50, "cpu")
    for _ in range(2):
        b.start()
        b.finish(50)
    assert b.cap == 50


def test_block_budget_zero_is_off(monkeypatch):
    b = _BlockBudget(0.0, 50, "cpu")
    b.start()
    b.finish(50)
    assert b.cap == 50 and b._t0 is None
    monkeypatch.setenv("WALNUTS_BLOCK_BUDGET", "0")
    assert _BlockBudget(None, 50, "cpu").budget == 0.0
    monkeypatch.delenv("WALNUTS_BLOCK_BUDGET")
    assert _BlockBudget(None, 50, "cpu").budget == 45.0


def test_block_budget_takes_the_smaller_per_draw_wall():
    """A fast short block, then a slow long one: the per-draw estimate is
    the smaller of the two per-draw walls, not the smaller wall."""
    b = _BlockBudget(0.2, 50, "cpu")
    b.start()
    time.sleep(0.02)
    b.finish(2)
    b.start()
    time.sleep(0.1)
    b.finish(20)
    assert b.cap < 50


@pytest.mark.parametrize("batched_", [True, False])
def test_block_budget_caps_blocks_not_draws(ref, batched_):
    """A tiny budget caps every block after the first to one draw: more
    blocks, the same draws and end keys, the R-hat checks at the same
    iterations (tests/test_interrupt.py:255-310)."""
    kw = dict(batched=batched_, scfg=dict(min_iter=3, max_iter=6, block_size=3,
                                          rhat_converge_tol=1.0 + 1e-12))
    base = _run(ref, block_budget=0.0, **dict(kw, scfg=dict(kw["scfg"])))
    capped = _run(ref, block_budget=1e-9, **kw)
    _assert_same(base, capped)
    assert base[3].n_blocks["sampling"] == 2 and capped[3].n_blocks["sampling"] == 4
    assert len(base[3].rhat_trace) == len(capped[3].rhat_trace) == 2
    # the batched route merges each block's log-density statistics (Chan et
    # al.): another partition of the draws rounds the sums differently
    np.testing.assert_allclose(base[3].rhat_trace, capped[3].rhat_trace,
                               rtol=1e-12 if batched_ else 0)
    # a batched block pays one start gradient
    extra = 2 if batched_ else 0
    np.testing.assert_array_equal(capped[3].n_grads - base[3].n_grads, extra)


def test_warmup_block_budget_keeps_its_check_points(ref):
    lg, wcfg = _lg(), TWarmupConfig(min_iter=2, max_iter=4, block_size=2,
                                    mass_converge_tol=1e-12)
    runs = [runtime.run_warmup(lg, convert.warmup_state(ref["ws"]), wcfg,
                               TSamplingConfig(**_SCFG), block_budget=b)
            for b in (0.0, 1e-9)]
    assert torch.equal(runs[0][0].theta, runs[1][0].theta)
    assert runs[0][3].warmup_iters == runs[1][3].warmup_iters == 4
    assert runs[0][3].n_blocks["warmup"] == 2 < runs[1][3].n_blocks["warmup"]


def test_batched_warmup_block_budget_is_scheduling_only(ref):
    """walnuts()'s warmup route (batched) under a tiny budget: blocks capped
    to one iteration, the adapted state bit for bit, one counted start
    gradient for each extra block (tests/test_interrupt.py:196-240)."""
    lg, wcfg = _lg(), TWarmupConfig(min_iter=2, max_iter=4, block_size=2,
                                    mass_converge_tol=1e-12)
    runs = [runtime.run_warmup(lg, convert.warmup_state(ref["ws"]), wcfg,
                               TSamplingConfig(**_SCFG), batched=True,
                               block_budget=b)
            for b in (0.0, 1e-9)]
    (w0, _, _, i0), (w1, _, _, i1) = runs
    assert torch.equal(w0.theta, w1.theta)
    assert torch.equal(w0.key, w1.key)
    assert torch.equal(w0.adam.log_step, w1.adam.log_step)
    assert torch.equal(freeze_params(w0).inv_mass, freeze_params(w1).inv_mass)
    assert i0.warmup_iters == i1.warmup_iters == 4
    extra = i1.n_blocks["warmup"] - i0.n_blocks["warmup"]
    assert i0.n_blocks["warmup"] == 2 and extra > 0
    np.testing.assert_array_equal((w1.n_grads - w0.n_grads).numpy(), extra)


def test_unroll_changes_nothing(ref, classic):
    _assert_same(_run(ref, unroll=3), classic)
    ws = [runtime.run_warmup(_lg(), convert.warmup_state(ref["ws"]),
                             TWarmupConfig(**_WCFG), TSamplingConfig(**_SCFG),
                             unroll=u)[0] for u in (0, 4)]
    assert torch.equal(ws[0].theta, ws[1].theta)


# ---------------------------------------------------------------------------
# the refusals, with the reference's wording
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(flatten=True, chain_groups=2), "flatten is incompatible with chain_groups"),
    (dict(batched=True, flatten=True), "batched is incompatible with flatten/chain_groups"),
    (dict(batched=True, chain_groups=2), "batched is incompatible with flatten/chain_groups"),
    (dict(checkpoint=object(), flatten=True),
     "checkpoint is incompatible with flatten/chain_groups"),
    (dict(checkpoint=object(), chain_groups=3),
     "checkpoint is incompatible with flatten/chain_groups"),
    (dict(chain_groups=4), r"num_chains \(6\) must divide by chain_groups \(4\)"),
    (dict(batched=True, pallas_pass=True, bf16_ends=True), "pallas_pass=True covers"),
    (dict(batched=True, pallas_pass=True, fresh_cur=True), "pallas_pass=True covers"),
    (dict(batched=True, pallas_pass=True, pallas_replay=True), "pallas_pass=True covers"),
    (dict(batched=True, pallas_pass=True, defer_splits=False), "pallas_pass=True covers"),
], ids=lambda x: x if isinstance(x, str) else ",".join(x))
def test_refusals(ref, kw, match):
    with pytest.raises(ValueError, match=match):
        _run(ref, **kw)
    if "checkpoint" not in kw:  # the JAX package refuses the same
        jkw = dict(kw)
        with pytest.raises(ValueError):
            jax_runtime.run_sampling(
                jax_logp_grad(jax_funnel(DIM)[0]),
                jax.tree.map(jnp.asarray, ref["ss"])._replace(
                    key=jax.random.wrap_key_data(jnp.asarray(ref["ss"].key))),
                jax.tree.map(jnp.asarray, ref["params"]), SamplingConfig(**_SCFG), **jkw)


@pytest.mark.parametrize("kw", [dict(adapt_full=True), dict(adapt_step_size=True)])
def test_fused_pass_refuses_warmup_options(kw):
    with pytest.raises(ValueError, match="pallas_pass=True covers"):
        batched.make_batched_sample_block(_lg(), 5, 6, pallas_pass=True, **kw)


def test_chain_groups_refuses_a_mesh():
    shard = runtime.ChainSharding(rank=0, size=2, device=torch.device("cpu"), group=None)
    with pytest.raises(ValueError, match="chain_groups requires mesh=None"):
        runtime._refuse_chain_groups(shard, 2, 8)


@pytest.mark.parametrize("kw,match", [
    (dict(batched=True, flatten=True), "batched is incompatible"),
    (dict(chain_groups=2, checkpoint_dir="unused"), "checkpoint is incompatible"),
    (dict(num_chains=5, chain_groups=2), "must divide by chain_groups"),
])
def test_walnuts_refuses_before_any_work(kw, match):
    kw = {"num_chains": 4, **kw}
    with pytest.raises(ValueError, match=match):
        wtt.walnuts(funnel(3)[0], num_params=3, device="cpu", **kw)


def test_walnuts_options_end_to_end():
    """walnuts() with the batched options gives its default run's draws;
    with flatten or chain_groups (the classic path) those same draws."""
    kw = dict(num_params=3, num_chains=4, seed=5, device="cpu", dtype=torch.float64,
              min_warmup_iter=3, max_warmup_iter=3, min_sampling_iter=3,
              max_sampling_iter=3, block_size=3)
    base = np.stack([np.asarray(c) for c in wtt.walnuts(funnel(3)[0], **kw)])
    opts = np.stack([np.asarray(c) for c in wtt.walnuts(
        funnel(3)[0], min_latched=2, defer_splits=False, **kw)])
    np.testing.assert_array_equal(opts, base)
    classic = np.stack([np.asarray(c) for c in wtt.walnuts(funnel(3)[0], batched=False,
                                                           **kw)])
    for extra in (dict(flatten=True), dict(chain_groups=2)):
        got = np.stack([np.asarray(c) for c in wtt.walnuts(funnel(3)[0], **extra, **kw)])
        np.testing.assert_array_equal(got, classic)
