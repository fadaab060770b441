"""The port's classic per-draw path against the JAX reference (CPU, float64).

The same inputs, made from a seed, go through the reference's vmapped
classic transition, warmup and sampling and through the port's
chain-batched ones, with the plain inner loop and with an attempt
integrator (the reference's Pallas kernel in interpret mode, as
``tests/test_integrator.py`` runs it; the port's fused integrator, which
takes its plain version on CPU tensors).

Integers must match exactly: keys, depths, gradient counts and failure
counters. Floats differ by summation order and the last bits of
``exp``/``log`` between XLA and PyTorch (and the normals' ulps, see
test_torch_prng.py): one transition is held to rtol 1e-10, 20 + 60
iterations of warmup and sampling to rtol 1e-9 (draws, adapted step sizes
and inverse masses).

The port's classic sampler against its batched scheduler from one warmed
state: the reference documents bitwise-equal draws; the port's differed by
0.0 when this was written and are held to rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu_torch as wtt
from walnuts_tpu.config import SamplingConfig, WarmupConfig
from walnuts_tpu.core import sampler as jax_sampler
from walnuts_tpu.core.adapt import adam_init as jax_adam_init
from walnuts_tpu.core.transition import make_transition as jax_make_transition
from walnuts_tpu.models import funnel as jax_funnel
from walnuts_tpu.models import std_normal as jax_std_normal
from walnuts_tpu.models.kernels import funnel_vg as jax_funnel_vg
from walnuts_tpu.models.kernels import std_normal_vg as jax_std_normal_vg
from walnuts_tpu.ops.integrator import make_pallas_integrator
from walnuts_tpu.ops.math import make_logp_grad as jax_logp_grad
from walnuts_tpu.parallel import runtime as jax_runtime
from walnuts_tpu_torch import convert
from walnuts_tpu_torch.core import sampler
from walnuts_tpu_torch.core.adapt import adam_init
from walnuts_tpu_torch.core.transition import make_transition
from walnuts_tpu_torch.models import funnel, std_normal
from walnuts_tpu_torch.models.kernels import funnel_vg, std_normal_vg
from walnuts_tpu_torch.ops.integrator import make_fused_integrator
from walnuts_tpu_torch.ops.math import make_logp_grad
from walnuts_tpu_torch.parallel import runtime

ROUTES = ("plain", "integrator")


def _np_tree(tree):
    """A reference state as NumPy, typed keys as uint32 key data."""
    return jax.tree.map(
        lambda x: np.asarray(jax.random.key_data(x))
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else np.asarray(x),
        tree)


def _keys(seed, n):
    return jax.random.split(jax.random.key(seed), n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("route,adapt", [
    ("plain", False), ("integrator", False), ("integrator", True)],
    ids=("plain-frozen", "integrator-frozen", "integrator-adapting"))
def test_transition_matches_reference(route, adapt):
    """Funnel(8) x 12 chains, max_depth 4, max_step_halvings 4."""
    C, dim = 12, 8
    rng = np.random.default_rng(6)
    theta0 = 0.2 * rng.standard_normal((C, dim))
    keys = _keys(5, C)

    lg = jax_logp_grad(jax_funnel(dim)[0])
    ref_integ = (make_pallas_integrator(jax_funnel_vg(dim)[0], block_b=8,
                                        interpret=True)
                 if route == "integrator" else None)
    tr = jax_make_transition(lg, 4, 4, adapt_step_size=adapt, integrator=ref_integ)
    args = (jnp.float64(0.4), jnp.ones(dim), jnp.int32(2), jnp.float64(0.5),
            jax_adam_init(0.4, dtype=jnp.float64))
    want = _np_tree(jax.vmap(lambda k, t: tr(k, t, *args))(keys, jnp.asarray(theta0)))

    port_integ = (make_fused_integrator(funnel_vg(dim))
                  if route == "integrator" else None)
    tr_p = make_transition(make_logp_grad(funnel(dim)[0]), 4, 4,
                           adapt_step_size=adapt, integrator=port_integ)
    got = tr_p(convert.key_data_torch(np.asarray(jax.random.key_data(keys))),
               _t(theta0), torch.full((C,), 0.4, dtype=torch.float64),
               torch.ones((C, dim), dtype=torch.float64),
               torch.full((C,), 2, dtype=torch.int32), 0.5,
               adam_init(torch.full((C,), 0.4, dtype=torch.float64)))
    assert got.counts.n_outer_trips > 0
    assert got.counts.n_syncs >= got.counts.n_outer_trips
    got = convert.to_numpy(got)

    np.testing.assert_array_equal(convert.key_data_numpy(_t(got.key)), want.key)
    np.testing.assert_array_equal(got.depth, want.depth)
    np.testing.assert_array_equal(got.n_grads, want.n_grads)
    for a, b in zip(got.fails, want.fails):
        np.testing.assert_array_equal(a, b)
    assert len(set(want.depth.tolist())) > 1  # the lanes do differ
    np.testing.assert_allclose(got.theta, want.theta, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.grad, want.grad, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.logp, want.logp, rtol=1e-10)
    np.testing.assert_allclose(got.adam.log_step, want.adam.log_step, rtol=1e-10)
    if adapt:
        assert np.all(want.adam.t > 0)


def _std_normal_setup():
    C, dim = 8, 3
    wcfg = WarmupConfig(min_iter=20, max_iter=20, block_size=20)
    scfg = SamplingConfig(min_iter=30, max_iter=30, block_size=30,
                          max_trajectory_doublings=4, max_step_halvings=4)
    rng = np.random.default_rng(8)
    theta0 = rng.standard_normal((C, dim))
    ws = jax.vmap(lambda k, t, m, s: jax_sampler.init_warmup_state(
        k, t, m, s, wcfg, scfg))(
        _keys(7, C), jnp.asarray(theta0), jnp.ones((C, dim)), jnp.full((C,), 0.5))
    return C, dim, wcfg, scfg, ws


@pytest.mark.parametrize("route", ROUTES)
def test_warmup_and_sampling_match_reference(route):
    """Std normal(3) x 8 chains, 20 warmup + 30 sampling iterations."""
    C, dim, wcfg, scfg, ws0 = _std_normal_setup()
    ws0_np = _np_tree(ws0)  # before the reference run donates its buffers

    lg = jax_logp_grad(jax_std_normal(dim)[0])
    ref_integ = (make_pallas_integrator(jax_std_normal_vg(dim)[0], block_b=8,
                                        interpret=True)
                 if route == "integrator" else None)
    ws, _, _, info = jax_runtime.run_warmup(lg, ws0, wcfg, scfg,
                                            integrator=ref_integ, batched=False)
    params = jax.vmap(jax_sampler.freeze_params)(ws)
    params_np = _np_tree(params)
    ss = jax.vmap(jax_sampler.init_sample_state)(ws)
    ss, draws, logps, info = jax_runtime.run_sampling(
        lg, ss, params, scfg, info=info, integrator=ref_integ, batched=False)
    ss_np = _np_tree(ss)

    port_integ = (make_fused_integrator(std_normal_vg(dim))
                  if route == "integrator" else None)
    lg_p = make_logp_grad(std_normal(dim)[0])
    kw = dict(batched=False, integrator=port_integ)
    ws_p, _, _, info_p = runtime.run_warmup(
        lg_p, convert.warmup_state(ws0_np), wcfg, scfg, **kw)
    params_p = sampler.freeze_params(ws_p)
    ss_p, draws_p, logps_p, info_p = runtime.run_sampling(
        lg_p, sampler.init_sample_state(ws_p), params_p, scfg, info=info_p, **kw)

    np.testing.assert_array_equal(params_p.min_micro.numpy(), params_np.min_micro)
    np.testing.assert_allclose(params_p.step_size.numpy(), params_np.step_size,
                               rtol=1e-9)
    np.testing.assert_allclose(params_p.inv_mass.numpy(), params_np.inv_mass,
                               rtol=1e-9)
    np.testing.assert_array_equal(convert.key_data_numpy(ss_p.key), ss_np.key)
    np.testing.assert_array_equal(info_p.n_grads, info.n_grads)
    for name in ("n_halve_fail", "n_nonfinite", "n_depth_exhausted"):
        np.testing.assert_array_equal(getattr(info_p, name), getattr(info, name))
    assert (info_p.warmup_iters, info_p.sampling_iters) == (20, 30)
    np.testing.assert_allclose(draws_p.numpy(), np.asarray(draws), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(logps_p.numpy(), np.asarray(logps), rtol=1e-9,
                               atol=1e-12)
    for name in ("lp_count", "lp_mean", "lp_m2"):
        np.testing.assert_allclose(getattr(ss_p, name).numpy(),
                                   getattr(ss_np, name), rtol=1e-8)
    assert info_p.n_outer_trips["sampling"] > 0 and info_p.n_blocks["sampling"] == 1
    if route == "integrator":  # one integrator call per attempt
        assert info_p.n_inner_trips == info_p.n_outer_trips


def test_classic_sampling_equals_batched_sampling():
    """One warmed state, sampled by the classic path and by the batched
    scheduler: the same draws per lane, one more gradient per draw."""
    C, dim, wcfg, scfg, ws0 = _std_normal_setup()
    lg = make_logp_grad(std_normal(dim)[0])
    ws, _, _, _ = runtime.run_warmup(lg, convert.warmup_state(_np_tree(ws0)),
                                     wcfg, scfg, batched=False)
    params, ss = sampler.freeze_params(ws), sampler.init_sample_state(ws)
    scfg = SamplingConfig(min_iter=30, max_iter=30, block_size=30,
                          max_trajectory_doublings=4, max_step_halvings=4)
    s_c, d_c, lp_c, i_c = runtime.run_sampling(lg, ss, params, scfg, batched=False)
    s_b, d_b, lp_b, i_b = runtime.run_sampling(lg, ss, params, scfg, batched=True)
    assert torch.equal(s_c.key, s_b.key)
    np.testing.assert_allclose(d_c.numpy(), d_b.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_allclose(lp_c.numpy(), lp_b.numpy(), rtol=1e-12, atol=0)
    # the batched block caches the start gradient of every draw but the first
    np.testing.assert_array_equal(i_c.n_grads - i_b.n_grads, 30 - 1)
    np.testing.assert_allclose(s_c.lp_mean.numpy(), s_b.lp_mean.numpy(), rtol=1e-10)


_WALNUTS = dict(num_params=4, num_chains=4, seed=11, device="cpu",
                dtype=torch.float64, min_warmup_iter=8, max_warmup_iter=8,
                min_sampling_iter=8, max_sampling_iter=8, block_size=8,
                adapt_init_step=False, step_size_init=0.3, return_info=True)


def test_walnuts_batched_with_integrator_raises():
    integ = make_fused_integrator(funnel_vg(4))
    with pytest.raises(ValueError, match="integrator"):
        wtt.walnuts(funnel(4)[0], batched=True, integrator=integ, **_WALNUTS)


def test_walnuts_integrator_alone_runs_the_classic_path():
    integ = make_fused_integrator(funnel_vg(4))
    out_i, info_i = wtt.walnuts(funnel(4)[0], integrator=integ, **_WALNUTS)
    out_c, info_c = wtt.walnuts(funnel(4)[0], batched=False, **_WALNUTS)
    # classic: one integrator call per attempt, none on the plain route
    assert info_i.n_inner_trips == info_i.n_outer_trips
    assert info_c.n_inner_trips["sampling"] > info_c.n_outer_trips["sampling"]
    np.testing.assert_array_equal(info_i.n_grads, info_c.n_grads)
    np.testing.assert_allclose(np.asarray(out_i), np.asarray(out_c), rtol=1e-9)
    assert np.asarray(out_i).shape == (4, 8, 4)
    assert np.isfinite(np.asarray(out_i)).all()
