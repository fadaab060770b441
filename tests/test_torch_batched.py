"""The port's batched scheduler against the JAX reference (CPU, float64).

Funnel(11), 16 chains, the fixture of ``tests/test_batched.py``: the
reference's asynchronous adaptive warmup block and its sampling block
(``pallas_replay=True``, run-ahead 8, tier-2 every 6 trips) run on the
same state as the port's, converted with ``walnuts_tpu_torch.convert``.

Integers must match exactly: keys, depths, gradient counts, failure
counters and the trip counters (the reference counts the same batched
trips and tier-2 passes). Floats differ only by summation order and the
last bits of ``exp``/``log`` between XLA and PyTorch (and the normals'
ulps, see test_torch_prng.py), so draws and log densities are held to
rtol 1e-10 over the 20-draw block, and warmup's adapted floats to rtol
1e-9 (the reference's own warmup rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu.config import SamplingConfig, WarmupConfig
from walnuts_tpu.core.adapt import nutpie_init_mass
from walnuts_tpu.core.batched import make_batched_sample_block as jax_sample_block
from walnuts_tpu.core.batched import make_batched_warmup_block as jax_warmup_block
from walnuts_tpu.core.sampler import freeze_params, init_sample_state, init_warmup_state
from walnuts_tpu.models import funnel as jax_funnel
from walnuts_tpu.ops.math import make_logp_grad as jax_logp_grad
from walnuts_tpu_torch import convert
from walnuts_tpu_torch.core import batched
from walnuts_tpu_torch.core.sampler import freeze_params as t_freeze
from walnuts_tpu_torch.models import funnel
from walnuts_tpu_torch.ops.math import make_logp_grad

C = 16
DRAWS = 20
WARMUP_BLOCK = 12


def _np_tree(tree):
    """A reference state as NumPy, typed keys as uint32 key data."""
    return jax.tree.map(
        lambda x: np.asarray(jax.random.key_data(x))
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else np.asarray(x),
        tree)


@pytest.fixture(scope="module")
def ref():
    """Reference warmup (two asynchronous blocks) and one sampling block."""
    logp, dim = jax_funnel(11)
    lg = jax_logp_grad(logp)
    wcfg = WarmupConfig(min_iter=2 * WARMUP_BLOCK, max_iter=2 * WARMUP_BLOCK,
                        block_size=WARMUP_BLOCK)
    scfg = SamplingConfig(min_iter=DRAWS, max_iter=DRAWS, block_size=DRAWS,
                          max_step_halvings=8)
    base = jax.random.key(7)
    keys = jax.vmap(lambda c: jax.random.fold_in(base, c))(jnp.arange(C))
    theta0 = 2.0 * jax.random.normal(jax.random.fold_in(base, 99), (C, dim))
    grads = jax.vmap(lambda t: lg(t)[1])(theta0)
    im0 = jax.vmap(lambda g: nutpie_init_mass(g, jnp.asarray(1e-5)))(grads)
    step0 = jnp.full((C,), 0.5)
    ws0 = jax.vmap(lambda k, t, m, s: init_warmup_state(k, t, m, s, wcfg, scfg))(
        keys, theta0, im0, step0)

    wblock = jax_warmup_block(lg, scfg, pallas_replay=True, runahead=4,
                              tier2_every=12)
    wjit = jax.jit(wblock, static_argnums=1)
    ws1, out1 = wjit(ws0, WARMUP_BLOCK)
    ws2, _ = wjit(ws1, WARMUP_BLOCK)

    start, sample = jax_sample_block(lg, scfg.max_trajectory_doublings,
                                     scfg.max_step_halvings, runahead=8,
                                     tier2_every=6, pallas_replay=True)
    params = jax.vmap(freeze_params)(ws2)
    ss = jax.vmap(init_sample_state)(ws2)

    @jax.jit
    def blk(ss):
        st = start(ss.key, ss.theta, ss.n_grads, ss.fails, params.step_size,
                   params.inv_mass, params.min_micro)
        return sample(st, params.step_size, params.inv_mass, params.min_micro,
                      jnp.asarray(scfg.max_hamiltonian_error), DRAWS)

    res = blk(ss)
    return dict(scfg=scfg, ws0=_np_tree(ws0), ws1=_np_tree(ws1),
                warm_draws=np.asarray(out1[0]), warm_logps=np.asarray(out1[1]),
                ws2=_np_tree(ws2), ss=_np_tree(ss), res=_np_tree(res))


def _port_lg():
    return make_logp_grad(funnel(11)[0])


def _assert_warmup_state(t, j):
    np.testing.assert_array_equal(convert.key_data_numpy(t.key), j.key)
    for name in ("iteration", "n_grads"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name))
    for a, b in zip(t.fails, j.fails):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(t.min_micro.total_macro_steps.numpy(),
                                  j.min_micro.total_macro_steps)
    np.testing.assert_allclose(t.theta.numpy(), j.theta, rtol=1e-9)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(t.adam)), jax.tree.leaves(j.adam)):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(t.mass)), jax.tree.leaves(j.mass)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


def test_warmup_block_matches_reference(ref):
    wblock = batched.make_batched_warmup_block(_port_lg(), ref["scfg"], runahead=4,
                                               tier2_every=12)
    ws = convert.warmup_state(ref["ws0"])
    ws, res = wblock(ws, WARMUP_BLOCK)
    _assert_warmup_state(ws, ref["ws1"])
    np.testing.assert_allclose(res.draws.numpy(), ref["warm_draws"], rtol=1e-9)
    np.testing.assert_allclose(res.logps.numpy(), ref["warm_logps"], rtol=1e-9)
    ws, _ = wblock(ws, WARMUP_BLOCK)
    _assert_warmup_state(ws, ref["ws2"])


def _port_sample(ss_np, ws_np, scfg, B, K, num_draws=DRAWS, out=None):
    ws = convert.warmup_state(ws_np)
    params = t_freeze(ws)
    ss = convert.sample_state(ss_np)
    start, sample = batched.make_batched_sample_block(
        _port_lg(), scfg.max_trajectory_doublings, scfg.max_step_halvings,
        runahead=B, tier2_every=K)
    st = start(ss.key, ss.theta, ss.n_grads, ss.fails, params.step_size,
               params.inv_mass, params.min_micro)
    return sample(st, params.step_size, params.inv_mass, params.min_micro,
                  scfg.max_hamiltonian_error, num_draws, out=out)


@pytest.fixture(scope="module")
def port(ref):
    return _port_sample(ref["ss"], ref["ws2"], ref["scfg"], 8, 6)


def test_sample_block_matches_reference(ref, port):
    j, res = ref["res"], port
    np.testing.assert_array_equal(convert.key_data_numpy(res.key), j.key)
    np.testing.assert_array_equal(res.depths.numpy(), j.depths)
    np.testing.assert_array_equal(res.n_grads_delta.numpy(), j.n_grads_delta)
    for a, b in zip(res.fails_delta, j.fails_delta):
        np.testing.assert_array_equal(a.numpy(), b)
    assert res.n_inner_trips == int(j.n_inner_trips)
    assert res.n_outer_trips == int(j.n_outer_trips)
    np.testing.assert_allclose(res.draws.numpy(), j.draws, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(res.logps.numpy(), j.logps, rtol=1e-10)
    # one host read per trip, per tier-2 pass and per draw's final check,
    # plus one per trip loop that ended on "no runnable lane"
    low = res.n_inner_trips + res.n_outer_trips + DRAWS
    assert low <= res.n_syncs <= low + res.n_outer_trips


SHORT = 10  # draws of the scheduling checks (a prefix of the block's)


@pytest.mark.parametrize("B,K", [(1, 0), (4, 12)])
def test_scheduling_leaves_the_chain_unchanged(ref, port, B, K):
    """Run-ahead depth and tier-2 cadence only schedule: the draws,
    log densities and depths equal the (8, 6) block's bitwise (a shorter
    block emits a prefix of the same chain)."""
    b = _port_sample(ref["ss"], ref["ws2"], ref["scfg"], B, K, SHORT)
    np.testing.assert_array_equal(b.draws.numpy(), port.draws[:SHORT].numpy())
    np.testing.assert_array_equal(b.logps.numpy(), port.logps[:SHORT].numpy())
    np.testing.assert_array_equal(b.depths.numpy(), port.depths[:SHORT].numpy())


def test_sample_block_writes_into_given_output(ref, port):
    """Banking writes each draw in place into the caller's tensors (a
    run's preallocated draw tensor), and nothing outside them."""
    cube = torch.full((SHORT + 4, C, 11), float("nan"), dtype=torch.float64)
    lps = torch.full((SHORT + 4, C), float("nan"), dtype=torch.float64)
    res = _port_sample(ref["ss"], ref["ws2"], ref["scfg"], 8, 6, SHORT,
                       out=(cube[2:2 + SHORT], lps[2:2 + SHORT]))
    np.testing.assert_array_equal(cube[2:2 + SHORT].numpy(),
                                  port.draws[:SHORT].numpy())
    np.testing.assert_array_equal(lps[2:2 + SHORT].numpy(),
                                  port.logps[:SHORT].numpy())
    assert torch.isnan(cube[:2]).all() and torch.isnan(cube[2 + SHORT:]).all()
    assert res.draws.data_ptr() == cube[2].data_ptr()
