"""The port's whole-transition entry points against the JAX kernels (CPU).

``make_fused_transition`` and ``make_fused_sample_block`` of the port (the
plain PyTorch versions, which CPU tensors take) against the reference's
Pallas kernels in interpret mode with ``block_b=32``, as
``tests/test_fused_transition.py`` runs them. Float32, inputs made from a
seed with NumPy, the same arrays on both sides.

The decision uniforms are a counter hash of (seed, chain, counter) and must
be bitwise equal. A chain's result depends on nothing else but its own
operands, so the two sides are compared chain by chain: ``depth`` and
``n_grads`` equal on at least 0.97 of the chains, and on those chains
theta, grad and logp within rtol 1e-4 / atol 1e-5. The rest is float
rounding: XLA fuses the kernel's elementwise arithmetic (and may contract
a product and a sum) where PyTorch rounds each operation, and ``exp`` /
``log`` differ in their last bits, so a chain whose energy error sits at
``max_error``, or whose ``log(u)`` sits at a log weight ratio, can take
another branch. When this was written every case agreed on every chain.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu.models import kernels as jax_kernels
from walnuts_tpu.ops import fused_transition as jax_ft
from walnuts_tpu_torch.models import kernels
from walnuts_tpu_torch.ops import fused_transition as ft

MAX_ERROR = 0.5
TOL = dict(rtol=1e-4, atol=1e-5)
MIN_SHARE = 0.97


def _jax_draw_uniform(seed, lane, ctr):
    """The kernels' ``draw_uniform`` (fused_transition.py:470-476) from the
    reference's own hash and bit conversion."""
    seed_mix = jax_ft._hash32(jnp.asarray(seed, jnp.int32).astype(jnp.uint32)
                              ^ jnp.uint32(0x9E3779B9))
    bits = jax_ft._hash32(seed_mix ^ jax_ft._hash32(jnp.asarray(lane, jnp.uint32))
                          ^ (jnp.asarray(ctr, jnp.uint32) * jnp.uint32(0x27D4EB2F)))
    return jax_ft._uniform_from_bits(bits)


_EDGES = np.array([0, 1, 2, 255, 256, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                   0xFFFFFFFF], dtype=np.uint32)


def test_hash32_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([_EDGES, rng.integers(0, 2**32, 5000, dtype=np.uint64)
                        .astype(np.uint32)])
    want = np.asarray(jax_ft._hash32(jnp.asarray(x)))
    got = ft.hash32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    # int32 bit patterns and plain ints are read as uint32 too
    got32 = ft.hash32(torch.from_numpy(x.view(np.int32).copy())).numpy()
    np.testing.assert_array_equal(got32, got)
    assert ft.hash32(int(x[7])) == int(want[7])


def test_uniform_from_bits_bitwise():
    rng = np.random.default_rng(1)
    bits = np.concatenate([_EDGES, rng.integers(0, 2**32, 5000, dtype=np.uint64)
                           .astype(np.uint32)])
    want = np.asarray(jax_ft._uniform_from_bits(jnp.asarray(bits)))
    got = ft.uniform_from_bits(torch.from_numpy(bits.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() > 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("seed", [0, 17, 2**31 - 1, -1, -(2**31)])
def test_draw_uniform_bitwise(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    lane = np.concatenate([np.arange(64), rng.integers(0, 2**32, 2000, dtype=np.uint64)]
                          ).astype(np.uint32)
    ctr = np.concatenate([_EDGES, rng.integers(0, 2**32, len(lane) - len(_EDGES),
                                               dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(_jax_draw_uniform(seed, lane, ctr))
    got = ft.draw_uniform(seed, torch.from_numpy(lane.astype(np.int64)),
                          torch.from_numpy(ctr.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # one lane, one counter, as ints
    one = ft.draw_uniform(seed, int(lane[70]), int(ctr[70]))
    assert one.numpy().view(np.uint32) == want[70].view(np.uint32)


def _models(name, dim):
    """The same model on both sides: ((jax vg, consts), port model)."""
    if name == "logistic_regression":
        jvg, _, jc = jax_kernels.logistic_regression_vg(60, dim, seed=5)
        return (jvg, jc), kernels.logistic_regression_vg(60, dim, seed=5,
                                                         device="cpu")
    if name == "ill_conditioned_normal":
        jvg, _, jc = jax_kernels.ill_conditioned_normal_vg(dim)
        return (jvg, jc), kernels.ill_conditioned_normal_vg(dim, device="cpu")
    jvg, _, jc = getattr(jax_kernels, name + "_vg")(dim)
    return (jvg, jc), getattr(kernels, name + "_vg")(dim)


# model, D, chains, max_depth, max_step_halvings, transitions, input scales
CASES = {
    "std_normal": ("std_normal", 4, 64, 6, 6, 4,
                   dict(step_range=(0.5, 0.5), max_min_micro=1, unit_mass=True)),
    "halving_reversibility": ("std_normal", 3, 64, 6, 6, 4,
                              dict(step_range=(2.5, 2.5), max_min_micro=1,
                                   unit_mass=True)),
    "min_micro_4": ("std_normal", 3, 64, 5, 5, 4,
                    dict(step_range=(0.25, 0.25), min_micro=4, unit_mass=True)),
    "ill_conditioned_mass_and_steps": (
        "ill_conditioned_normal", 6, 64, 5, 6, 4,
        dict(step_range=(0.5, 1.6), max_min_micro=2, theta_scale=2.0,
             true_mass=True)),
    "funnel": ("funnel", 5, 64, 5, 6, 4,
               dict(step_range=(0.1, 0.5), max_min_micro=2, theta_scale=0.7)),
    "logistic_regression": ("logistic_regression", 5, 64, 5, 6, 5,
                            dict(step_range=(0.1, 0.4), max_min_micro=2,
                                 theta_scale=0.3, inv_mass_scale=0.5)),
    "padding": ("std_normal", 4, 45, 5, 5, 4,
                dict(step_range=(0.3, 1.5), max_min_micro=2)),
}


def _inputs(chains, dim, seed, num_draws, scales):
    """Float32 / int32 NumPy operands for both sides."""
    scales = dict(scales)
    unit_mass = scales.pop("unit_mass", False)
    true_mass = scales.pop("true_mass", False)
    min_micro = scales.pop("min_micro", None)
    inp = ft.synthetic_transition_inputs(chains, dim, seed, num_draws=num_draws,
                                         **scales)
    if unit_mass or true_mass:
        z = inp["rho"] * np.sqrt(inp["inv_mass"])
        inp["inv_mass"] = np.broadcast_to(
            np.arange(1.0, dim + 1.0) ** 2 if true_mass else np.ones(dim),
            (chains, dim)).copy()
        inp["rho"] = z / np.sqrt(inp["inv_mass"])
    if min_micro is not None:
        inp["min_micro"] = np.full(chains, min_micro, np.int32)
    return {k: np.ascontiguousarray(v, dtype=np.int32 if k == "min_micro"
                                    else np.float32) for k, v in inp.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


# the chain axis of each output
_CHAIN_AXIS = dict(theta=0, grad=0, logp=0, draws=1, logps=1)


def _compare(got, want, what):
    """Hold the outputs (dicts of NumPy arrays by name) together chain by
    chain; returns the share of chains whose integers agree."""
    same = np.ones(got["n_grads"].shape, dtype=bool)
    for k in ("depth", "n_grads"):
        if k in got:
            same &= got[k] == want[k]
    share = float(same.mean())
    assert share >= MIN_SHARE, f"{what}: integers agree on {share:.4f} of the chains"
    for k, axis in _CHAIN_AXIS.items():
        if k in got:
            np.testing.assert_allclose(np.compress(same, got[k], axis=axis),
                                       np.compress(same, want[k], axis=axis),
                                       err_msg=f"{what}: {k}", **TOL)
    return share


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_transition_matches_reference(case):
    name, dim, chains, md, mh, iters, scales = CASES[case]
    (jvg, jconsts), model = _models(name, dim)
    vg = model[0]
    ref = jax_ft.make_fused_transition(jvg, dim, max_depth=md, max_step_halvings=mh,
                                       block_b=32, interpret=True, consts=jconsts)
    port = ft.make_fused_transition(model, dim, md, mh)
    inp = _inputs(chains, dim, 100 + len(case), iters, scales)
    theta = inp["theta"]
    depths, grads, shares = [], [], []
    for i in range(iters):
        seed = 7 * i - 3  # negative seeds too
        lp0, g0 = (x.numpy() for x in vg(_t(theta)))
        rho = inp["rho"][i]
        w = ref(seed, *(jnp.asarray(a) for a in (theta, rho, lp0, g0, inp["step"],
                                                 inp["inv_mass"], inp["min_micro"])),
                MAX_ERROR)
        g = port(seed, *(_t(a) for a in (theta, rho, lp0, g0, inp["step"],
                                         inp["inv_mass"], inp["min_micro"])),
                 MAX_ERROR)
        keys = ("theta", "grad", "logp", "depth", "n_grads")
        want = dict(zip(keys, (np.asarray(x) for x in w)))
        got = dict(zip(keys, (x.numpy() for x in g)))
        assert got["depth"].dtype == got["n_grads"].dtype == np.int32
        shares.append(_compare(got, want, f"{case}, transition {i}"))
        depths.append(want["depth"])
        grads.append(want["n_grads"])
        theta = want["theta"]  # both sides go on from the reference's point
    depths, grads = np.concatenate(depths), np.concatenate(grads)
    print(f"{case}: agreeing chains {min(shares):.4f}..{max(shares):.4f}, depth "
          f"{depths.min()}..{depths.max()}, n_grads {grads.min()}..{grads.max()}")
    assert len(set(depths.tolist())) > 1  # the chains do differ
    assert port.launches == 0  # CPU tensors take the plain version
    if case == "halving_reversibility":
        assert grads.mean() > 3.0  # halvings burn extra gradients
    if case == "min_micro_4":
        assert grads.min() >= 5


BLOCK_CASES = {
    "std_normal": ("std_normal", 4, 64, 5, 5,
                   dict(step_range=(0.4, 0.9), max_min_micro=2)),
    "logistic_regression": ("logistic_regression", 5, 40, 5, 6,
                            dict(step_range=(0.1, 0.4), max_min_micro=2,
                                 theta_scale=0.3, inv_mass_scale=0.5)),
}
N_DRAWS = 12


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_fused_sample_block_matches_reference(case):
    name, dim, chains, md, mh, scales = BLOCK_CASES[case]
    (jvg, jconsts), model = _models(name, dim)
    vg = model[0]
    ref = jax_ft.make_fused_sample_block(
        jvg, dim, max_depth=md, max_step_halvings=mh, num_draws=N_DRAWS,
        block_b=32, interpret=True, consts=jconsts)
    port = ft.make_fused_sample_block(model, dim, md, mh, N_DRAWS)
    inp = _inputs(chains, dim, 300 + len(case), N_DRAWS, scales)
    lp0, g0 = (x.numpy() for x in vg(_t(inp["theta"])))
    order = (inp["theta"], lp0, g0, inp["rho"], inp["step"], inp["inv_mass"],
             inp["min_micro"])
    w = ref(9, *(jnp.asarray(a) for a in order), MAX_ERROR)
    g = port(9, *(_t(a) for a in order), MAX_ERROR)
    keys = ("draws", "logps", "theta", "grad", "logp", "n_grads")
    want = dict(zip(keys, (np.asarray(x) for x in w)))
    got = dict(zip(keys, (x.numpy() for x in g)))
    assert got["draws"].shape == (N_DRAWS, chains, dim)
    assert got["logps"].shape == (N_DRAWS, chains)
    share = _compare(got, want, case)
    print(f"{case}: agreeing chains {share:.4f}, n_grads per draw "
          f"{want['n_grads'].mean() / N_DRAWS:.2f}")
    # the final state: the last draw is the carried point, and the carried
    # log density and gradient are the model's there
    np.testing.assert_array_equal(got["draws"][-1], got["theta"])
    np.testing.assert_array_equal(got["logps"][-1], got["logp"])
    lp_m, g_m = (x.numpy() for x in vg(_t(got["theta"])))
    np.testing.assert_allclose(got["logp"], lp_m, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["grad"], g_m, rtol=1e-5, atol=1e-5)
    assert want["n_grads"].mean() / N_DRAWS > 1.0

    # the block's accounting: the single transition, run draw by draw with
    # the block's counter bases, gives the same draws, and the block's
    # n_grads is the sum of its n_grads - 1
    theta, lp, grad = (_t(a) for a in (inp["theta"], lp0, g0))
    total = torch.zeros(chains, dtype=torch.int32)
    for i in range(N_DRAWS):
        theta, grad, lp, _, ng = ft.fused_transition_plain(
            vg, 9, theta, _t(inp["rho"][i]), lp, grad, _t(inp["step"]),
            _t(inp["inv_mass"]), _t(inp["min_micro"]), MAX_ERROR, max_depth=md,
            max_step_halvings=mh, ctr0=(1 + ft.DRAW_STRIDE * i) & 0xFFFFFFFF)
        np.testing.assert_array_equal(theta.numpy(), got["draws"][i])
        total += ng - 1
    np.testing.assert_array_equal(total.numpy(), got["n_grads"])


def test_port_alone_std_normal_moments():
    """A guard that needs no JAX run: 150 transitions of the port on the
    standard normal (D = 4, 128 chains, step 0.5) keep its moments."""
    dim, chains, iters = 4, 128, 150
    model = kernels.std_normal_vg(dim)
    vg = model[0]
    port = ft.make_fused_transition(model, dim, 6, 6)
    rng = np.random.default_rng(3)
    theta = _t(rng.standard_normal((chains, dim)).astype(np.float32))
    step = torch.full((chains,), 0.5)
    inv_mass = torch.ones((chains, dim))
    mm = torch.ones(chains, dtype=torch.int32)
    draws, depths = [], []
    for i in range(iters):
        rho = _t(rng.standard_normal((chains, dim)).astype(np.float32))
        lp0, g0 = vg(theta)
        theta, _, _, depth, _ = port(i, theta, rho, lp0, g0, step, inv_mass, mm,
                                     MAX_ERROR)
        draws.append(theta.numpy())
        depths.append(depth.numpy())
    d = np.stack(draws)[30:].reshape(-1, dim)
    assert np.abs(d.mean(0)).max() < 0.08
    assert np.abs(d.var(0) - 1.0).max() < 0.12
    depths = np.stack(depths)
    assert 1 <= depths.min() and depths.max() <= 7


def _small_args(chains=8, dim=3, n=None):
    inp = _inputs(chains, dim, 1, n or 1, {})
    model = kernels.std_normal_vg(dim)
    lp0, g0 = model[0](_t(inp["theta"]))
    a = dict(theta=_t(inp["theta"]), rho=_t(inp["rho"] if n else inp["rho"][0]),
             logp0=lp0, grad0=g0, step=_t(inp["step"]),
             inv_mass=_t(inp["inv_mass"]), min_micro=_t(inp["min_micro"]))
    return model, a


_ORDER_5A = ("theta", "rho", "logp0", "grad0", "step", "inv_mass", "min_micro")
_ORDER_5B = ("theta", "logp0", "grad0", "rho", "step", "inv_mass", "min_micro")


@pytest.mark.parametrize("what,bad", [
    ("theta", lambda a: a["theta"].double()),
    ("rho", lambda a: a["rho"][:, :2].contiguous()),
    ("logp0", lambda a: a["logp0"][:, None]),
    ("grad0", lambda a: a["grad0"].t().contiguous().t()),
    ("step", lambda a: a["step"].double()),
    ("inv_mass", lambda a: a["inv_mass"][:4]),
    ("min_micro", lambda a: a["min_micro"].long()),
])
def test_fused_transition_refuses_bad_arguments(what, bad):
    model, a = _small_args()
    fn = ft.make_fused_transition(model, 3, 4, 4)
    a[what] = bad(a)
    with pytest.raises(ValueError, match="float32" if what == "theta" else what):
        fn(0, *(a[k] for k in _ORDER_5A), MAX_ERROR)


@pytest.mark.parametrize("what,bad", [
    ("rho", lambda a: a["rho"][:3].contiguous()),  # num_draws disagrees
    ("min_micro", lambda a: a["min_micro"].float()),
    ("logp0", lambda a: a["logp0"].double()),
])
def test_fused_sample_block_refuses_bad_arguments(what, bad):
    model, a = _small_args(n=4)
    fn = ft.make_fused_sample_block(model, 3, 4, 4, 4)
    a[what] = bad(a)
    with pytest.raises(ValueError, match=what):
        fn(0, *(a[k] for k in _ORDER_5B), MAX_ERROR)


def test_factories_refuse_bad_settings():
    model = kernels.std_normal_vg(3)
    with pytest.raises(ValueError, match="max_depth"):
        ft.make_fused_transition(model, 3, ft.MAX_DEPTH + 1, 4)
    with pytest.raises(ValueError, match="max_step_halvings"):
        ft.make_fused_transition(model, 3, 4, 0)
    with pytest.raises(ValueError, match="parameters"):
        ft.make_fused_transition(model, 4, 4, 4)
    with pytest.raises(ValueError, match="num_draws"):
        ft.make_fused_sample_block(model, 3, 4, 4, 0)
    with pytest.raises(TypeError, match="model"):
        ft.make_fused_transition(lambda th: th, 3, 4, 4)
    wide = kernels.logistic_regression_vg(20, 40, device="cpu")
    fn = ft.make_fused_transition(wide, 40, 4, 4)
    z = torch.zeros((2, 40))
    with pytest.raises(ValueError, match="features"):
        fn(0, z, z, z[:, 0].contiguous(), z, z[:, 0].contiguous(), z,
           torch.ones(2, dtype=torch.int32), MAX_ERROR)


@pytest.mark.parametrize("measured, want", [
    ([7, 30, 7, 2, 90, 11], [4, 1, 5, 0, 2, 3]),
    ([5, 5, 5, 5, 5, 5], [0, 1, 2, 3, 4, 5]),
    (None, [0, 1, 2, 3, 4, 5]),
])
def test_chain_schedule(measured, want):
    """The kernels' ``sched`` operand: a counter at 0, then every chain once,
    most measured evaluations first, ties in index order; index order with
    none measured."""
    if measured is not None:
        measured = torch.tensor(measured, dtype=torch.int64)
    sched = ft.chain_schedule(6, measured)
    assert sched.dtype == torch.int32 and sched.shape == (7,)
    assert sched.tolist() == [0] + want
