"""The port's plain modules against the JAX reference (CPU, x64).

The fused logistic-regression value and gradient (kernel 2's plain
version) is held against the reference's Pallas kernel in interpret mode
with ``tests/test_pallas.py``'s tolerances: both evaluate in float32 and
sum 1000 terms in different orders. The math, adaptation and target
modules are held against their reference functions in float64, where the
only differences are summation order and the last bits of ``exp``/``log``
(rtol 1e-12). Kernels on the card are held against these plain versions
by the ``gpu``-marked tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu.core import adapt as jadapt
from walnuts_tpu.core import transition as jtransition
from walnuts_tpu.models import targets as jtargets
from walnuts_tpu.ops import math as jmath
from walnuts_tpu.ops.pallas_kernels import logistic_regression_fused as jax_fused
from walnuts_tpu_torch.convert import key_data_torch, logreg_tensors
from walnuts_tpu_torch.core import adapt, transition
from walnuts_tpu_torch.models import targets
from walnuts_tpu_torch.ops import math as tmath
from walnuts_tpu_torch.ops.logreg_fused import (
    logistic_regression_fused,
    logreg_value_grad,
    logreg_value_grad_plain,
)


@pytest.fixture(scope="module")
def jax_logreg():
    return jax_fused(interpret=True)[0]


def _theta(b, p, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, p))).astype(np.float32)


@pytest.mark.parametrize("b", [3, 8, 300])
def test_logreg_plain_vs_pallas_interpret(jax_logreg, b):
    theta = _theta(b, 25, b)
    lp_j, g_j = jax.vmap(jax_logreg)(jnp.asarray(theta))
    design, y = jtargets.logistic_regression_data()
    x_t, y_t = logreg_tensors(design, y)
    lp_t, g_t = logreg_value_grad_plain(torch.from_numpy(theta), x_t, y_t)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=2e-3)


def test_logreg_fused_model_is_a_float32_island(jax_logreg):
    """A float64 caller gets float64 back from a float32 evaluation, like
    the reference's custom-vmap wrapper."""
    fused, dim = logistic_regression_fused(device="cpu")
    theta = _theta(5, dim, 1).astype(np.float64)
    lp, g = fused(torch.from_numpy(theta))
    assert lp.dtype == torch.float64 and g.dtype == torch.float64
    lp_j, g_j = jax.vmap(jax_logreg)(jnp.asarray(theta))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=2e-3)


def test_logreg_fused_matches_autograd_model():
    fused, dim = logistic_regression_fused(device="cpu")
    logp, _ = targets.logistic_regression(device="cpu")
    theta = torch.from_numpy(_theta(4, dim, 2).astype(np.float64))
    lp_f, g_f = fused(theta)
    lp_a, g_a = tmath.make_logp_grad(logp)(theta)
    np.testing.assert_allclose(lp_f.numpy(), lp_a.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g_f.numpy(), g_a.numpy(), atol=2e-3)


@pytest.mark.parametrize("p", [0, 1, 32, 33])
def test_logreg_wrapper_feature_counts(p):
    """1..32 features, the kernel's padded widths 4..32, run; 0 and 33 are
    refused on either device."""
    rng = np.random.default_rng(p)
    theta = torch.from_numpy(rng.standard_normal((3, p)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((6, p)).astype(np.float32))
    y = torch.tensor([1.0, -1.0, 1.0, 1.0, -1.0, -1.0])
    if not 1 <= p <= 32:
        with pytest.raises(ValueError, match="features"):
            logreg_value_grad(theta, x, y)
        return
    lp, g = logreg_value_grad(theta, x, y)
    want = logreg_value_grad_plain(theta, x, y)
    assert torch.equal(lp, want[0]) and torch.equal(g, want[1])
    assert lp.shape == (3,) and g.shape == (3, p)


def test_logreg_wrapper_refuses_other_devices():
    meta = torch.empty((4, 25), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        logreg_value_grad(meta, meta, meta[0])


@pytest.mark.parametrize("name", ["funnel", "logistic_regression"])
def test_targets_value_and_grad_vs_jax(name):
    if name == "funnel":
        jlogp, dim = jtargets.funnel(7)
        tlogp, _ = targets.funnel(7)
    else:
        jlogp, dim = jtargets.logistic_regression()
        tlogp, _ = targets.logistic_regression(device="cpu")
    theta = _theta(6, dim, 3, scale=0.5).astype(np.float64)
    lp_j, g_j = jax.vmap(jmath.make_logp_grad(jlogp))(jnp.asarray(theta))
    lp_t, g_t = tmath.make_logp_grad(tlogp)(torch.from_numpy(theta))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12,
                               atol=1e-12)


def test_logreg_data_identical():
    a = jtargets.logistic_regression_data(200, 9, 4)
    b = targets.logistic_regression_data(200, 9, 4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_math_edge_cases_vs_jax():
    inf, nan = np.inf, np.nan
    x1 = np.array([0.0, -inf, inf, -inf, 1.0, nan, 3.0, 700.0])
    x2 = np.array([0.0, -inf, inf, 2.0, nan, 1.0, -2.0, 699.0])
    got = tmath.log_sum_exp(torch.from_numpy(x1), torch.from_numpy(x2)).numpy()
    want = np.asarray(jmath.log_sum_exp(jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_array_equal(got, want)
    lp = np.array([1.0, nan, inf, -inf])
    g = np.array([[1.0, nan], [inf, 2.0], [-inf, 0.0], [3.0, 4.0]])
    lp_t, g_t = tmath.sanitize_logp_grad(torch.from_numpy(lp), torch.from_numpy(g))
    lp_j, g_j = jmath.sanitize_logp_grad(jnp.asarray(lp), jnp.asarray(g))
    np.testing.assert_array_equal(lp_t.numpy(), np.asarray(lp_j))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    x = np.arange(1, 300, dtype=np.int32)
    np.testing.assert_array_equal(
        tmath.count_trailing_zeros(torch.from_numpy(x)).numpy(),
        np.asarray(jmath.count_trailing_zeros(jnp.asarray(x))))


def test_leapfrog_and_step_size_search_vs_jax():
    jlogp, dim = jtargets.funnel(6)
    tlogp, _ = targets.funnel(6)
    jlg, tlg = jmath.make_logp_grad(jlogp), tmath.make_logp_grad(tlogp)
    rng = np.random.default_rng(5)
    c = 8
    theta = rng.standard_normal((c, dim))
    rho = rng.standard_normal((c, dim))
    mass = np.exp(0.3 * rng.standard_normal((c, dim)))
    step = np.exp(rng.standard_normal(c))
    err_j = jax.vmap(lambda t, r, m, s: jmath.leapfrog_error(jlg, t, r, 1 / m, s))(
        *map(jnp.asarray, (theta, rho, mass, step)))
    err_t = tmath.leapfrog_error(tlg, *map(torch.from_numpy, (theta, rho, 1 / mass, step)))
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-10, atol=1e-12)
    keys = rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.uint32)
    jkeys = jax.vmap(jax.random.wrap_key_data)(jnp.asarray(keys))
    s_j = jax.vmap(lambda k, t, m, s: jmath.adapt_step_size(k, jlg, t, m, s))(
        jkeys, *map(jnp.asarray, (theta, mass, step)))
    s_t = tmath.adapt_step_size(key_data_torch(keys), tlg,
                                *map(torch.from_numpy, (theta, mass, step)))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-12)


def test_adaptation_states_vs_jax():
    rng = np.random.default_rng(6)
    c, d, n = 5, 4, 12
    init_mass = np.exp(rng.standard_normal((c, d)))
    jm = jax.vmap(lambda m: jadapt.mass_estimator_init(m, 4.0))(jnp.asarray(init_mass))
    tm = adapt.mass_estimator_init(torch.from_numpy(init_mass), 4.0)
    ja = jax.vmap(lambda s: jadapt.adam_init(s, dtype=jnp.float64))(jnp.full((c,), 0.7))
    ta = adapt.adam_init(torch.full((c,), 0.7, dtype=torch.float64))
    jmm = jax.vmap(lambda _: jadapt.min_micro_init(15.0, 1, dtype=jnp.float64))(jnp.arange(c))
    tmm = adapt.min_micro_init(c, 15.0, 1, torch.float64, "cpu")
    for i in range(n):
        th, g = rng.standard_normal((c, d)), rng.standard_normal((c, d))
        acc = rng.random(c)
        depth = rng.integers(1, 6, size=c).astype(np.int32)
        it = jnp.full((c,), i, jnp.int32)
        jm = jax.vmap(jadapt.mass_estimator_observe)(jm, jnp.asarray(th), jnp.asarray(g), it)
        tm = adapt.mass_estimator_observe(tm, torch.from_numpy(th), torch.from_numpy(g),
                                          torch.full((c,), i, dtype=torch.int32))
        ja = jax.vmap(jadapt.adam_update)(ja, jnp.asarray(acc))
        ta = adapt.adam_update(ta, torch.from_numpy(acc))
        jmm = jax.vmap(jadapt.min_micro_observe)(jmm, jnp.int32(1) << jnp.asarray(depth))
        tmm = adapt.min_micro_observe(tmm, torch.ones(c, dtype=torch.int32)
                                      << torch.from_numpy(depth))
    np.testing.assert_allclose(adapt.mass_estimator_inv_mass(tm).numpy(),
                               np.asarray(jax.vmap(jadapt.mass_estimator_inv_mass)(jm)),
                               rtol=1e-12)
    np.testing.assert_allclose(adapt.adam_step_size(ta).numpy(),
                               np.asarray(jadapt.adam_step_size(ja)), rtol=1e-12)
    np.testing.assert_array_equal(adapt.min_micro_estimate(tmm).numpy(),
                                  np.asarray(jax.vmap(jadapt.min_micro_estimate)(jmm)))
    grad = rng.standard_normal((c, d))
    np.testing.assert_allclose(
        adapt.nutpie_init_mass(torch.from_numpy(grad), 1e-5).numpy(),
        np.asarray(jadapt.nutpie_init_mass(jnp.asarray(grad), 1e-5)), rtol=1e-15)


def test_inv_mass_frozen_coordinate_falls_back_to_one():
    """Both variances exactly 0 (a frozen coordinate): 0/0 gives unit
    inverse mass, as in the reference, not NaN."""
    z = torch.zeros((2, 3), dtype=torch.float32)
    mom = adapt.OnlineMomentsState(torch.ones(2), z, z)
    st = adapt.MassEstimatorState(mom, mom, torch.full((2,), 4.0))
    np.testing.assert_array_equal(adapt.mass_estimator_inv_mass(st).numpy(),
                                  np.ones((2, 3), np.float32))


def test_span_algebra_vs_jax():
    """The shared span helpers, batched, against the reference's per-chain
    ones (vmapped): rows and U-turn decisions exact."""
    rng = np.random.default_rng(7)
    c, d = 32, 5
    th, rho, th2, rho2 = (rng.standard_normal((c, d)) for _ in range(4))
    lp, jt, lp2, jt2 = (rng.standard_normal(c) for _ in range(4))
    inv_mass = np.exp(rng.standard_normal((c, d)))
    forward = rng.random(c) < 0.5
    unif = rng.random(c)
    t = lambda *xs: [torch.from_numpy(np.asarray(x)) for x in xs]
    j = lambda *xs: [jnp.asarray(x) for x in xs]
    ov, os_ = transition.span_from_point(*t(th, rho, lp, jt))
    nv, ns = transition.span_from_point(*t(th2, rho2, lp2, jt2))
    jov, jos = jax.vmap(jtransition.span_from_point)(*j(th, rho, lp, jt))
    jnv, jns = jax.vmap(jtransition.span_from_point)(*j(th2, rho2, lp2, jt2))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    np.testing.assert_array_equal(os_.numpy(), np.asarray(jos))
    # a non-trivial older span: one merge first
    ov, os_ = transition.span_combine(*t(unif), ov, os_, nv, ns,
                                      torch.from_numpy(forward), True)
    jov, jos = jax.vmap(lambda *a: jtransition.span_combine(*a, True))(
        jnp.asarray(unif), jov, jos, jnv, jns, jnp.asarray(forward))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jov))
    # logw is a log-sum-exp: last-bit differences of exp/log1p
    np.testing.assert_allclose(os_.numpy(), np.asarray(jos), rtol=1e-14, atol=1e-15)
    got = transition.span_uturn(ov, nv, torch.from_numpy(forward),
                                torch.from_numpy(inv_mass)).numpy()
    want = np.asarray(jax.vmap(jtransition.span_uturn)(
        jov, jnv, jnp.asarray(forward), jnp.asarray(inv_mass)))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < c

