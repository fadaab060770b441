"""The port's new targets, on-device diagnostics and parity statistics
against the JAX package's (CPU).

Targets: the same seeded NumPy positions through ``jax.vmap`` of the JAX
log density with ``jax.grad`` and through the port's batched function
with autograd; values and gradients within rtol 1e-10 in float64 (the
stochastic-volatility model 1e-9) and 2e-5 in float32. The AR(1) filter's
hand-written adjoint is held to ``torch.autograd.gradcheck`` and to a
sequential recursion; the diagnostics to the JAX ``summary_device`` and
the port's host ``summary`` within rtol 1e-6 in float64; the parity
statistics to the reference's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_summary import make_ar1_chain
from walnuts_tpu import parity as jparity
from walnuts_tpu import summary_device as jsd
from walnuts_tpu.models import targets as jt
from walnuts_tpu_torch import parity, summary, summary_device
from walnuts_tpu_torch.models import targets

TARGETS = {
    "condition_gaussian": (lambda: jt.condition_gaussian(7),
                           lambda: targets.condition_gaussian(7, device="cpu"), 1e-10),
    "ar1_normal": (lambda: jt.ar1_normal(7), lambda: targets.ar1_normal(7), 1e-10),
    "eight_schools": (jt.eight_schools, lambda: targets.eight_schools(device="cpu"),
                      1e-10),
    "sv_fma": (lambda: jt.stochastic_volatility(29, scan_impl="fma"),
               lambda: targets.stochastic_volatility(29, scan_impl="fma", device="cpu"),
               1e-9),
}


def _value_grad_both(name, dtype):
    make_j, make_t, _ = TARGETS[name]
    (jlogp, dim), (tlogp, tdim) = make_j(), make_t()
    assert tdim == dim
    theta = 0.5 * np.random.default_rng(sum(map(ord, name))).standard_normal((6, dim))
    jdt, tdt = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32,
                                                                       torch.float32)
    jl, jg = jax.vmap(jax.value_and_grad(jlogp))(jnp.asarray(theta, jdt))
    x = torch.tensor(theta, dtype=tdt, requires_grad=True)
    tl = tlogp(x)
    (tg,) = torch.autograd.grad(tl.sum(), x)
    assert tl.dtype == tdt and tl.shape == (6,) and tg.shape == (6, dim)
    return tl.detach().numpy(), tg.numpy(), np.asarray(jl), np.asarray(jg)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(TARGETS))
def test_target_matches_reference(name, dtype):
    tl, tg, jl, jg = _value_grad_both(name, dtype)
    rtol = TARGETS[name][2] if dtype == "float64" else 2e-5
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    np.testing.assert_allclose(tg, jg, rtol=rtol, atol=rtol * np.abs(jg).max())


def test_sv_data_bitwise():
    for n, seed in ((1000, 20260816), (13, 5)):
        a = targets.stochastic_volatility_data(n, seed)
        b = jt.stochastic_volatility_data(n, seed)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _sequential_filter(z, phi):
    u, prev = [], torch.zeros_like(z[:, 0])
    for t in range(z.shape[1]):
        prev = phi[:, 0] * prev + z[:, t]
        u.append(prev)
    return torch.stack(u, dim=1)


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_ar1_filter_adjoint(T):
    """gradcheck of the custom backward (phi per row, (C, 1)), and value and
    both gradients against autograd through the sequential recursion."""
    rng = np.random.default_rng(T)
    z = torch.tensor(rng.standard_normal((3, T)), requires_grad=True)
    phi = torch.tensor(rng.uniform(-0.97, 0.97, (3, 1)), requires_grad=True)
    assert torch.autograd.gradcheck(targets.AR1Filter.apply, (z, phi))
    w = torch.tensor(rng.standard_normal((3, T)))
    u = targets.AR1Filter.apply(z, phi)
    ref = _sequential_filter(z, phi)
    torch.testing.assert_close(u, ref, rtol=1e-12, atol=1e-12)
    g = torch.autograd.grad((w * u).sum(), (z, phi))
    g_ref = torch.autograd.grad((w * ref).sum(), (z, phi))
    for a, b in zip(g, g_ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_sv_fma_matches_assoc():
    """The pair scan (``scan_impl="assoc"``) against the default filter,
    which the tests above hold to the reference."""
    fma, dim = targets.stochastic_volatility(64, scan_impl="fma", device="cpu")
    assoc, _ = targets.stochastic_volatility(64, scan_impl="assoc", device="cpu")
    x = torch.tensor(0.5 * np.random.default_rng(1).standard_normal((5, dim)),
                     requires_grad=True)
    (gf,) = torch.autograd.grad(fma(x).sum(), x)
    (ga,) = torch.autograd.grad(assoc(x).sum(), x)
    torch.testing.assert_close(fma(x), assoc(x), rtol=1e-12, atol=0.0)
    torch.testing.assert_close(gf, ga, rtol=1e-10, atol=1e-10)


def test_sv_scan_impl_env(monkeypatch):
    """``scan_impl=None`` reads SV_SCAN_IMPL; both filters give one value."""
    monkeypatch.setenv("SV_SCAN_IMPL", "assoc")
    logp, dim = targets.stochastic_volatility(16, device="cpu")
    fma, _ = targets.stochastic_volatility(16, scan_impl="fma", device="cpu")
    x = torch.linspace(-1, 1, dim, dtype=torch.float64)[None]
    torch.testing.assert_close(logp(x), fma(x), rtol=1e-12, atol=0.0)


def test_sv_f32_finite_at_deep_negative_h():
    """One latent h_t at -92 (phi_raw = log_sigma = mu = 0, so h = z):
    exp(-h) alone overflows float32, exp(log r^2 - h) does not."""
    logp, dim = targets.stochastic_volatility(64, device="cpu")
    log_r2 = np.log(np.square(targets.stochastic_volatility_data(64)))
    t_star = int(np.argmin(log_r2))
    assert log_r2[t_star] + 92.0 < 88.0
    theta = torch.zeros((1, dim), dtype=torch.float32)
    theta[0, 3 + t_star] = -92.0
    theta.requires_grad_(True)
    lp = logp(theta)
    (g,) = torch.autograd.grad(lp.sum(), theta)
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()


def test_sv_f32_finite_where_tanh_saturates():
    """At phi_raw = -21.5 float32's tanh is exactly -1, so 1 - phi^2 +
    1e-12 is 1e-12 and the first latent step's scale 1e6. The port's
    float32 value and gradient are finite there, the JAX model's evaluated
    op by op to float32 precision, and the float64 model's too. The
    reference under ``jax.jit`` (as its sampler runs the model) gives NaN
    there: XLA drops the 1e-12, so the scale is inf. This is why a float32
    SV model can count a non-finite step in the JAX package that the
    port's does not (ROADMAP.md Queue 3)."""
    theta = np.random.default_rng(13).standard_normal(16)
    theta[:3] = (0.45, -21.5, -47.8)  # mu, phi_raw, log_sigma
    jlogp = jt.stochastic_volatility(13)[0]
    logp = targets.stochastic_volatility(13, device="cpu")[0]
    x = torch.tensor(theta[None], dtype=torch.float32, requires_grad=True)
    lp = logp(x)
    (g,) = torch.autograd.grad(lp.sum(), x)
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
    x32 = jnp.asarray(theta, jnp.float32)
    eager = float(jlogp(x32))
    value = float(lp.detach()[0])
    np.testing.assert_allclose(value, eager, rtol=2e-5)
    np.testing.assert_allclose(value, float(jlogp(jnp.asarray(theta))), rtol=2e-5)
    assert not np.isfinite(float(jax.jit(jlogp)(x32))), (
        "the jitted float32 reference is finite here now: revisit the "
        "n_nonfinite note in ROADMAP.md Queue 3")


def _ar1_fixture(c, n, seed0=1):
    return np.stack([make_ar1_chain(n, 0.9, s) for s in range(seed0, seed0 + c)])


@pytest.mark.parametrize("c,n,seed0", [(4, 31, 7), (1, 40, 3)])
def test_summary_device_matches(c, n, seed0):
    draws = _ar1_fixture(c, n, seed0)
    t = torch.as_tensor(draws)
    j = jnp.asarray(draws)
    chains = [draws[i] for i in range(c)]
    ess = summary_device.effective_sample_size_device(t).numpy()
    np.testing.assert_allclose(ess, np.asarray(jsd.effective_sample_size_device(j)),
                               rtol=1e-6)
    np.testing.assert_allclose(ess, summary.effective_sample_size(chains), rtol=1e-6)
    np.testing.assert_allclose(summary_device.mcse_device(t).numpy(),
                               summary.monte_carlo_standard_error(chains), rtol=1e-6)
    np.testing.assert_allclose(summary_device.autocovariance_device(t).numpy(),
                               np.asarray(jsd.autocovariance_device(j)), rtol=1e-6,
                               atol=1e-12)
    if c > 1:
        np.testing.assert_allclose(summary_device.r_hat_device(t).numpy(),
                                   summary.r_hat(chains), rtol=1e-6)
    wide = np.cumsum(np.random.default_rng(seed0).standard_normal((c, n, 7)), axis=1)
    np.testing.assert_allclose(
        summary_device.effective_sample_size_device_chunked(torch.as_tensor(wide),
                                                            chunk=3).numpy(),
        summary.effective_sample_size([wide[i] for i in range(c)]), rtol=1e-6)


def test_summary_device_anchor():
    """The reference's deterministic ESS anchor through the device path."""
    draws = np.stack([make_ar1_chain(20, 0.9, s) for s in (1, 2, 3)])
    ess = summary_device.effective_sample_size_device(torch.as_tensor(draws))
    np.testing.assert_allclose(ess.numpy(), [96.2568, 7.3150], atol=5e-4)


def test_parity_matches_reference():
    rng = np.random.default_rng(5)
    x = np.cumsum(rng.standard_normal((9, 80, 2)), axis=1)
    x[2] = 3.0  # a chain that never moved
    ours, ref = parity.chain_autocorr_stats(x), jparity.chain_autocorr_stats(x)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    sa = parity.tight_summary(ours[0], ours[2], 3.5)
    sb = jparity.tight_summary(ref[0], ref[2], 3.5)
    assert sa == sb
    sb2 = jparity.tight_summary(ref[0][:5], ref[2][:5], 2.0)
    assert parity.tight_ratio(sa, sb2) == jparity.tight_ratio(sb, sb2)
    assert parity.LAGS == jparity.LAGS
