"""The port's model value-and-gradients and attempt integrator against
the JAX reference (CPU).

Inputs are made with NumPy from a seed and go through both packages.

* The four hand-written ``vg``s (``walnuts_tpu_torch/models/kernels.py``)
  against the reference's and against the port's autograd
  ``make_logp_grad``. float64: rtol 1e-12 (the packages differ by
  summation order and the last bits of ``exp``). The ill-conditioned
  normal keeps its constant in float32 as the reference does, so against
  the float64 autograd target it is held to rtol 1e-7. Logistic regression
  evaluates in float32: lp rtol 2e-5, grad atol 1e-3, the reference's own
  bounds (``tests/test_integrator.py``).
* ``integrate_plain`` against the reference's Pallas kernel in interpret
  mode, run as ``tests/test_integrator.py`` runs it (``block_b=8``,
  vmapped), with heterogeneous ``n_steps`` including 0 and both signs of
  ``dt``: float64 rtol 1e-10 after up to 9 steps (float32 logistic
  regression rtol 1e-4 / atol 1e-4); zero-step lanes bitwise, ``lp = -inf``.
* The wrapper of the fused integrator: on CPU tensors it is the plain
  version and counts no launch; what it refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu.models import kernels as jax_kernels
from walnuts_tpu.ops.integrator import make_pallas_integrator
from walnuts_tpu_torch import convert
from walnuts_tpu_torch.models import (
    funnel,
    ill_conditioned_normal,
    logistic_regression,
    std_normal,
)
from walnuts_tpu_torch.models import kernels
from walnuts_tpu_torch.ops import integrator as integ
from walnuts_tpu_torch.ops.math import make_logp_grad

LOGREG = dict(num_data=64, dim=5)

# body -> (reference factory, port factory, port target, dtype, input scales)
CASES = {
    "std_normal": (lambda: jax_kernels.std_normal_vg(5),
                   lambda: kernels.std_normal_vg(5),
                   lambda: std_normal(5), torch.float64, {}),
    "funnel": (lambda: jax_kernels.funnel_vg(9),
               lambda: kernels.funnel_vg(9),
               lambda: funnel(9), torch.float64, dict(theta_scale=0.5)),
    "ill_conditioned_normal": (
        lambda: jax_kernels.ill_conditioned_normal_vg(6),
        lambda: kernels.ill_conditioned_normal_vg(6, device="cpu"),
        lambda: ill_conditioned_normal(6), torch.float64, {}),
    "logistic_regression": (
        lambda: jax_kernels.logistic_regression_vg(**LOGREG),
        lambda: kernels.logistic_regression_vg(**LOGREG, device="cpu"),
        lambda: logistic_regression(**LOGREG, device="cpu"), torch.float32,
        dict(theta_scale=0.3, inv_mass_scale=0.05)),
}
BODIES = sorted(CASES)


def _theta(dim, dtype, seed=0, scale=0.4, chains=7):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(scale * rng.standard_normal((chains, dim)), dtype=dtype)


@pytest.mark.parametrize("body", BODIES)
def test_vg_matches_reference(body):
    ref_factory, port_factory, _, dtype, _ = CASES[body]
    ref_vg, dim, ref_consts = ref_factory()
    vg, pdim, consts = port_factory()
    assert (vg.body, pdim, len(consts)) == (body, dim, len(ref_consts))
    theta = _theta(dim, dtype)
    lp_r, g_r = (np.asarray(a) for a in ref_vg(jnp.asarray(theta.numpy())))
    lp, g = vg(theta)
    assert lp.dtype == dtype and g.shape == theta.shape
    if dtype == torch.float64:
        np.testing.assert_allclose(lp.numpy(), lp_r, rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), g_r, rtol=1e-12, atol=1e-14)
    else:
        np.testing.assert_allclose(lp.numpy(), lp_r, rtol=2e-5)
        np.testing.assert_allclose(g.numpy(), g_r, atol=1e-3)
    # the reference's constants, carried across, are the port's own
    carried = convert.vg_consts([np.asarray(c) for c in ref_consts])
    for a, b in zip(carried, consts):
        assert a.dtype == b.dtype and torch.equal(a, b)
    lp_c, g_c = vg(theta, *carried)
    assert torch.equal(lp_c, lp) and torch.equal(g_c, g)


@pytest.mark.parametrize("body", BODIES)
def test_vg_matches_autograd(body):
    _, port_factory, target, dtype, _ = CASES[body]
    vg, dim, _ = port_factory()
    logp, _ = target()
    theta = _theta(dim, dtype, seed=1)
    lp, g = vg(theta)
    lp_a, g_a = make_logp_grad(logp)(theta)
    if dtype == torch.float32:
        np.testing.assert_allclose(lp.numpy(), lp_a.numpy(), rtol=2e-5)
        np.testing.assert_allclose(g.numpy(), g_a.numpy(), atol=1e-3)
    else:
        # the ill-conditioned normal's constant is float32 (see the module
        # docstring); the others differ from autograd by rounding only
        rtol = 1e-7 if body == "ill_conditioned_normal" else 1e-12
        np.testing.assert_allclose(lp.numpy(), lp_a.numpy(), rtol=rtol)
        np.testing.assert_allclose(g.numpy(), g_a.numpy(), rtol=rtol, atol=1e-14)


def _attempt(vg, dim, dtype, scales, chains=11):
    inp = integ.synthetic_attempt_inputs(chains, dim, 3, max_steps=9, **scales)
    inp["n_steps"][:4] = [0, 1, 9, 0]
    return integ.attempt_tensors(vg, inp, dtype, "cpu")


@pytest.mark.parametrize("body", BODIES)
def test_integrate_plain_matches_reference_kernel(body):
    ref_factory, port_factory, _, dtype, scales = CASES[body]
    ref_vg, dim, ref_consts = ref_factory()
    model = port_factory()
    cur, inv_mass, dt, n_steps = _attempt(model[0], dim, dtype, scales)
    assert (dt > 0).any() and (dt < 0).any() and (n_steps == 0).sum() >= 2

    ref = make_pallas_integrator(ref_vg, block_b=8, interpret=True,
                                 consts=ref_consts)
    cur_r, lp_r = jax.vmap(ref)(*(jnp.asarray(t.numpy())
                                  for t in (cur, inv_mass, dt, n_steps)))
    cur_r, lp_r = np.asarray(cur_r), np.asarray(lp_r)

    fused = integ.make_fused_integrator(model)
    cur_p, lp_p = fused(cur, inv_mass, dt, n_steps)
    assert fused.launches == 0  # CPU tensors: the plain version, no launch
    cur_q, lp_q = integ.integrate_plain(model[0], cur, inv_mass, dt, n_steps)
    assert torch.equal(cur_p, cur_q) and torch.equal(lp_p, lp_q)

    zero = (n_steps == 0).numpy()
    np.testing.assert_array_equal(cur_p.numpy()[zero], cur.numpy()[zero])
    np.testing.assert_array_equal(cur_r[zero], cur.numpy()[zero])
    assert np.all(lp_p.numpy()[zero] == -np.inf) and np.all(lp_r[zero] == -np.inf)
    tol = (dict(rtol=1e-10, atol=1e-12) if dtype == torch.float64
           else dict(rtol=1e-4, atol=1e-4))
    np.testing.assert_allclose(cur_p.numpy(), cur_r, **tol)
    np.testing.assert_allclose(lp_p.numpy()[~zero], lp_r[~zero], **tol)


def test_plain_integrator_takes_any_vg():
    """``make_plain_integrator`` of the autograd value-and-gradient agrees
    with the hand-written one (float64 rtol 1e-10 over 9 steps)."""
    vg, dim, _ = kernels.funnel_vg(9)
    args = _attempt(vg, dim, torch.float64, dict(theta_scale=0.5))
    cur_a, lp_a = integ.make_plain_integrator(make_logp_grad(funnel(9)[0]))(*args)
    cur_b, lp_b = integ.make_fused_integrator(vg)(*args)
    np.testing.assert_allclose(cur_a.numpy(), cur_b.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lp_a.numpy(), lp_b.numpy(), rtol=1e-10)


def _good(dim=5, dtype=torch.float32, chains=4):
    vg, _, _ = kernels.std_normal_vg(dim)
    inp = integ.synthetic_attempt_inputs(chains, dim, 5, max_steps=3)
    return list(integ.attempt_tensors(vg, inp, dtype, "cpu"))


def _refusals():
    def wrong_dtype():
        a = _good()
        a[0] = a[0].to(torch.float16)
        return kernels.std_normal_vg(5), a

    def wrong_cur_shape():
        a = _good()
        a[0] = a[0][:, :2].contiguous()
        return kernels.std_normal_vg(5), a

    def wrong_inv_mass_shape():
        a = _good()
        a[1] = a[1][:, :4].contiguous()
        return kernels.std_normal_vg(5), a

    def non_contiguous():
        a = _good()
        a[0] = a[0].transpose(0, 1).contiguous().transpose(0, 1)
        return kernels.std_normal_vg(5), a

    def n_steps_int64():
        a = _good()
        a[3] = a[3].to(torch.int64)
        return kernels.std_normal_vg(5), a

    def dt_other_dtype():
        a = _good()
        a[2] = a[2].to(torch.float64)
        return kernels.std_normal_vg(5), a

    def dim_above_cap():
        d = integ.MAX_DIM + 1
        return kernels.std_normal_vg(d), _good(dim=d, chains=2)

    def dim_not_the_models():
        return kernels.std_normal_vg(6), _good()

    def logreg_float64():
        model = kernels.logistic_regression_vg(**LOGREG, device="cpu")
        return model, _good(dtype=torch.float64)

    return [wrong_dtype, wrong_cur_shape, wrong_inv_mass_shape, non_contiguous,
            n_steps_int64, dt_other_dtype, dim_above_cap, dim_not_the_models,
            logreg_float64]


@pytest.mark.parametrize("case", _refusals(), ids=lambda f: f.__name__)
def test_fused_integrator_refuses(case):
    model, args = case()
    with pytest.raises(ValueError, match="fused integrator"):
        integ.make_fused_integrator(model)(*args)


def test_make_fused_integrator_wants_a_model():
    with pytest.raises(TypeError, match="make_fused_integrator"):
        integ.make_fused_integrator(lambda theta: (theta.sum(-1), theta))
