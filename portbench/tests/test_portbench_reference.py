"""The plain reference: float64 gradients against finite differences, the
data copies against the program's constructions, the densities against
the program's at small sizes, and the controls' rounding."""

import numpy as np
import pytest
import torch

from portbench.harness import compare
from portbench.reference import logreg as lr_ref


def _fd_check(fn, theta, eps=1e-6, rtol=1e-6):
    lp, g = fn(theta)
    fd = torch.empty_like(theta)
    for j in range(theta.shape[1]):
        e = torch.zeros_like(theta)
        e[:, j] = eps
        fd[:, j] = (fn(theta + e)[0] - fn(theta - e)[0]) / (2 * eps)
    scale = g.abs().amax(dim=1, keepdim=True).clamp_min(1.0)
    assert ((fd - g).abs() / scale).max() < rtol


@pytest.mark.parametrize("seed", [0, 2**31 + 77])
def test_logreg_gradient_against_finite_differences(seed):
    design, y = lr_ref.make_data(300, 6, seed)
    x, yt = torch.as_tensor(design), torch.as_tensor(y)
    theta = torch.randn(5, 7, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    _fd_check(lambda t: lr_ref.value_grad(t, x, yt), theta)


def test_data_copies_are_the_programs():
    from walnuts_tpu_torch.models import targets

    for seed in (20260816, 2**31 + 3):
        d_ref, y_ref = lr_ref.make_data(700, 24, seed)
        d, y = targets.logistic_regression_data(700, 25, seed)
        np.testing.assert_array_equal(d_ref, d)
        np.testing.assert_array_equal(y_ref, y)


def test_logreg_density_is_the_programs():
    from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad_plain

    design, y = lr_ref.make_data(400, 8, 5)
    x, yt = torch.as_tensor(design), torch.as_tensor(y)
    theta = torch.randn(16, 9, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    lp, g = lr_ref.value_grad(theta, x, yt)
    lp_p, g_p = logreg_value_grad_plain(theta, x, yt)
    torch.testing.assert_close(lp, lp_p, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(g, g_p, rtol=1e-12, atol=1e-9)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12,
                      3.0e-3])
    r = lr_ref.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0  # a tie rounds to even
    assert r[3] == 1.0 + 2**-9
    assert r[4] == -1.0
    assert abs(r[5] / 3.0e-3 - 1) <= 2**-11


def test_controls_read_higher_than_the_reference_itself():
    design, y = lr_ref.make_data(2000, 28, 7)
    x, yt = torch.as_tensor(design), torch.as_tensor(y)
    theta = 0.05 * torch.randn(64, 29, generator=torch.Generator().manual_seed(5),
                               dtype=torch.float64)
    lp, g = lr_ref.value_grad(theta, x, yt)
    lp32, g32 = lr_ref.value_grad_tf32(theta, x, yt)
    rows = torch.ones(64, dtype=torch.bool)
    assert compare.lp_gap(lp32, lp) > 1e-6
    assert compare.row_gap(g32, g, rows) > 1e-5
    assert compare.lp_gap(lp.float(), lp) < 1e-7


def test_gaps_treat_unrepresentable_densities_as_agreeing():
    ref = torch.tensor([-1e40, -5.0, -1e40], dtype=torch.float64)
    assert compare.lp_gap(torch.tensor([-float("inf"), -5.0, -1e31]), ref) == 0.0
    assert compare.lp_gap(torch.tensor([-float("inf"), -float("inf"), -1e31]), ref) == float("inf")
    assert compare.lp_gap(torch.tensor([float("nan"), -5.0, -1e31]), ref) == float("inf")
