"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips. The file imports no JAX, so it also runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_gpu.py -q`` (``--noconftest`` keeps the suite's JAX setup
out). The replay kernel is integer arithmetic and must be bitwise equal;
the logistic-regression kernel sums in another order than the plain
version's matrix products, so it is held to ``tests/test_pallas.py``'s
float32 tolerances.
"""

import numpy as np
import pytest
import torch

from walnuts_tpu_torch.convert import key_data_torch, logreg_tensors
from walnuts_tpu_torch.models.targets import logistic_regression_data
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.logreg_fused import (
    logistic_regression_fused,
    logreg_value_grad,
    logreg_value_grad_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _replay_inputs(c, seed):
    rng = np.random.default_rng(seed)
    kd = rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.uint32)
    ku = rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.uint32)
    n_ends = rng.integers(0, 13, size=c).astype(np.int32)
    leaf_end_at = (rng.random(c) * (n_ends + 1)).astype(np.int32)
    return (key_data_torch(kd), key_data_torch(ku), torch.from_numpy(n_ends),
            torch.from_numpy(leaf_end_at))


@pytest.mark.parametrize("c", [1, 100, 4096])
def test_replay_kernel_bitwise_vs_plain(cuda, c):
    args = _replay_inputs(c, c)
    want = prng.replay_split_chain_plain(*args)
    before = prng.replay_split_chain.launches
    got = prng.replay_split_chain(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert prng.replay_split_chain.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_replay_kernel_refuses_bad_input(cuda):
    k, ku, n, at = (a.to(cuda) for a in _replay_inputs(8, 1))
    with pytest.raises(ValueError, match="n_ends"):
        prng.replay_split_chain(k, ku, n.long(), at)
    with pytest.raises(ValueError, match="key_data"):
        prng.replay_split_chain(k.t().contiguous().t(), ku, n, at)


@pytest.mark.parametrize("b", [1, 37, 4096])
def test_logreg_kernel_vs_plain(cuda, b):
    design, y = logistic_regression_data()
    x_t, y_t = logreg_tensors(design, y, cuda)
    rng = np.random.default_rng(b)
    theta = torch.from_numpy((0.3 * rng.standard_normal((b, 25))).astype(np.float32))
    lp_p, g_p = logreg_value_grad_plain(theta.to(cuda), x_t, y_t)
    before = logreg_value_grad.launches
    lp_k, g_k = logreg_value_grad(theta.to(cuda), x_t, y_t)
    torch.cuda.synchronize()
    assert logreg_value_grad.launches == before + 1
    np.testing.assert_allclose(lp_k.cpu().numpy(), lp_p.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(),
                               rtol=1e-4, atol=2e-3)


def test_logreg_kernel_other_widths(cuda):
    """Feature counts 1..32 and row counts beyond one staged chunk."""
    for n, p in ((50, 1), (1500, 32), (3000, 7)):
        design, y = logistic_regression_data(n, p, 3)
        x_t, y_t = logreg_tensors(design, y, cuda)
        theta = 0.2 * torch.randn((70, p), device=cuda)
        lp_p, g_p = logreg_value_grad_plain(theta, x_t, y_t)
        lp_k, g_k = logreg_value_grad(theta, x_t, y_t)
        torch.cuda.synchronize()
        np.testing.assert_allclose(lp_k.cpu().numpy(), lp_p.cpu().numpy(), rtol=1e-5)
        np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(),
                                   rtol=1e-4, atol=2e-3 * n / 1000)


def test_logreg_kernel_refuses_bad_input(cuda):
    design, y = logistic_regression_data()
    x_t, y_t = logreg_tensors(design, y, cuda)
    theta = torch.zeros((4, 25), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        logreg_value_grad(theta.double(), x_t, y_t)
    with pytest.raises(ValueError, match="features"):
        wide = torch.zeros((4, 33), device=cuda)
        logreg_value_grad(wide, torch.zeros((10, 33), device=cuda), y_t[:10])


def test_fused_model_on_the_card_is_a_float32_island(cuda):
    fused, dim = logistic_regression_fused(device=cuda)
    theta = 0.1 * torch.randn((9, dim), dtype=torch.float64, device=cuda)
    lp, g = fused(theta)
    assert lp.dtype == torch.float64 and g.device.type == "cuda"
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()
