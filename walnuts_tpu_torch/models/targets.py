"""Target log densities, batched over a leading chain axis.

Counterpart of ``walnuts_tpu/models/targets.py``. A target is
``logp(theta (C, D)) -> (C,)``: the reference's per-chain function with the
``vmap`` axis written out. Gradients come from autograd
(``ops.math.make_logp_grad``). Each constructor returns ``(logp_fn, dim)``.
The datasets are built with NumPy exactly as the reference builds them, so
both packages target the same posterior.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Target = Tuple[Callable[[torch.Tensor], torch.Tensor], int]


def funnel(dim: int = 10, scale: float = 3.0) -> Target:
    """Neal's funnel: v ~ N(0, scale^2), x_i | v ~ N(0, exp(v));
    ``theta[:, 0]`` is ``v`` and ``theta[:, 1:]`` the latent ``x``."""

    def logp(theta: torch.Tensor) -> torch.Tensor:
        v = theta[:, 0]
        x = theta[:, 1:]
        d = x.shape[1]
        lp_v = -0.5 * torch.square(v) / (scale**2)
        lp_x = -0.5 * torch.sum(torch.square(x), dim=-1) * torch.exp(-v) - 0.5 * d * v
        return lp_v + lp_x

    return logp, dim


def logistic_regression_data(
    num_data: int = 1000, dim: int = 25, seed: int = 20260816
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic logistic-regression dataset: ``(design,
    y_sign)`` with an intercept column, standardized covariates and labels
    in {-1, +1} (the reference's NumPy construction, unchanged)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((num_data, dim - 1))
    x = (x - x.mean(axis=0)) / x.std(axis=0)
    design = np.concatenate([np.ones((num_data, 1)), x], axis=1)
    beta_true = rng.standard_normal(dim) * 0.5
    logits = design @ beta_true
    labels = (rng.random(num_data) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    return design, 2.0 * labels - 1.0


def logistic_regression(
    num_data: int = 1000,
    dim: int = 25,
    seed: int = 20260816,
    device="cuda",
) -> Target:
    """Bayesian logistic regression on the fixed synthetic data, standard
    normal prior; the data live on ``device``. Products run in full float32
    or float64 (TF32 off), as the reference pins ``Precision.HIGHEST``."""
    design, y_sign_np = logistic_regression_data(num_data, dim, seed)
    design_t = torch.as_tensor(design, device=device)
    y_sign = torch.as_tensor(y_sign_np, device=device)

    def logp(theta: torch.Tensor) -> torch.Tensor:
        torch.backends.cuda.matmul.allow_tf32 = False
        logits = theta @ design_t.to(theta.dtype).T
        lp_lik = torch.sum(F.logsigmoid(y_sign.to(theta.dtype) * logits), dim=-1)
        lp_prior = -0.5 * torch.sum(torch.square(theta), dim=-1)
        return lp_lik + lp_prior

    return logp, dim


__all__ = ["funnel", "logistic_regression", "logistic_regression_data"]
