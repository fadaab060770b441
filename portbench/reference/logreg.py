"""Plain reference of Bayesian logistic regression with a standard normal
prior, and the data the benchmark gives it and the program alike.

Everything here is plain NumPy or PyTorch and imports nothing of the
program. ``make_data`` is the benchmark's own copy of the synthetic data
set's construction (an intercept column, standardized normal covariates,
labels drawn from a logistic model with coefficients ``N(0, 0.5^2)``).
``value_grad`` is the log density and its gradient in float64;
``value_grad_tf32`` the same in the precision just below the program's
(float32 products whose operands are rounded to TF32), which is the
control that the comparison must reject. ``posterior`` gives the moments
the draws are held to: the Newton MAP, the Laplace sd, and the posterior
mean and sd by importance sampling from the Laplace approximation.
"""

from __future__ import annotations

import numpy as np
import torch


def make_data(num_rows: int, num_features: int, seed: int):
    """``(design (N, F + 1), y (N,) in {-1, +1})``, float64, from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((num_rows, num_features))
    x = (x - x.mean(axis=0)) / x.std(axis=0)
    design = np.concatenate([np.ones((num_rows, 1)), x], axis=1)
    beta_true = rng.standard_normal(num_features + 1) * 0.5
    logits = design @ beta_true
    labels = (rng.random(num_rows) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float64)
    return design, 2.0 * labels - 1.0


def _log_sigmoid(z: torch.Tensor) -> torch.Tensor:
    return -(torch.clamp_min(-z, 0.0) + torch.log1p(torch.exp(-z.abs())))


def _value_grad(theta, x, y, rows: int, cast):
    """Value and gradient of every row of ``theta``, ``rows`` chains at a
    time; ``cast`` rounds each product's operands."""
    lps, grads = [], []
    xt = cast(x)
    for i in range(0, theta.shape[0], rows):
        t = theta[i:i + rows]
        z = y * (cast(t) @ xt.T)
        lps.append(_log_sigmoid(z).sum(-1) - 0.5 * (t * t).sum(-1))
        grads.append(cast(y * torch.sigmoid(-z)) @ xt - t)
    return torch.cat(lps), torch.cat(grads)


def value_grad(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               rows: int = 256):
    """Float64 log density ``(B,)`` and gradient ``(B, D)`` of ``theta``
    ``(B, D)``; ``x`` ``(N, D)`` and ``y`` ``(N,)`` are float64 on the
    same device. TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    theta = theta.to(torch.float64)
    return _value_grad(theta, x.to(torch.float64), y.to(torch.float64), rows,
                       lambda t: t)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32 (10 mantissa bits, to nearest even)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def value_grad_tf32(theta: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    rows: int = 256):
    """The control: ``value_grad`` in float32 with both products' operands
    rounded to TF32, as a TF32 matrix product takes them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return _value_grad(theta.to(torch.float32), x.to(torch.float32),
                       y.to(torch.float32), rows, round_tf32)


def laplace(x: torch.Tensor, y: torch.Tensor):
    """``(map, chol)``: Newton's MAP and the Cholesky factor of the inverse
    Hessian there, float64 on ``x``'s device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = x.to(torch.float64), y.to(torch.float64)
    d = x.shape[1]
    eye = torch.eye(d, dtype=torch.float64, device=x.device)
    beta = torch.zeros(d, dtype=torch.float64, device=x.device)
    for _ in range(100):
        s = torch.sigmoid(-y * (x @ beta))
        grad = x.T @ (y * s) - beta
        hess = x.T @ (x * (s * (1.0 - s))[:, None]) + eye
        step = torch.linalg.solve(hess, grad)
        beta = beta + step
        if float(step.abs().max()) < 1e-12:
            break
    return beta, torch.linalg.cholesky(torch.linalg.inv(hess))


def posterior(x: torch.Tensor, y: torch.Tensor, proposals: int, seed: int,
              rows: int = 2048):
    """``(map, laplace_sd, mean, sd)`` of the posterior, float64 NumPy:
    Newton's MAP, ``sqrt(diag(H^-1))`` there, and the mean and sd by
    importance sampling from the Laplace approximation with ``proposals``
    draws from a generator seeded with ``seed``."""
    x, y = x.to(torch.float64), y.to(torch.float64)
    d = x.shape[1]
    beta, chol = laplace(x, y)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed) % (2**63))
    eps = torch.randn((proposals, d), generator=gen, dtype=torch.float64,
                      device=x.device)
    theta = beta + eps @ chol.T
    log_w = torch.empty(proposals, dtype=torch.float64, device=x.device)
    for i in range(0, proposals, rows):
        t = theta[i:i + rows]
        log_w[i:i + rows] = (_log_sigmoid(y * (t @ x.T)).sum(-1)
                             - 0.5 * (t * t).sum(-1)
                             + 0.5 * (eps[i:i + rows] ** 2).sum(-1))
    w = torch.exp(log_w - log_w.max())
    w = w / w.sum()
    mean = w @ theta
    sd = torch.sqrt(w @ (theta - mean) ** 2)
    return (beta.cpu().numpy(), torch.sqrt((chol * chol).sum(1)).cpu().numpy(),
            mean.cpu().numpy(), sd.cpu().numpy())
