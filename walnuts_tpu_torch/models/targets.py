"""Target log densities, batched over a leading chain axis.

Counterpart of ``walnuts_tpu/models/targets.py``. A target is
``logp(theta (C, D)) -> (C,)``: the reference's per-chain function with the
``vmap`` axis written out. Gradients come from autograd
(``ops.math.make_logp_grad``). Each constructor returns ``(logp_fn, dim)``.
The datasets are built with NumPy exactly as the reference builds them, so
both packages target the same posterior.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Target = Tuple[Callable[[torch.Tensor], torch.Tensor], int]


def std_normal(dim: int) -> Target:
    """Isotropic standard normal in ``dim`` dimensions."""

    def logp(theta: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(torch.square(theta), dim=-1)

    return logp, dim


def ill_conditioned_normal(dim: int) -> Target:
    """Independent normal with linearly growing scales ``sigma_d = d``: the
    stress target for mass-matrix adaptation."""
    inv_var = torch.as_tensor(1.0 / np.arange(1, dim + 1, dtype=np.float64) ** 2)

    def logp(theta: torch.Tensor) -> torch.Tensor:
        iv = inv_var.to(device=theta.device, dtype=theta.dtype)
        return -0.5 * torch.sum(iv * torch.square(theta), dim=-1)

    return logp, dim


def condition_gaussian(dim: int, kappa: float = 1e4, device="cuda") -> Target:
    """Diagonal Gaussian with geometrically spaced variances, condition
    number ``kappa``."""
    inv_var = torch.as_tensor(np.exp(-np.linspace(0.0, math.log(kappa), dim)),
                              device=device)

    def logp(theta: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(inv_var.to(theta.dtype) * torch.square(theta), dim=-1)

    return logp, dim


def ar1_normal(dim: int, rho: float = 0.99) -> Target:
    """Stationary AR(1)-correlated Gaussian with coefficient ``rho``: the
    first coordinate is standard normal, each increment ``theta[:, d] -
    rho * theta[:, d - 1]`` normal with variance ``1 - rho**2``."""
    inv_var = 1.0 / (1.0 - rho**2)

    def logp(theta: torch.Tensor) -> torch.Tensor:
        innov = theta[:, 1:] - rho * theta[:, :-1]
        return -0.5 * (torch.square(theta[:, 0])
                       + inv_var * torch.sum(torch.square(innov), dim=-1))

    return logp, dim


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


_EIGHT_SCHOOLS_Y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
_EIGHT_SCHOOLS_SIGMA = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


def eight_schools(device="cuda") -> Target:
    """Non-centered eight-schools hierarchical model (Rubin 1981 data):
    ``theta = [mu, log_tau, z_1..z_8]`` (dim 10), school effects ``mu +
    exp(log_tau) * z``, the log transform's Jacobian included."""
    y = torch.as_tensor(_EIGHT_SCHOOLS_Y, device=device)
    sigma = torch.as_tensor(_EIGHT_SCHOOLS_SIGMA, device=device)

    def logp(theta: torch.Tensor) -> torch.Tensor:
        mu, log_tau = theta[:, 0], theta[:, 1]
        z = theta[:, 2:]
        effects = mu[:, None] + torch.exp(log_tau)[:, None] * z
        lp_lik = -0.5 * torch.sum(torch.square((y.to(theta.dtype) - effects)
                                               / sigma.to(theta.dtype)), dim=-1)
        lp_z = -0.5 * torch.sum(torch.square(z), dim=-1)
        lp_mu = -0.5 * torch.square(mu) / 25.0
        lp_tau = -0.5 * torch.square(log_tau) / 4.0 + log_tau
        return lp_lik + lp_z + lp_mu + lp_tau

    return logp, 10


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


def stochastic_volatility_data(num_times: int = 1000,
                               seed: int = 20260816) -> np.ndarray:
    """Synthetic returns of the stochastic-volatility posterior (the
    reference's NumPy construction, unchanged: the same series bit for
    bit)."""
    rng = np.random.default_rng(seed)
    phi_true, sigma_true, mu_true = 0.97, 0.25, -1.0
    h = np.empty(num_times)
    h[0] = mu_true + sigma_true / math.sqrt(1 - phi_true**2) * rng.standard_normal()
    for t in range(1, num_times):
        h[t] = mu_true + phi_true * (h[t - 1] - mu_true) + sigma_true * rng.standard_normal()
    return np.exp(h / 2) * rng.standard_normal(num_times)


class AR1Filter(torch.autograd.Function):
    """Causal AR(1) filter ``u_t = phi * u_{t-1} + z_t`` (``u_{-1} = 0``)
    of every row of ``z`` (C, T), ``phi`` (C, 1) per row.

    Forward: ceil(log2 T) Hillis-Steele multiply-add passes over one array,
    the coefficient of pass l being ``phi ** (2 ** l)``. Backward: the
    analytic adjoint, the time-reversed filter of the cotangent (the same
    passes, shifted the other way), and ``dphi = sum_t a_t u_{t-1}``
    summed over t only, shape (C, 1).
    """

    @staticmethod
    def forward(ctx, z, phi):
        u, c, k = z, phi, 1
        while k < z.shape[-1]:
            u = u + c * F.pad(u[:, :-k], (k, 0))
            c = c * c
            k *= 2
        ctx.save_for_backward(u, phi)
        return u

    @staticmethod
    def backward(ctx, du):
        u, phi = ctx.saved_tensors
        a, c, k = du, phi, 1
        while k < du.shape[-1]:
            a = a + c * F.pad(a[:, k:], (0, k))
            c = c * c
            k *= 2
        dphi = torch.sum(a[:, 1:] * u[:, :-1], dim=-1, keepdim=True)
        return a, dphi


def _ar1_assoc(z0: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The same filter as a Hillis-Steele scan over (coefficient, value)
    pairs, ``(ca, va) . (cb, vb) = (ca cb, cb va + vb)``, the coefficient
    of step 0 being 0; differentiated by autograd."""
    c = torch.cat([torch.zeros_like(phi), phi.expand(-1, z0.shape[1] - 1)], dim=1)
    v, k = z0, 1
    while k < z0.shape[1]:
        v = c * F.pad(v[:, :-k], (k, 0)) + v
        c = c * F.pad(c[:, :-k], (k, 0), value=1.0)
        k *= 2
    return v


def stochastic_volatility(num_times: int = 1000, seed: int = 20260816,
                          scan_impl: Optional[str] = None,
                          device="cuda") -> Target:
    """Stochastic volatility with a non-centered latent AR(1):
    ``theta = [mu, logit_phi_raw, log_sigma, z_1..z_T]`` (dim ``T + 3``),
    ``h_1 = mu + sigma / sqrt(1 - phi^2) z_1``, ``h_t = mu + phi (h_{t-1}
    - mu) + sigma z_t``, returns ``r_t ~ N(0, exp(h_t))`` from
    :func:`stochastic_volatility_data`.

    ``scan_impl``: ``"fma"`` (the default) runs :class:`AR1Filter`,
    ``"assoc"`` the pair scan; ``None`` reads ``SV_SCAN_IMPL`` (default
    ``"fma"``). The likelihood term ``r^2 exp(-h)`` is evaluated as
    ``exp(log r^2 - h)`` with ``log r^2`` computed in float64 and cast to
    the model's dtype: the intermediate ``exp(-h)`` would overflow float32
    at h ~ -90 where the term itself is finite, and a lane that sees
    ``-inf`` there stays stuck.
    """
    if scan_impl is None:
        scan_impl = os.environ.get("SV_SCAN_IMPL", "fma")
    log_r2 = torch.as_tensor(np.log(np.square(stochastic_volatility_data(num_times, seed))),
                             device=device)

    def logp(theta: torch.Tensor) -> torch.Tensor:
        mu, phi_raw, log_sigma = theta[:, 0], theta[:, 1], theta[:, 2]
        z = theta[:, 3:]
        phi = torch.tanh(phi_raw)[:, None]
        sigma = torch.exp(log_sigma)
        scale0 = 1.0 / torch.sqrt(1.0 - torch.square(phi) + 1e-12)
        z0 = torch.cat([z[:, :1] * scale0, z[:, 1:]], dim=1)
        if scan_impl == "fma":
            u = AR1Filter.apply(z0, phi)
        else:
            u = _ar1_assoc(z0, phi)
        hpath = mu[:, None] + sigma[:, None] * u
        lp_lik = -0.5 * torch.sum(torch.exp(log_r2.to(theta.dtype) - hpath) + hpath,
                                  dim=-1)
        lp_z = -0.5 * torch.sum(torch.square(z), dim=-1)
        lp_mu = -0.5 * torch.square(mu) / 100.0
        lp_phi = -0.5 * torch.square(phi_raw) / 4.0
        lp_sigma = -0.5 * torch.square(log_sigma) / 4.0
        return lp_lik + lp_z + lp_mu + lp_phi + lp_sigma

    return logp, num_times + 3


__all__ = [
    "AR1Filter",
    "ar1_normal",
    "condition_gaussian",
    "eight_schools",
    "funnel",
    "ill_conditioned_normal",
    "logistic_regression",
    "logistic_regression_data",
    "std_normal",
    "stochastic_volatility",
    "stochastic_volatility_data",
]
