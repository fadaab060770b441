"""Hand-written batched value-and-gradients for the fused integrator.

Counterpart of ``walnuts_tpu/models/kernels.py``. A kernel cannot call
autograd, so a model that wants the fused integrator
(``ops.integrator.make_fused_integrator``) supplies its value and gradient
written out: ``vg(theta (C, D), *consts) -> (lp (C,), grad (C, D))``. Each
factory returns ``(vg, dim, consts)`` as in the reference; ``consts`` are
the model's constant tensors, and ``vg(theta)`` alone uses them.

The functions here are the plain PyTorch versions. ``vg`` is a
:class:`BatchedVG`: besides being callable it names its device body in
``csrc/models.cuh`` (``vg.body``) and carries that body's scalar
parameters (``vg.params``), which is how the CUDA integrator picks the
same model. Each is held against autograd in the tests.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from walnuts_tpu_torch.models.targets import logistic_regression_data
from walnuts_tpu_torch.ops.logreg_fused import logreg_value_grad_plain


class BatchedVG:
    """A batched value-and-gradient with the name and scalar parameters of
    its device body. ``body`` is one of ``"std_normal"``, ``"funnel"``,
    ``"ill_conditioned_normal"``, ``"logistic_regression"``."""

    def __init__(self, fn: Callable, body: str, dim: int, consts: tuple = (),
                 **params):
        self.fn = fn
        self.body = body
        self.dim = int(dim)
        self.consts = tuple(consts)
        self.params = params

    def __call__(self, theta: torch.Tensor, *consts):
        return self.fn(theta, *(consts or self.consts))


def std_normal_vg(dim: int):
    def logp_grad(theta) -> Tuple[torch.Tensor, torch.Tensor]:
        lp = -0.5 * torch.sum(theta * theta, dim=-1)
        return lp, -theta

    vg = BatchedVG(logp_grad, "std_normal", dim)
    return vg, dim, vg.consts


def funnel_vg(dim: int = 10, scale: float = 3.0):
    """Neal's funnel (see targets.funnel): v = theta[:, 0], x = theta[:, 1:].

    logp = -v^2/(2 s^2) - 0.5 ||x||^2 e^{-v} - 0.5 d v
    dv   = -v/s^2 + 0.5 ||x||^2 e^{-v} - 0.5 d
    dx   = -x e^{-v}
    """
    d_latent = dim - 1
    inv_s2 = 1.0 / (scale * scale)

    def logp_grad(theta) -> Tuple[torch.Tensor, torch.Tensor]:
        v = theta[:, :1]
        e = torch.exp(-v)
        x = theta[:, 1:]
        ssq = torch.sum(x * x, dim=-1, keepdim=True)
        lp = (-0.5 * v * v * inv_s2 - 0.5 * ssq * e - 0.5 * d_latent * v)[:, 0]
        dv = -v * inv_s2 + 0.5 * ssq * e - 0.5 * d_latent
        return lp, torch.cat([dv, -x * e], dim=-1)

    vg = BatchedVG(logp_grad, "funnel", dim, scale=float(scale))
    return vg, dim, vg.consts


def logistic_regression_vg(num_data: int = 1000, dim: int = 25,
                           seed: int = 20260816, device="cuda"):
    """Logistic regression (see targets.logistic_regression), manual grad:

    logits = theta @ X^T; lp = sum log_sigmoid(y*logits) - 0.5||theta||^2
    grad = (y * sigmoid(-y*logits)) @ X - theta

    The constants ``(xt (P, N), x (N, P), y (1, N))`` are float32 on
    ``device`` and the model always evaluates in float32, casting back to
    ``theta``'s dtype (the model's precision island).
    """
    design, y_sign = logistic_regression_data(num_data, dim, seed)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                                    device=device)
    consts = (f32(design.T), f32(design), f32(y_sign)[None, :])

    def logp_grad(theta, xt, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        # the plain version of kernel 2 (``x`` is ``xt`` transposed)
        lp, grad = logreg_value_grad_plain(theta.to(torch.float32), x, y[0])
        return lp.to(theta.dtype), grad.to(theta.dtype)

    vg = BatchedVG(logp_grad, "logistic_regression", dim, consts,
                   num_data=int(num_data))
    return vg, dim, consts


def ill_conditioned_normal_vg(dim: int, device="cuda"):
    """Independent normal with scales ``sigma_d = d``. The constant
    ``inv_var (1, D)`` is float32, as the reference keeps it, and is
    widened to ``theta``'s dtype."""
    inv_var = torch.as_tensor(
        (1.0 / np.arange(1.0, dim + 1.0) ** 2).astype(np.float32),
        device=device)[None, :]

    def logp_grad(theta, iv) -> Tuple[torch.Tensor, torch.Tensor]:
        g = -iv.to(theta.dtype) * theta
        lp = 0.5 * torch.sum(g * theta, dim=-1)
        return lp, g

    vg = BatchedVG(logp_grad, "ill_conditioned_normal", dim, (inv_var,))
    return vg, dim, vg.consts


__all__ = [
    "BatchedVG",
    "funnel_vg",
    "ill_conditioned_normal_vg",
    "logistic_regression_vg",
    "std_normal_vg",
]
