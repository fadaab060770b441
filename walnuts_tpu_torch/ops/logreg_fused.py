"""Fused logistic-regression value and gradient (kernel 2).

Counterpart of ``walnuts_tpu/ops/pallas_kernels.py`` (the Pallas
``_logreg_kernel`` behind ``logistic_regression_fused``). For a ``(B, P)``
batch of chain positions:

    logits = theta @ X^T
    logp   = sum log_sigmoid(y * logits) - 0.5 ||theta||^2
    grad   = (y * sigmoid(-y * logits)) @ X - theta

:func:`logreg_value_grad` takes the plain PyTorch version
(:func:`logreg_value_grad_plain`) for CPU tensors and the hand-written
kernel of ``csrc/logreg.cu`` for CUDA tensors. Both evaluate in float32
with full IEEE products (no TF32), as the TPU kernel pinned
``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from walnuts_tpu_torch.models.targets import logistic_regression_data

#: the kernel keeps one chain's coefficients in a lane's registers, padded
#: to the feature count rounded up to 4 (at most 32)
MAX_FEATURES = 32


def _log_sigmoid_stable(z: torch.Tensor) -> torch.Tensor:
    return -(torch.clamp_min(-z, 0.0) + torch.log1p(torch.exp(-z.abs())))


def logreg_value_grad_plain(theta, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: two float32 matrix products (TF32 off) and the
    stable log-sigmoid. ``theta`` (B, P), ``x`` (N, P), ``y`` (N,) ±1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    z = y * (theta @ x.T)
    lp = _log_sigmoid_stable(z).sum(-1) - 0.5 * (theta * theta).sum(-1)
    grad = (y * torch.sigmoid(-z)) @ x - theta
    return lp, grad


def logreg_value_grad(theta, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Value and gradient of the logistic-regression log density for every
    row of ``theta`` — the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors, after the same argument checks on either device. All
    three are contiguous float32; returns ``(lp (B,), grad (B, P))``."""
    if theta.device.type not in ("cpu", "cuda"):
        raise ValueError(f"logreg_value_grad: unsupported device {theta.device}")
    if theta.dim() != 2 or x.dim() != 2 or y.dim() != 1:
        raise ValueError("logreg_value_grad: theta (B, P), x (N, P), y (N,)")
    b, p = theta.shape
    n = x.shape[0]
    if x.shape[1] != p or y.shape[0] != n:
        raise ValueError(
            f"logreg_value_grad: shapes theta {tuple(theta.shape)}, "
            f"x {tuple(x.shape)}, y {tuple(y.shape)} do not agree"
        )
    if not 1 <= p <= MAX_FEATURES:
        raise ValueError(
            f"logreg_value_grad: the kernel takes 1..{MAX_FEATURES} "
            f"features; got {p}"
        )
    for name, t in (("theta", theta), ("x", x), ("y", y)):
        if (t.dtype != torch.float32 or t.device != theta.device
                or not t.is_contiguous()):
            raise ValueError(
                f"logreg_value_grad: {name} must be contiguous float32 on "
                f"{theta.device}; got {t.dtype} on {t.device}"
            )
    if theta.device.type == "cpu":
        return logreg_value_grad_plain(theta, x, y)
    from walnuts_tpu_torch.ops import _cuda

    lib = _cuda.library("logreg")
    lp = torch.empty((b,), dtype=torch.float32, device=theta.device)
    grad = torch.empty((b, p), dtype=torch.float32, device=theta.device)
    if b:
        with torch.cuda.device(theta.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.wt_logreg_value_grad(
                theta.data_ptr(), x.data_ptr(), y.data_ptr(), lp.data_ptr(),
                grad.data_ptr(), b, p, n, stream,
            )
        _cuda.check(err, "wt_logreg_value_grad")
        logreg_value_grad.launches += 1
    return lp, grad


logreg_value_grad.launches = 0


def logistic_regression_fused(
    num_data: int = 1000,
    dim: int = 25,
    seed: int = 20260816,
    device="cuda",
) -> Tuple[Callable, int]:
    """Logistic-regression target with a fused value-and-gradient.

    Returns ``(logp_grad, dim)``; ``logp_grad(theta (C, D)) -> (lp (C,),
    grad (C, D))`` is the signature ``walnuts(..., fused=True)`` expects.
    The model always evaluates in float32 and casts back to ``theta``'s
    dtype (the reference's precision island, pallas_kernels.py:112-127),
    so a float64 sampler still runs a float32 model. The data are the
    reference's (``logistic_regression_data``) and live on ``device``.
    """
    design, y_sign = logistic_regression_data(num_data, dim, seed)
    x = torch.as_tensor(design, dtype=torch.float32, device=device).contiguous()
    y = torch.as_tensor(y_sign, dtype=torch.float32, device=device).contiguous()

    def logp_grad(theta: torch.Tensor):
        lp, g = logreg_value_grad(theta.to(torch.float32).contiguous(), x, y)
        return lp.to(theta.dtype), g.to(theta.dtype)

    return logp_grad, dim


__all__ = [
    "MAX_FEATURES",
    "logistic_regression_fused",
    "logreg_value_grad",
    "logreg_value_grad_plain",
]
