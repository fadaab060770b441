"""The fused leapfrog integrator (kernel 3): one attempt, one launch.

Counterpart of ``walnuts_tpu/ops/integrator.py``; :func:`make_fused_integrator`
is the counterpart of ``make_pallas_integrator``. The classic transition
(``core/transition.py``) integrates ``n`` leapfrog micro steps per attempt.
As tensor operations every micro step costs a handful of launches and a
round trip of the cursor through device memory; fused, the cursor stays in
registers for the whole attempt and the model's value and gradient are
evaluated inside the kernel (``csrc/integrator.cu`` with the device bodies
of ``csrc/models.cuh``).

The port is chain-batched throughout, so an integrator has the batched
signature::

    integrator(cur (C, 3, D), inv_mass (C, D), dt (C,), n_steps (C,) int32)
        -> (cur' (C, 3, D), lp (C,))

``cur`` packs the rows theta, rho, grad. Lane ``c`` takes ``n_steps[c]``
micro steps of signed size ``dt[c]``; a lane with ``n_steps == 0`` passes
through bit for bit with ``lp = -inf``.

:func:`integrate_plain` is the plain PyTorch version. :func:`make_fused_integrator`
checks its arguments on either device, then takes the plain version for CPU
tensors and the kernel for CUDA tensors. :func:`make_plain_integrator`
gives the same signature to any batched value-and-gradient; a caller
chooses it by name (tests, A/B runs), it is no fallback.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from walnuts_tpu_torch.ops.logreg_fused import MAX_FEATURES as MAX_LOGREG_FEATURES

#: the kernel keeps one chain's rows in the registers of one warp
MAX_DIM = 1024
#: rows of the design matrix the logistic-regression body stages in shared
#: memory, whole, once per launch
MAX_LOGREG_ROWS = 1024

#: the device bodies of ``csrc/models.cuh`` and ``csrc/logreg_chain.cuh``
#: (``wt::Body``), by the name a ``BatchedVG`` carries
BODIES = {"std_normal": 0, "funnel": 1, "ill_conditioned_normal": 2,
          "logistic_regression": 3}


def kernel_consts(vg, device, dtype) -> tuple:
    """The constants of ``vg``'s device body as a kernel takes them: none,
    the ill-conditioned normal's ``inv_var (D,)`` in ``dtype``, or logistic
    regression's ``x (N, P)`` and ``y (N,)`` in float32."""
    body, consts = vg.body, vg.consts
    if body == "ill_conditioned_normal":
        return (consts[0].reshape(-1).to(device=device, dtype=dtype).contiguous(),)
    if body == "logistic_regression":
        return (consts[1].to(device=device, dtype=torch.float32).contiguous(),
                consts[2].reshape(-1).to(device=device, dtype=torch.float32)
                .contiguous())
    return ()


def body_scalars(vg, d: int) -> Tuple[float, float, int]:
    """The scalar parameters of ``vg``'s device body: the funnel's
    ``1 / scale^2`` and ``0.5 (D - 1)``, logistic regression's row count."""
    if vg.body == "funnel":
        scale = vg.params["scale"]
        return 1.0 / (scale * scale), 0.5 * (d - 1), 0
    if vg.body == "logistic_regression":
        return 0.0, 0.0, vg.params["num_data"]
    return 0.0, 0.0, 0


def integrate_plain(vg: Callable, cur, inv_mass, dt, n_steps, max_steps=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``max(n_steps)`` masked leapfrog micro steps with the batched
    value-and-gradient ``vg``; lanes with ``i >= n_steps`` keep their
    values. The arithmetic, in order, of the reference kernel's body.
    ``max_steps`` is ``max(n_steps)`` where the caller has read it already
    (the read waits for the device)."""
    theta, rho, grad = cur[:, 0], cur[:, 1], cur[:, 2]
    lp = torch.full_like(dt, float("-inf"))
    dtc = dt[:, None]
    half = 0.5 * dtc
    if max_steps is None:
        max_steps = int(n_steps.max()) if n_steps.numel() else 0
    for i in range(max_steps):
        active = i < n_steps
        a1 = active[:, None]
        rho_h = rho + half * grad
        theta_n = theta + dtc * inv_mass * rho_h
        lp_n, grad_n = vg(theta_n)
        rho_n = rho_h + half * grad_n
        theta = torch.where(a1, theta_n, theta)
        rho = torch.where(a1, rho_n, rho)
        grad = torch.where(a1, grad_n, grad)
        lp = torch.where(active, lp_n, lp)
    return torch.stack([theta, rho, grad], dim=1), lp


def _check(name: str, cur, inv_mass, dt, n_steps) -> Tuple[int, int]:
    if cur.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {cur.device}")
    if cur.dim() != 3 or cur.shape[1] != 3:
        raise ValueError(f"{name}: cur must be (C, 3, D); got {tuple(cur.shape)}")
    if cur.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: cur must be float32 or float64, not {cur.dtype}")
    c, _, d = cur.shape
    for what, t, dtype, shape in (("cur", cur, cur.dtype, (c, 3, d)),
                                  ("inv_mass", inv_mass, cur.dtype, (c, d)),
                                  ("dt", dt, cur.dtype, (c,)),
                                  ("n_steps", n_steps, torch.int32, (c,))):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != cur.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {what} must be a contiguous {dtype} {shape} tensor on "
                f"{cur.device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ', not contiguous'}")
    return c, d


def make_plain_integrator(vg: Callable):
    """The integrator signature from any batched ``vg(theta) -> (lp,
    grad)``, by :func:`integrate_plain` on either device."""

    def integrator(cur, inv_mass, dt, n_steps):
        _check("plain integrator", cur, inv_mass, dt, n_steps)
        return integrate_plain(vg, cur, inv_mass, dt, n_steps)

    return integrator


class FusedIntegrator:
    """The attempt integrator of one model; see :func:`make_fused_integrator`.
    ``launches`` counts the kernel's launches."""

    def __init__(self, vg):
        self.vg = vg
        self.launches = 0
        self._consts = {}  # (device, dtype) -> the body's constant tensors

    def __call__(self, cur, inv_mass, dt, n_steps):
        vg = self.vg
        c, d = _check("fused integrator", cur, inv_mass, dt, n_steps)
        if d != vg.dim:
            raise ValueError(
                f"fused integrator: the model has {vg.dim} parameters; cur has {d}")
        if d > MAX_DIM:
            raise ValueError(
                f"fused integrator: the kernel takes up to {MAX_DIM} "
                f"parameters; got {d}")
        body = getattr(vg, "body", None)
        if body == "logistic_regression":
            if cur.dtype != torch.float32:
                raise ValueError(
                    "fused integrator: the logistic-regression body is "
                    f"float32 only; got {cur.dtype}")
            n = vg.params["num_data"]
            if d > MAX_LOGREG_FEATURES or n > MAX_LOGREG_ROWS:
                raise ValueError(
                    f"fused integrator: the logistic-regression body takes up "
                    f"to {MAX_LOGREG_FEATURES} features and {MAX_LOGREG_ROWS} "
                    f"rows; got {d} and {n}")
        if cur.device.type == "cpu":
            return integrate_plain(vg, cur, inv_mass, dt, n_steps)
        if body not in BODIES:
            raise ValueError(
                f"fused integrator: no device body for {body!r} in "
                f"csrc/models.cuh; on CUDA tensors the model must be one of "
                f"{sorted(BODIES)} (use make_plain_integrator to integrate "
                f"any vg with tensor operations)")
        from walnuts_tpu_torch.ops import _cuda

        lib = _cuda.library("integrator")
        cur_out = torch.empty_like(cur)
        lp = torch.empty_like(dt)
        if c == 0:
            return cur_out, lp
        consts = self._consts.get((cur.device, cur.dtype))
        if consts is None:
            consts = self._consts[(cur.device, cur.dtype)] = kernel_consts(
                vg, cur.device, cur.dtype)
        ptrs = [t.data_ptr() for t in consts] + [None] * (2 - len(consts))
        p0, p1, n_data = body_scalars(vg, d)
        with torch.cuda.device(cur.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.wt_integrate(
                cur.data_ptr(), inv_mass.data_ptr(), dt.data_ptr(),
                n_steps.data_ptr(), ptrs[0], ptrs[1], cur_out.data_ptr(),
                lp.data_ptr(), c, d, BODIES[body],
                int(cur.dtype == torch.float64), p0, p1, n_data, stream)
        _cuda.check(err, "wt_integrate")
        self.launches += 1
        return cur_out, lp


def make_fused_integrator(model) -> FusedIntegrator:
    """Build the attempt integrator of ``model`` for
    ``make_transition(integrator=...)`` and ``walnuts(integrator=...)``.

    ``model`` is what a factory of ``models.kernels`` returns, ``(vg, dim,
    consts)``, or its ``vg`` alone. CPU tensors take :func:`integrate_plain`
    with ``vg``; CUDA tensors launch ``csrc/integrator.cu`` with the device
    body ``vg.body`` names, one launch per call, each chain looping its own
    ``n_steps`` (float32 or float64 by ``cur``'s dtype; the
    logistic-regression body float32 only). A ``vg`` with no device body
    raises on CUDA tensors. The arguments are checked on either device.
    """
    vg = model[0] if isinstance(model, tuple) else model
    if not callable(vg) or not hasattr(vg, "dim"):
        raise TypeError(
            "make_fused_integrator: model must be (vg, dim, consts) from "
            "walnuts_tpu_torch.models.kernels, or its vg")
    return FusedIntegrator(vg)


def synthetic_attempt_inputs(chains: int, dim: int, seed: int, *,
                             max_steps: int = 256, theta_scale: float = 1.0,
                             inv_mass_scale: float = 1.0,
                             dt_range: Tuple[float, float] = (0.02, 0.1)) -> dict:
    """One attempt's operands for every chain, made with NumPy from
    ``seed`` (float64 and int32): ``theta`` ~ ``theta_scale`` N(0, 1),
    per-chain ``inv_mass`` (log-normal around ``inv_mass_scale``), ``rho``
    ~ N(0, M), ``dt`` of both signs with magnitude in ``dt_range``, and
    ``n_steps`` uniform on 0..``max_steps`` with a tenth of the lanes at 0.
    The input of the integrator checks (tests and ``chip_smoke.py``); the
    cursor's gradient row is the model's own at ``theta``."""
    rng = np.random.default_rng(seed)
    c, d = int(chains), int(dim)
    inv_mass = inv_mass_scale * np.exp(0.3 * rng.standard_normal((c, d)))
    n_steps = rng.integers(0, max_steps + 1, c)
    n_steps[rng.random(c) < 0.1] = 0
    return dict(
        theta=theta_scale * rng.standard_normal((c, d)),
        rho=rng.standard_normal((c, d)) / np.sqrt(inv_mass),
        inv_mass=inv_mass,
        dt=rng.uniform(*dt_range, c) * np.where(rng.random(c) < 0.5, -1.0, 1.0),
        n_steps=n_steps.astype(np.int32),
    )


def attempt_tensors(vg: Callable, inputs: dict, dtype, device):
    """``(cur (C, 3, D), inv_mass, dt, n_steps)`` on ``device`` from
    :func:`synthetic_attempt_inputs`, the gradient row from ``vg``."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    theta = t(inputs["theta"])
    cur = torch.stack([theta, t(inputs["rho"]), vg(theta)[1]], dim=1).contiguous()
    return (cur, t(inputs["inv_mass"]), t(inputs["dt"]),
            torch.as_tensor(inputs["n_steps"], device=device))


__all__ = [
    "BODIES",
    "MAX_DIM",
    "MAX_LOGREG_ROWS",
    "FusedIntegrator",
    "attempt_tensors",
    "body_scalars",
    "integrate_plain",
    "kernel_consts",
    "make_fused_integrator",
    "make_plain_integrator",
    "synthetic_attempt_inputs",
]
