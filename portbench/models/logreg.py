"""Bayesian logistic regression on the program's fused kernel (kernel 2).

The benchmark makes the data from the seed (``reference.logreg.make_data``)
and hands the same numbers to the program, as float32 on the device, and
to the reference, as float64. The program's model is what
``walnuts(fused=True)`` builds around
``walnuts_tpu_torch.ops.logreg_fused.logreg_value_grad``: the kernel's
value and gradient, sanitized.

The comparison reads four numbers:

- ``lp_gap``: the widest relative gap between the log density the window
  recorded with a sampling draw and the float64 reference's at that draw,
  over ``check.draws`` draws sampled from the seed (``harness/compare.py``);
- ``grad_gap``: the widest gap between the program's gradient at each
  chain's last draw and the reference's (``harness/compare.py``);
- ``mean_gap``: the widest gap between the pooled mean of the window's
  draws and the posterior mean, in Laplace sd;
- ``sd_gap``: the widest relative gap between the pooled sd and the
  posterior sd.

The posterior's moments are the reference's importance-sampled ones
(``reference.logreg.posterior``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness import compare as compare_mod
from portbench.reference import logreg as ref

LIBRARIES = ("replay", "logreg")

#: per row of data: y * logit (1), the stable log-sigmoid (6: abs, neg,
#: exp, log1p, max, add), its sum (1), sigmoid(-z) (3) and its product
#: with y (1)
FLOPS_PER_ROW = 12


def flops_per_grad(config: dict) -> float:
    """Operations one value and gradient need: the two products (2 N D
    each), the per-row terms, and the prior (3 D)."""
    n, d = int(config["num_rows"]), int(config["dim"])
    return 4.0 * n * d + FLOPS_PER_ROW * n + 3.0 * d


def build(config: dict, seed: int, device) -> dict:
    """The program's model on the data of ``seed``."""
    from walnuts_tpu_torch.ops import logreg_fused
    from walnuts_tpu_torch.ops.math import sanitize_logp_grad

    design, y = ref.make_data(int(config["num_rows"]), int(config["num_features"]),
                              int(config.get("data_seed", seed)))
    x_t = torch.as_tensor(design, dtype=torch.float32, device=device).contiguous()
    y_t = torch.as_tensor(y, dtype=torch.float32, device=device).contiguous()
    value_grad = logreg_fused.logreg_value_grad

    def logp_grad(theta: torch.Tensor):
        lp, g = value_grad(theta.to(torch.float32).contiguous(), x_t, y_t)
        return sanitize_logp_grad(lp.to(theta.dtype), g.to(theta.dtype))

    return {"logp_grad": logp_grad, "dim": design.shape[1],
            "inputs": {"design": design, "y": y}}


def initial_points(model: dict, chains: int, seed: int, device, spec: dict) -> torch.Tensor:
    """Overdispersed starting points: the MAP plus ``spec["scale"]`` times a
    draw from the Laplace approximation there, per chain, from ``seed``
    (float32). The benchmark computes the MAP itself (float64 Newton)."""
    x = torch.as_tensor(model["inputs"]["design"], dtype=torch.float64, device=device)
    y = torch.as_tensor(model["inputs"]["y"], dtype=torch.float64, device=device)
    beta, chol = ref.laplace(x, y)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 1) % (2**63))
    z = torch.randn((chains, beta.shape[0]), generator=gen, dtype=torch.float64,
                    device=device)
    return (beta + float(spec["scale"]) * z @ chol.T).to(torch.float32)


def collect(model: dict, win, theta0: torch.Tensor, check: dict, seed: int) -> dict:
    """What the comparison needs of the program's outputs, on the host:
    the sampled draws and their recorded log densities, every chain's last
    draw with the program's gradient there, and the pooled draws."""
    draws, logps = win.draws, win.logps
    s, c, _ = draws.shape
    rng = np.random.default_rng([int(seed), 1])
    k = min(int(check["draws"]), s * c)
    flat = rng.choice(s * c, size=k, replace=False)
    idx = torch.as_tensor(flat, device=draws.device)
    last = draws[-1].clone()
    _, g_last = model["logp_grad"](last)
    return {
        "sample_theta": draws.reshape(s * c, -1).index_select(0, idx).cpu(),
        "sample_lp": logps.reshape(s * c).index_select(0, idx).cpu(),
        "last_theta": last.cpu(),
        "last_grad": g_last.cpu(),
        "draws": draws.cpu().numpy(),
        "theta0": theta0.cpu(),
    }


def _moments(draws: np.ndarray, post) -> dict:
    _, laplace_sd, mean, sd = post
    pooled = draws.reshape(-1, draws.shape[-1]).astype(np.float64)
    return {
        "mean_gap": float((np.abs(pooled.mean(0) - mean) / laplace_sd).max()),
        "sd_gap": float(np.abs(pooled.std(0, ddof=1) / sd - 1.0).max()),
    }


def compare(model: dict, got: dict, check: dict, seed: int, device,
            control: bool = False, stuck: bool = False) -> dict:
    """The four numbers of the program (``control``: of the reference in
    TF32 in the program's place; ``stuck``: of draws that never left the
    initial points)."""
    x = torch.as_tensor(model["inputs"]["design"], dtype=torch.float64, device=device)
    y = torch.as_tensor(model["inputs"]["y"], dtype=torch.float64, device=device)
    theta_s = got["sample_theta"].to(device)
    theta_l = got["last_theta"].to(device)
    lp_s_ref, _ = ref.value_grad(theta_s, x, y)
    lp_l_ref, g_l_ref = ref.value_grad(theta_l, x, y)
    if control:
        lp_s, _ = ref.value_grad_tf32(theta_s, x, y)
        _, g_l = ref.value_grad_tf32(theta_l, x, y)
    else:
        lp_s, g_l = got["sample_lp"].to(device), got["last_grad"].to(device)
    out = {"lp_gap": compare_mod.lp_gap(lp_s, lp_s_ref),
           "grad_gap": compare_mod.row_gap(g_l, g_l_ref, lp_l_ref >= compare_mod.FLOOR)}
    post = ref.posterior(x, y, int(check["proposals"]), seed)
    draws = got["draws"]
    if stuck:
        draws = np.broadcast_to(got["theta0"].numpy()[None], draws.shape)
    out.update(_moments(draws, post))
    return out
