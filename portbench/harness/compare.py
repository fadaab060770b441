"""The gaps the comparison reads, the same for every model.

``lp_gap``: per position, the gap between the program's log density and
the float64 reference's, over the larger of the reference's magnitude and
1; positions where both lie below ``FLOOR`` (a density that float32 cannot
hold, or holds only as an overflow to ``-inf``) agree, and a gap that is
not a number is infinite. ``row_gap``: per chain, the largest gap between
the program's gradient and the reference's, over the larger of that
chain's and the median chain's largest reference component, so that a
chain whose gradient is all but zero is held to the median's scale.
"""

from __future__ import annotations

import math

import torch

#: log densities below this hold no mass float32 can express
FLOOR = -1e30


def lp_gap(lp_prog: torch.Tensor, lp_ref: torch.Tensor) -> float:
    prog = lp_prog.to(torch.float64)
    gap = (prog - lp_ref).abs() / lp_ref.abs().clamp_min(1.0)
    gap = torch.where((lp_ref < FLOOR) & (prog < FLOOR), torch.zeros_like(gap), gap)
    gap = torch.nan_to_num(gap, nan=math.inf, posinf=math.inf)
    return float(gap.max()) if gap.numel() else 0.0


def row_gap(g_prog: torch.Tensor, g_ref: torch.Tensor, rows: torch.Tensor) -> float:
    """Over the chains ``rows`` (a boolean mask) only."""
    g_prog, g_ref = g_prog[rows].to(torch.float64), g_ref[rows]
    if not g_ref.shape[0]:
        return 0.0
    scale = g_ref.abs().amax(dim=1)
    scale = torch.maximum(scale, scale.median())
    gap = (g_prog - g_ref).abs().amax(dim=1) / scale
    return float(torch.nan_to_num(gap, nan=math.inf, posinf=math.inf).max())
