"""Output containers mirroring the reference Python package's surface.

A copy of ``walnuts_tpu/utils/output.py``, kept NumPy-only so that the PyTorch port
imports no JAX (``walnuts_tpu/__init__.py`` pulls JAX in through ``api``).
The reference module is the one to change; keep this copy in step.

``WalnutsOutputArray`` is an ndarray subclass carrying a ``.warmup``
attribute, and ``WarmupInfo`` the adapted step size / inverse metric /
warmup draws — matching ``python/src/walnutpie/pyfunc.py:10-29`` and
``util.py:53-70`` of the reference so downstream code ports unchanged.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Generic, Optional, TypeVar

import numpy as np

T = TypeVar("T")


@dataclass
class WarmupInfo(Generic[T]):
    """Adapted warmup results for one chain (util.py:53-70).

    ``warmup_logps`` (the per-iteration log densities the reference's
    ``on_warmup`` handler receives alongside each draw, handlers.hpp:73-89)
    is an extension over the reference's container: it rides along with
    ``save_warmup`` at no extra cost.
    """

    stepsize: Optional[float] = None
    inv_metric: Optional[T] = None
    warmup_draws: Optional[T] = None
    warmup_logps: Optional[T] = None


class WalnutsOutputArray(np.ndarray):
    """An ndarray of draws with a ``.warmup`` attribute (pyfunc.py:10-29)."""

    warmup: WarmupInfo

    def __new__(cls, input_array, warmup: WarmupInfo):
        obj = np.asarray(input_array).view(cls)
        obj.warmup = warmup
        return obj

    def __array_finalize__(self, obj):
        if obj is None:
            return
        self.warmup = getattr(obj, "warmup", None)


def prepare_seed(seed: Optional[int]) -> int:
    """Random non-negative 32-bit seed when none is given (util.py:12-17)."""
    if seed is None:
        return secrets.randbits(32)
    if seed < 0:
        raise ValueError(f"seed must be non-negative; found seed = {seed}")
    return int(seed)


__all__ = ["WalnutsOutputArray", "WarmupInfo", "prepare_seed"]
