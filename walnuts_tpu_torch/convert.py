"""Convert the JAX package's states and model data into the port's.

The tests hold the port against the reference with the same inputs: a
reference state is turned into NumPy arrays (typed PRNG keys as their
``key_data``, ``uint32``) and from there into the port's NamedTuple of the
same name. Field names and shapes are the reference's (chain axis first),
so the conversion is by name. Keys become the port's ``int32`` bit
patterns; :func:`key_data_numpy` turns them back into ``uint32``.

This module imports no JAX: it reads any object with the reference
state's field names whose leaves NumPy can read.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from walnuts_tpu_torch.core.adapt import (
    AdamState,
    MassEstimatorState,
    MinMicroState,
    OnlineMomentsState,
)
from walnuts_tpu_torch.core.sampler import FrozenParams, SampleState, WarmupState
from walnuts_tpu_torch.core.transition import FailStats

# nested NamedTuple fields, by container type
_NESTED = {
    WarmupState: {"adam": AdamState, "mass": MassEstimatorState,
                  "min_micro": MinMicroState, "fails": FailStats},
    SampleState: {"fails": FailStats},
    MassEstimatorState: {"draws": OnlineMomentsState,
                         "scores": OnlineMomentsState},
}


def key_data_torch(key_data, device="cpu") -> torch.Tensor:
    """``uint32`` key data (NumPy) -> the port's ``int32`` bit patterns."""
    arr = np.ascontiguousarray(np.asarray(key_data, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def key_data_numpy(key: torch.Tensor) -> np.ndarray:
    """The port's ``int32`` key tensor -> ``uint32`` key data (NumPy)."""
    return key.detach().cpu().numpy().view(np.uint32)


def _leaf(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype == np.uint32:
        return key_data_torch(arr, device)
    return torch.from_numpy(np.array(arr)).to(device)


def to_port(cls, obj, device="cpu"):
    """Build the port's ``cls`` (``WarmupState``, ``SampleState``,
    ``FrozenParams`` or a nested state) from ``obj``, a reference state
    with NumPy-readable leaves and keys given as ``uint32`` key data."""
    nested = _NESTED.get(cls, {})
    return cls(**{
        name: (to_port(nested[name], getattr(obj, name), device)
               if name in nested else _leaf(getattr(obj, name), device))
        for name in cls._fields
    })


def warmup_state(obj, device="cpu") -> WarmupState:
    return to_port(WarmupState, obj, device)


def sample_state(obj, device="cpu") -> SampleState:
    return to_port(SampleState, obj, device)


def frozen_params(obj, device="cpu") -> FrozenParams:
    return to_port(FrozenParams, obj, device)


def to_numpy(tree):
    """A port NamedTuple (nested ones included) as NumPy arrays; keys stay
    ``int32`` (see :func:`key_data_numpy`)."""
    if isinstance(tree, tuple):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def logreg_tensors(design, y_sign, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The logistic-regression design matrix ``(N, P)`` and labels ``(N,)``
    (±1) as the float32 tensors the fused kernel takes."""
    x = torch.as_tensor(np.asarray(design), dtype=torch.float32).to(device)
    y = torch.as_tensor(np.asarray(y_sign), dtype=torch.float32).to(device)
    return x.contiguous(), y.contiguous()


__all__ = [
    "frozen_params",
    "key_data_numpy",
    "key_data_torch",
    "logreg_tensors",
    "sample_state",
    "to_numpy",
    "to_port",
    "warmup_state",
]
