"""Convert the JAX package's states and model data into the port's.

The tests hold the port against the reference with the same inputs: a
reference state is turned into NumPy arrays (typed PRNG keys as their
``key_data``, ``uint32``) and from there into the port's NamedTuple of the
same name. Field names and shapes are the reference's (chain axis first),
so the conversion is by name. Keys become the port's ``int32`` bit
patterns; :func:`key_data_numpy` turns them back into ``uint32``.

This module imports no JAX: it reads any object with the reference
state's field names whose leaves NumPy can read. The reference's fused
tier-2 pass takes the lane state packed (per-lane scalars stacked ``(k,
C)``, rows chain-minor ``(..., D, C)``); :func:`lane_state_from_pass`
unpacks those operands into the port's ``LaneState``.
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
    adam_init,
)
from walnuts_tpu_torch.core.batched import LaneState
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


# the reference fused pass's packing (walnuts_tpu/core/batched.py:1054-1096)
_PACK_F = ("run_sel_logp", "run_logw", "ms_joint", "dt", "lp_cur",
           "acc_jt_bk", "acc_jt_fw", "acc_lp_sel", "acc_logw")
_PACK_I = ("depth", "out_depth", "leaf_idx", "n_leaves", "halvings",
           "steps_done", "steps_total", "phase", "n_ends", "leaf_end_at",
           "n_depth_exhausted", "draws_done")
_PACK_B = ("forward", "leaf_done", "leaf_ok")
_PACK_ROWS = {"acc_v": ("acc_th_bk", "acc_rho_bk", "acc_th_fw", "acc_rho_fw",
                        "acc_th_sel"),
              "ms": ("ms_th", "ms_rho", "ms_grad"),
              "cur": ("cur_th", "cur_rho", "cur_grad"),
              "fwd": ("fwd_th", "fwd_rho", "fwd_grad")}
_PACK_ROW = {"agb": "acc_grad_bk", "ags": "acc_grad_sel", "agf": "acc_grad_fw",
             "run_sel": "run_sel", "rsg": "run_sel_grad"}


def lane_state_from_fields(fields, dtype=torch.float64, device="cpu") -> LaneState:
    """A port ``LaneState`` from NumPy arrays by field name (chain-major,
    keys as ``uint32`` key data, ``n_depth_exhausted`` beside the other
    fields), floats cast to ``dtype``. Fields the tier-2 pass does not
    carry (Adam, the gradient count, the trip's failure counters) may be
    left out and are then zeros."""
    def t(name, x):
        x = np.asarray(x)
        if x.dtype == np.uint32:
            return key_data_torch(x, device)
        out = torch.from_numpy(np.array(x)).to(device)  # own copies
        return out.to(dtype) if out.is_floating_point() else out

    f = {n: t(n, x) for n, x in fields.items()}
    zi = torch.zeros_like(f["depth"])
    fails = FailStats(n_halve_fail=f.pop("n_halve_fail", zi),
                      n_nonfinite=f.pop("n_nonfinite", zi.clone()),
                      n_depth_exhausted=f.pop("n_depth_exhausted"))
    f.setdefault("n_grads", zi.clone())
    f.setdefault("adam", adam_init(torch.ones_like(f["dt"])))
    return LaneState(fails=fails, **f)


def lane_state_from_pass(fp, ip, bp, up, acc_v, agb, ags, agf, stack_e,
                         run_sel, rsg, ms, cur, fwd, rof, device="cpu"):
    """The reference fused pass's lane operands as a port ``LaneState``.

    ``fp`` (9, C), ``ip`` (12, C), ``bp`` (3, C), ``up`` (4, C) uint32 key
    words, ``rof`` (3, C) and the chain-minor rows, as
    ``walnuts_tpu/core/batched.py`` packs them for ``fused_pass_call``
    (inputs or outputs alike); the rows keep their dtype. Fields the pass
    does not carry are zeros (:func:`lane_state_from_fields`).
    """
    fp, ip, bp, up, rof = (np.asarray(x) for x in (fp, ip, bp, up, rof))
    rows = lambda x: np.moveaxis(np.asarray(x), -1, 0)  # (..., D, C) -> (C, ..., D)
    f = {n: fp[i] for i, n in enumerate(_PACK_F)}
    f.update({n: ip[i] for i, n in enumerate(_PACK_I)})
    f.update({n: bp[i].astype(bool) for i, n in enumerate(_PACK_B)})
    f["key"] = up[0:2].T.astype(np.uint32)
    f["ku"] = up[2:4].T.astype(np.uint32)
    packs = {"acc_v": acc_v, "ms": ms, "cur": cur, "fwd": fwd}
    for pack, names in _PACK_ROWS.items():
        arr = np.asarray(packs[pack])
        f.update({n: arr[i].T for i, n in enumerate(names)})
    for arg, n in zip((agb, ags, agf, run_sel, rsg), _PACK_ROW):
        f[_PACK_ROW[n]] = rows(arg)
    f["stack_e"] = rows(stack_e)
    f["fwd_logp_pos"], f["fwd_joint"] = rof[0], rof[1]
    return lane_state_from_fields(f, getattr(torch, fp.dtype.name), device)


def to_numpy(tree):
    """A port NamedTuple (nested ones included: a state, a
    ``TransitionResult``) as NumPy arrays; keys stay ``int32`` (see
    :func:`key_data_numpy`) and host counts stay ints."""
    if isinstance(tree, tuple):
        return type(tree)(*(to_numpy(x) for x in tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def vg_consts(consts, device="cpu") -> tuple:
    """The constants of a reference value-and-gradient factory
    (``walnuts_tpu/models/kernels.py``: logistic regression's ``(xt, x,
    y)``, the ill-conditioned normal's ``(inv_var,)``), NumPy-readable, as
    tensors of the same dtype: what the port's ``vg(theta, *consts)``
    takes."""
    return tuple(torch.from_numpy(np.array(c)).to(device) for c in consts)


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
    "lane_state_from_fields",
    "lane_state_from_pass",
    "logreg_tensors",
    "sample_state",
    "to_numpy",
    "to_port",
    "vg_consts",
    "warmup_state",
]
