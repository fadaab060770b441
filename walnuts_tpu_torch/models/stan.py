"""Stan models through the native BridgeStan bridge.

Counterpart of ``walnuts_tpu/models/stan.py`` (the reference's Stan path,
``python/src/walnutpie/stan.py`` + ``include/walnutpie/load_stan.hpp``): a
compiled BridgeStan model shared object is dlopened by the port's native
bridge (``walnuts_tpu_torch/csrc/stan_bridge.cpp``, built with ``g++`` at
first use into ``build/walnuts_tpu_torch/``), which exposes BATCHED
log-density/gradient and constrain operations over a persistent thread
pool. The sampler reaches the model through ``api.host_model``: one
``logp_grad_batch`` call per model evaluation for the whole chain batch
(one copy of the positions to the host, one of the results back), the
rows fanned out over the pool's threads (models must be built with
``STAN_THREADS=true``, as in the reference).

Two entry styles:

- ``walnuts_stan(model, ...)`` accepts a path to the compiled model
  ``.so`` or any object with a ``lib_path`` (a ``bridgestan.StanModel``),
  plus a data JSON string or dict.
- ``StanBridge`` is the low-level ctypes handle, usable directly.
"""

from __future__ import annotations

import ctypes
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, List, Optional, Union

import numpy as np

from walnuts_tpu_torch import api
from walnuts_tpu_torch.ops._cuda import build_host
from walnuts_tpu_torch.utils.output import prepare_seed

_BRIDGE_SRC = Path(__file__).resolve().parents[1] / "csrc" / "stan_bridge.cpp"

#: Separator the reference uses to join per-chain init JSONs
#: (walnutpy.cpp:224-225, stan.py:157-167).
SEPARATOR = chr(0x1C)

_double_p = ctypes.POINTER(ctypes.c_double)


def build_bridge() -> str:
    """Path of the native bridge's shared library, built if needed."""
    return str(build_host(_BRIDGE_SRC, libs=("-ldl", "-lpthread")))


def _as_double_p(a: np.ndarray):
    return a.ctypes.data_as(_double_p)


class StanBridge:
    """ctypes handle to a dlopened BridgeStan model through the native
    bridge: the counterpart of ``DynamicStanModel`` (load_stan.hpp:101-228),
    plus batching and a thread pool (``n_threads``, 0 for every core)."""

    def __init__(self, model_so: str, data: Union[str, dict, None] = None,
                 seed: int = 0, n_threads: int = 0):
        lib = self._lib = ctypes.CDLL(build_bridge())
        lib.wtpu_stan_open.restype = ctypes.c_void_p
        lib.wtpu_stan_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_uint, ctypes.c_int]
        lib.wtpu_stan_last_error.restype = ctypes.c_char_p
        lib.wtpu_stan_last_error.argtypes = []
        lib.wtpu_stan_close.restype = None
        lib.wtpu_stan_close.argtypes = [ctypes.c_void_p]
        lib.wtpu_stan_param_unc_num.restype = ctypes.c_int
        lib.wtpu_stan_param_unc_num.argtypes = [ctypes.c_void_p]
        lib.wtpu_stan_param_num.restype = ctypes.c_int
        lib.wtpu_stan_param_num.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
        lib.wtpu_stan_param_names.restype = ctypes.c_char_p
        lib.wtpu_stan_param_names.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int]
        lib.wtpu_stan_logp_grad_batch.restype = ctypes.c_int
        lib.wtpu_stan_logp_grad_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, _double_p, _double_p,
            _double_p]
        lib.wtpu_stan_constrain_batch.restype = ctypes.c_int
        lib.wtpu_stan_constrain_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _double_p, _double_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint]
        lib.wtpu_stan_unconstrain_json.restype = ctypes.c_int
        lib.wtpu_stan_unconstrain_json.argtypes = [ctypes.c_void_p,
                                                   ctypes.c_char_p, _double_p]
        if isinstance(data, dict):
            data = json.dumps(data)
        self._handle = lib.wtpu_stan_open(os.fsencode(model_so),
                                          (data or "").encode(), seed, n_threads)
        if not self._handle:
            err = lib.wtpu_stan_last_error().decode()
            raise RuntimeError(f"failed to load Stan model {model_so}: {err}")

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.wtpu_stan_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    @property
    def param_unc_num(self) -> int:
        return self._lib.wtpu_stan_param_unc_num(self._handle)

    def param_num(self, include_tp: bool = False, include_gq: bool = False) -> int:
        return self._lib.wtpu_stan_param_num(self._handle, int(include_tp),
                                             int(include_gq))

    def param_names(self, include_tp: bool = False,
                    include_gq: bool = False) -> List[str]:
        raw = self._lib.wtpu_stan_param_names(self._handle, int(include_tp),
                                              int(include_gq))
        return raw.decode().split(",") if raw else []

    def logp_grad_batch(self, theta: np.ndarray, logp: Optional[np.ndarray] = None,
                        grad: Optional[np.ndarray] = None):
        """theta (batch, dim) -> (logp (batch,), grad (batch, dim)), float64;
        written into ``logp`` and ``grad`` when given (C-contiguous
        float64 of those shapes)."""
        theta = np.ascontiguousarray(theta, dtype=np.float64)
        batch, dim = theta.shape
        if logp is None:
            logp = np.empty(batch, dtype=np.float64)
        if grad is None:
            grad = np.empty((batch, dim), dtype=np.float64)
        for a, shape in ((logp, (batch,)), (grad, (batch, dim))):
            if a.shape != shape or a.dtype != np.float64 or not a.flags.c_contiguous:
                raise ValueError(f"output must be C-contiguous float64 {shape}")
        self._lib.wtpu_stan_logp_grad_batch(self._handle, batch, dim,
                                            _as_double_p(theta), _as_double_p(logp),
                                            _as_double_p(grad))
        return logp, grad

    def unconstrain_json(self, json_str: str) -> np.ndarray:
        """Unconstrain one draw given as a JSON dict of constrained values
        (bs_param_unconstrain_json; used for user inits, stan.py:233-236)."""
        unc = np.empty(self.param_unc_num, dtype=np.float64)
        rc = self._lib.wtpu_stan_unconstrain_json(self._handle, json_str.encode(),
                                                  _as_double_p(unc))
        if rc != 0:
            err = self._lib.wtpu_stan_last_error().decode()
            raise RuntimeError(f"unconstrain failed: {err}")
        return unc

    def constrain_batch(self, unc: np.ndarray, include_tp: bool = False,
                        include_gq: bool = False, seed: int = 0) -> np.ndarray:
        unc = np.ascontiguousarray(unc, dtype=np.float64)
        batch, unc_dim = unc.shape
        con_dim = self.param_num(include_tp, include_gq)
        con = np.empty((batch, con_dim), dtype=np.float64)
        self._lib.wtpu_stan_constrain_batch(
            self._handle, batch, unc_dim, con_dim, _as_double_p(unc),
            _as_double_p(con), int(include_tp), int(include_gq), seed)
        return con


def make_stan_logp(bridge: StanBridge):
    """A batched ``fused=True`` model backed by the bridge, and its
    dimension: one ``logp_grad_batch`` call per model evaluation, whose
    thread pool spreads the rows over the host's cores."""

    def evaluate(theta: np.ndarray, logp: np.ndarray, grad: np.ndarray) -> None:
        bridge.logp_grad_batch(theta, logp, grad)

    return api.host_model(evaluate), bridge.param_unc_num


class StanVariable:
    """One Stan variable's slice of the flat constrained row.

    The stanio equivalent (the reference parses headers with
    ``stanio.parse_header``, stan.py:31): a flat column block plus the
    declared dims recovered from the BridgeStan ``name.i.j`` suffixes,
    reassembled COLUMN-MAJOR (Stan order). ``extract_reshape`` mirrors
    ``stanio.Variable.extract_reshape``.
    """

    def __init__(self, name: str, start: int, dims: tuple):
        self.name = name
        self.start = start
        self.dims = dims
        self.size = int(np.prod(dims, dtype=np.int64)) if dims else 1

    def extract_reshape(self, data: np.ndarray) -> np.ndarray:
        block = data[..., self.start:self.start + self.size]
        if not self.dims:
            return block[..., 0]
        return block.reshape(block.shape[:-1] + self.dims, order="F")


def parse_variables(names: List[str]) -> dict:
    """Group flat BridgeStan column names into :class:`StanVariable`\\ s.

    Names look like ``alpha``, ``v.1`` ... ``v.K``, ``M.1.1`` ... ``M.R.C``
    (indices column-major); the dims are the componentwise maxima of the
    index suffixes, as the reference's stanio header parsing gives them.
    """
    groups: dict = {}
    order: List[str] = []
    for i, n in enumerate(names):
        parts = n.split(".")
        base_end = len(parts)
        while base_end > 1 and parts[base_end - 1].isdigit():
            base_end -= 1
        base = ".".join(parts[:base_end])
        idx = tuple(int(p) for p in parts[base_end:])
        if base not in groups:
            groups[base] = {"start": i, "idxs": []}
            order.append(base)
        groups[base]["idxs"].append((i, idx))
    out = {}
    for base in order:
        rec = groups[base]
        idxs = rec["idxs"]
        if len(idxs) == 1 and idxs[0][1] == ():
            out[base] = StanVariable(base, rec["start"], ())
            continue
        ndim = len(idxs[0][1])
        dims = tuple(max(ix[d] for _, ix in idxs) for d in range(ndim))
        var = StanVariable(base, rec["start"], dims)
        cols = [c for c, _ in idxs]
        if cols != list(range(rec["start"], rec["start"] + var.size)):
            raise ValueError(f"parameter {base!r} occupies non-contiguous columns")
        out[base] = var
    return out


@dataclass
class StanOutput:
    """Constrained draws of one chain plus metadata (stan.py:19-145).

    ``parameters`` holds the RAW flat column names; ``variables`` the
    parsed per-variable views (``obj["M"]`` returns draws reshaped to the
    declared dims, column-major, like the reference's stanio-backed
    ``StanOutputBase.get``).
    """

    parameters: List[str]
    data: np.ndarray  # (draws, constrained dim)
    stepsize: Optional[float] = None
    inv_metric: Optional[np.ndarray] = None
    warmup_data: Optional[np.ndarray] = None

    def __post_init__(self):
        self.variables = parse_variables(self.parameters)

    def __getitem__(self, name: str) -> np.ndarray:
        """Draws of one variable, reshaped to its declared dims (a flat
        column name like ``"M.2.1"`` is also accepted)."""
        var = self.variables.get(name)
        if var is not None:
            return var.extract_reshape(self.data)
        try:
            idx = self.parameters.index(name)
        except ValueError as e:
            raise KeyError(name) from e
        return self.data[:, idx]

    def get(self, name: str) -> np.ndarray:
        """Synonym for ``obj[name]`` (StanOutputBase.get, stan.py:51)."""
        return self[name]

    def create_inits(self, seed: Optional[int] = None, chains: int = 4) -> List[dict]:
        """Resample draws into init dicts for a follow-up run
        (stan.py:108-145). Array and matrix parameters come back with their
        declared shapes (column-major), so the dicts are valid Stan JSON
        inits for any parameterization."""
        rng = np.random.default_rng(seed)
        rows = rng.choice(self.data.shape[0], size=chains, replace=True)
        return [{name: var.extract_reshape(self.data[r])
                 for name, var in self.variables.items()} for r in rows]


def _dumps(d: dict) -> str:
    # create_inits dicts carry NumPy scalars and arrays; Stan JSON wants lists
    return json.dumps(d, default=lambda o: o.tolist() if hasattr(o, "tolist") else o)


def walnuts_stan(
    model: Any,
    *,
    data: Union[str, dict, None] = None,
    seed: Optional[int] = None,
    n_threads: int = 0,
    include_tp: bool = False,
    include_gq: bool = False,
    **kwargs,
) -> List[StanOutput]:
    """Sample from a compiled Stan model with adaptive WALNUTS.

    ``model`` is a path to a compiled BridgeStan model ``.so`` or an
    object with a ``lib_path`` (a ``bridgestan.StanModel``, as in the
    reference, stan.py:178-211). ``inits`` may be constrained-scale dicts
    (one, or one per chain, e.g. from :meth:`StanOutput.create_inits`),
    unconstrained through the model. The other keyword arguments go to
    :func:`walnuts_tpu_torch.walnuts` (``device`` defaults to ``"cuda"``,
    the sampler's ``dtype`` to float32). Draws are returned on the
    CONSTRAINED scale through the bridge's batched ``bs_param_constrain``
    (StanBufferHandler semantics, handlers.hpp:127-154).
    """
    seed = prepare_seed(seed)
    if hasattr(model, "lib_path"):
        model_so = os.fspath(model.lib_path)
    elif isinstance(model, (str, os.PathLike)):
        model_so = os.fspath(model)
    else:
        raise TypeError(
            "model must be a bridgestan.StanModel or a path to a compiled "
            f"model shared object; got {type(model)!r}")

    bridge = StanBridge(model_so, data=data, seed=seed, n_threads=n_threads)
    try:
        logp_grad, dim = make_stan_logp(bridge)
        inits = kwargs.get("inits")
        if isinstance(inits, dict):
            kwargs["inits"] = bridge.unconstrain_json(_dumps(inits))
        elif isinstance(inits, (list, tuple)) and inits and isinstance(inits[0], dict):
            kwargs["inits"] = np.stack([bridge.unconstrain_json(_dumps(d))
                                        for d in inits])
        kwargs.setdefault("num_params", dim)
        return_info = kwargs.get("return_info", False)
        outputs = api.walnuts(logp_grad, fused=True, seed=seed, **kwargs)
        info = None
        if return_info:
            outputs, info = outputs

        names = bridge.param_names(include_tp, include_gq)
        results: List[StanOutput] = []
        for chain in outputs:
            con = bridge.constrain_batch(np.asarray(chain), include_tp, include_gq,
                                         seed)
            warm = None
            if chain.warmup.warmup_draws is not None:
                warm = bridge.constrain_batch(np.asarray(chain.warmup.warmup_draws),
                                              include_tp, include_gq, seed)
            results.append(StanOutput(parameters=names, data=con,
                                      stepsize=chain.warmup.stepsize,
                                      inv_metric=chain.warmup.inv_metric,
                                      warmup_data=warm))
    finally:
        bridge.close()
    if return_info:
        return results, info
    return results


__all__ = [
    "SEPARATOR",
    "StanBridge",
    "StanOutput",
    "StanVariable",
    "build_bridge",
    "make_stan_logp",
    "parse_variables",
    "walnuts_stan",
]
