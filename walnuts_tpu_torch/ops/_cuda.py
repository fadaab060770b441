"""Build and load the port's CUDA kernels (``walnuts_tpu_torch/csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The library name carries a hash of the source and the flags, so
an edited kernel is rebuilt and an unchanged one is reused. Libraries go to
``build/walnuts_tpu_torch/`` beside the package. Nothing here runs at
import time: this module is imported on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "walnuts_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C entry points: every pointer, and the stream, as c_void_p
_SIGNATURES = {
    "replay": {
        "wt_replay_split_chain": [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p],
    },
    "logreg": {
        "wt_logreg_value_grad": [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    },
}

_LIBRARIES: dict = {}
#: per library: {"seconds": build seconds (0.0 when reused), "log": nvcc's
#: stderr, which carries ptxas' register and shared-memory report}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of walnuts_tpu_torch cannot be built"
        )
    return found


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBRARIES.get(name)
    if lib is not None:
        return lib
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)  # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds, log = time.perf_counter() - t0, proc.stderr
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": str(out)}
    _LIBRARIES[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


__all__ = ["BUILD_DIR", "BUILD_INFO", "check", "library"]
