"""Build and load the port's CUDA kernels (``walnuts_tpu_torch/csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The library name carries a hash of the source, of every header
it includes from ``csrc/``, and of the flags, so an edited kernel or header
is rebuilt and an unchanged one is reused. Libraries go to
``build/walnuts_tpu_torch/`` beside the package. Nothing here runs at
import time: this module is imported on machines without ``nvcc``.

``build_host`` compiles a plain C or C++ source for the host (``gcc`` /
``g++``) the same way: hash-named, written atomically into the same
directory (never beside its source), reused when built. The native Stan
bridge (``csrc/stan_bridge.cpp``) is built with it, and so are the test
models of the tests and of ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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

# flags beyond NVCC_FLAGS, per library: the fused pass draws normals through
# threefry.cuh's polynomials, and the integrator's leapfrog and simple model
# bodies repeat their plain versions' arithmetic, and so do the transition
# kernels' energies, U-turn products and log-sum-exp; all must round each
# product as PyTorch does
_EXTRA_FLAGS = {"fused_pass": ("-fmad=false",), "integrator": ("-fmad=false",),
                "fused_transition": ("-fmad=false",)}

# C entry points: every pointer, and the stream, as c_void_p
_SIGNATURES = {
    "replay": {
        "wt_replay_split_chain": [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_void_p],
        # blocks, threads a block, stream
        "wt_empty_kernel": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    },
    "logreg": {
        "wt_logreg_value_grad": [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    },
    "fused_pass": {
        # the address of a FusedPassArgs struct (ops/fused_pass.py), stream
        "wt_fused_pass": [ctypes.c_void_p, ctypes.c_void_p],
        "wt_fused_pass_args_size": [],
    },
    "integrator": {
        # cur, inv_mass, dt, n_steps, two constants, cur_out, lp_out, the
        # chain schedule; C, D, body, is_double; two scalar parameters;
        # n_data; stream
        "wt_integrate": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
        + [ctypes.c_double] * 2 + [ctypes.c_int, ctypes.c_void_p],
    },
    "fused_transition": {
        # the address of a TransitionArgs struct (ops/fused_transition.py),
        # stream
        "wt_fused_transition": [ctypes.c_void_p, ctypes.c_void_p],
        "wt_fused_sample_block": [ctypes.c_void_p, ctypes.c_void_p],
        "wt_transition_args_size": [],
        # the address of a TransitionArgs struct, the address of an int64
        "wt_transition_workspace": [ctypes.c_void_p, ctypes.c_void_p],
    },
}

_LIBRARIES: dict = {}
#: per library: {"seconds": build seconds (0.0 when reused), "log": nvcc's
#: stderr, which carries ptxas' register and shared-memory report (kept
#: beside the library as ``.log``, so a reused library has it too)}
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(src: Path) -> list:
    """``src`` and every file it includes with quotes, recursively."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def _target(name: str):
    """Source, flags and library path of ``csrc/<name>.cu``."""
    src = _CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + _EXTRA_FLAGS.get(name, ())
    h = hashlib.sha256(" ".join(flags).encode())
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, flags, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


_BUILT: dict = {}  # name -> (seconds, nvcc's stderr) of a build in this process


def build(*names: str) -> None:
    """Compile the libraries of ``names`` that are not built yet: one
    ``nvcc`` process per source, all started at once, then waited for."""
    jobs = []
    for name in names:
        src, flags, out = _target(name)
        if name in _LIBRARIES or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *flags, "-o", tmp, str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((name, src, out, tmp, proc, time.perf_counter()))
    errors = []
    for name, src, out, tmp, proc, t0 in jobs:
        stdout, stderr = proc.communicate()
        try:
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                              f"{stdout}\n{stderr}")
            else:
                with open(tmp + ".log", "w") as f:
                    f.write(stderr)
                # atomic: concurrent builds agree; the log first, so a
                # library that exists has its log
                os.replace(tmp + ".log", out.with_suffix(".log"))
                os.replace(tmp, out)
                _BUILT[name] = (time.perf_counter() - t0, stderr)
        finally:
            for path in (tmp, tmp + ".log"):
                if os.path.exists(path):
                    os.unlink(path)
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBRARIES.get(name)
    if lib is not None:
        return lib
    build(name)
    _, _, out = _target(name)
    seconds, log = _BUILT.get(name, (0.0, None))
    if log is None:
        kept = out.with_suffix(".log")
        log = kept.read_text() if kept.exists() else ""
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": str(out)}
    _LIBRARIES[name] = lib
    return lib


_HOST_FLAGS = {".c": ("-O2", "-shared", "-fPIC"),
               ".cpp": ("-O3", "-std=c++17", "-shared", "-fPIC")}


def build_host(src, defines=(), libs=()) -> Path:
    """The shared library of the C (``gcc``) or C++ (``g++``) source
    ``src``, compiled with ``-D`` ``defines`` and linked with ``libs``
    (``-ldl``, ...) into ``BUILD_DIR`` if it is not there yet; named by a
    hash of the source, its quoted includes and the flags. The library is
    written under a temporary name and renamed into place, so concurrent
    builds agree. A failed build raises ``RuntimeError``."""
    src = Path(src).resolve()
    compiler = "gcc" if src.suffix == ".c" else "g++"
    flags = _HOST_FLAGS[".c" if src.suffix == ".c" else ".cpp"] + tuple(
        f"-D{d}" for d in defines)
    h = hashlib.sha256(" ".join((compiler,) + flags + tuple(libs)).encode())
    for path in _sources(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([compiler, *flags, "-o", tmp, str(src), *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed on {src} (exit {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")


__all__ = ["BUILD_DIR", "BUILD_INFO", "build", "build_host", "check", "library"]
