"""walnuts_tpu_torch: the WALNUTS sampler in PyTorch, with CUDA kernels.

The port of ``walnuts_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It keeps the reference's module layout and its threefry random stream, so
each piece can be held against the reference with the same inputs. The
JAX package stays as it is and is the reference; this package imports no
JAX.

Ported so far: the batched-native ``walnuts()`` path (asynchronous
adaptive warmup and sampling, with ``batched_groups``, ``model_dtype``,
``thin``, ``keep_dims``, checkpoint and resume (``checkpoint_dir``,
``BlockCheckpointer``), a profiler trace (``profile_dir``) and chains
sharded over several devices, one ``torch.distributed`` rank each
(``mesh``)) and the classic per-draw path (``batched=False``,
``integrator=``); the host-model entry points ``walnuts_pyfunc`` (a Python
callable or a C function) and ``walnuts_stan`` (a compiled BridgeStan
model through the native bridge, ``csrc/stan_bridge.cpp``); the command
line (``python -m walnuts_tpu_torch.cli``); the reference's nine targets
(``models``), the diagnostics on the host (``summary``) and on the device
(``summary_device``), the tight parity statistics (``parity``), and the
reference's six kernels — the deferred threefry
key-split replay (``csrc/replay.cu``), the fused logistic-regression value
and gradient (``csrc/logreg.cu``), the fused tier-2 pass
(``csrc/fused_pass.cu``), the fused leapfrog integrator
(``csrc/integrator.cu``) and the whole-transition kernels
(``csrc/fused_transition.cu``; ``ops.fused_transition`` exports their two
entry points, as in the reference). ROADMAP.md lists what remains.
"""

from walnuts_tpu_torch.api import walnuts, walnuts_pyfunc
from walnuts_tpu_torch.config import InitConfig, SamplingConfig, WalnutsConfig, WarmupConfig
from walnuts_tpu_torch.models.stan import walnuts_stan
from walnuts_tpu_torch.parallel.checkpoint import BlockCheckpointer
from walnuts_tpu_torch.parallel.runtime import RunInfo
from walnuts_tpu_torch.summary import (
    Summarizer,
    effective_sample_size,
    ess,
    mcse,
    mean,
    monte_carlo_standard_error,
    quantiles,
    r_hat,
    standard_deviation,
    variance,
)
from walnuts_tpu_torch.utils.output import WalnutsOutputArray, WarmupInfo

__version__ = "0.2.0"

__all__ = [
    "BlockCheckpointer",
    "InitConfig",
    "RunInfo",
    "SamplingConfig",
    "Summarizer",
    "WalnutsConfig",
    "WalnutsOutputArray",
    "WarmupConfig",
    "WarmupInfo",
    "effective_sample_size",
    "ess",
    "mcse",
    "mean",
    "monte_carlo_standard_error",
    "quantiles",
    "r_hat",
    "standard_deviation",
    "variance",
    "walnuts",
    "walnuts_pyfunc",
    "walnuts_stan",
]
