"""The port's ``walnuts()`` against the JAX package's, end to end (CPU).

Two configurations of the slice: funnel(5) through autograd in float64,
and the fused logistic regression (``fused=True``, a float32 model under a
float64 sampler, as in ``tests/test_pallas.py``). Seeds, keys, initial
positions, the initial step-size search, warmup and sampling all follow
the reference's threefry stream, so the runs are compared chain by chain:
gradient and failure counts exactly, floats to the stated tolerance.
Floats drift by summation order and the normals' last ulps (see
test_torch_prng.py) through 50 iterations of chaotic dynamics; the
funnel's draws are held to rtol 1e-9 with an absolute floor of 1e-9 for
draws near zero, the logistic regression's (float32 model) to atol 1e-4.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as wtt
from walnuts_tpu.models import funnel as jax_funnel
from walnuts_tpu.ops.pallas_kernels import logistic_regression_fused as jax_fused
from walnuts_tpu_torch.models import funnel
from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused


def _stack(outputs):
    return np.stack([np.asarray(c) for c in outputs])


def _run_both(jlogp, tlogp, **kw):
    kw = dict(return_info=True, save_inv_metric=True, **kw)
    jo, ji = wt.walnuts(jlogp, dtype=jnp.float64, **kw)
    to, ti = wtt.walnuts(tlogp, dtype=torch.float64, device="cpu", **kw)
    return jo, ji, to, ti


def _assert_counts_equal(ji, ti):
    assert ti.warmup_iters == ji.warmup_iters
    assert ti.sampling_iters == ji.sampling_iters
    np.testing.assert_array_equal(ti.n_grads, ji.n_grads)
    np.testing.assert_array_equal(ti.n_halve_fail, ji.n_halve_fail)
    np.testing.assert_array_equal(ti.n_nonfinite, ji.n_nonfinite)
    np.testing.assert_array_equal(ti.n_depth_exhausted, ji.n_depth_exhausted)


def test_funnel_matches_reference():
    jo, ji, to, ti = _run_both(
        jax_funnel(5)[0], funnel(5)[0], num_params=5, num_chains=4, seed=11,
        min_warmup_iter=15, max_warmup_iter=15, min_sampling_iter=15,
        max_sampling_iter=15)
    _assert_counts_equal(ji, ti)
    np.testing.assert_allclose(_stack(to), _stack(jo), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose([c.warmup.stepsize for c in to],
                               [c.warmup.stepsize for c in jo], rtol=1e-9)
    np.testing.assert_allclose(np.stack([c.warmup.inv_metric for c in to]),
                               np.stack([c.warmup.inv_metric for c in jo]),
                               rtol=1e-9)
    assert ti.rhat_trace and np.isfinite(ti.rhat_trace).all()


def test_fused_logreg_matches_reference():
    jo, ji, to, ti = _run_both(
        jax_fused(interpret=True)[0], logistic_regression_fused(device="cpu")[0],
        num_params=25, num_chains=2, seed=3, fused=True,
        min_warmup_iter=8, max_warmup_iter=8, min_sampling_iter=10,
        max_sampling_iter=10)
    _assert_counts_equal(ji, ti)
    draws = _stack(to)
    assert draws.shape == (2, 10, 25) and np.isfinite(draws).all()
    np.testing.assert_allclose(draws, _stack(jo), atol=1e-4)
    np.testing.assert_allclose([c.warmup.stepsize for c in to],
                               [c.warmup.stepsize for c in jo], rtol=1e-4)


def test_outputs_and_info_shape():
    out, info = wtt.walnuts(funnel(3)[0], num_params=3, num_chains=3, seed=1,
                            device="cpu", min_warmup_iter=6, max_warmup_iter=6,
                            min_sampling_iter=5, max_sampling_iter=5,
                            block_size=3, save_warmup=True, return_info=True,
                            checkpoint_every=1, checkpoint_keep_last_n=None,
                            resume=True)  # the checkpoint options' defaults
    assert len(out) == 3 and out[0].shape == (5, 3)
    assert out[0].dtype == np.float32  # the port's default dtype
    assert out[0].warmup.warmup_draws.shape == (6, 3)
    assert info.n_blocks == {"warmup": 2, "sampling": 2}
    assert info.n_syncs["sampling"] >= info.n_inner_trips["sampling"]


@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("batched_groups", 2),
    ("model_dtype", torch.float32), ("checkpoint_dir", "ckpt"),
    ("checkpoint_every", 5), ("checkpoint_keep_last_n", 2), ("resume", False),
    ("thin", 2),
    ("keep_dims", [0]), ("bf16_ends", True), ("flatten", True),
    ("chain_groups", 2), ("profile_dir", "prof"),
    ("min_latched", 1), ("defer_splits", False),
])
def test_unported_options_raise(option, value):
    with pytest.raises(NotImplementedError, match=option):
        wtt.walnuts(funnel(3)[0], num_params=3, device="cpu", **{option: value})


def test_unknown_option_is_a_type_error():
    with pytest.raises(TypeError, match="no_such_option"):
        wtt.walnuts(funnel(3)[0], num_params=3, device="cpu", no_such_option=1)


def test_import_loads_no_jax():
    code = (
        "import sys, walnuts_tpu_torch, walnuts_tpu_torch.convert, "
        "walnuts_tpu_torch.ops.logreg_fused, walnuts_tpu_torch.ops._cuda, "
        "walnuts_tpu_torch.ops.integrator, walnuts_tpu_torch.ops.fused_pass, "
        "walnuts_tpu_torch.models.kernels\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'walnuts_tpu'"
        " or m.startswith('walnuts_tpu.'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
