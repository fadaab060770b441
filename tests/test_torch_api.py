"""The port's ``walnuts()`` against the JAX package's, end to end (CPU).

The configurations: funnel(5) through autograd in float64, alone and
with cost-sorted groups, thinning and a dimension subset; the fused
logistic regression (``fused=True``, a float32 model under a float64
sampler, as in ``tests/test_pallas.py``); and the stochastic-volatility
model in float32 under a float64 sampler and in float64 under a float32
one (``model_dtype``). Seeds, keys, initial
positions, the initial step-size search, warmup and sampling all follow
the reference's threefry stream, so the runs are compared chain by chain:
gradient and failure counts exactly, floats to the stated tolerance.
Floats drift by summation order and the normals' last ulps (see
test_torch_prng.py) through 50 iterations of chaotic dynamics; the
funnel's draws are held to rtol 1e-9 with an absolute floor of 1e-9 for
draws near zero, the float32 models' (logistic regression, stochastic
volatility) to atol 1e-4.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import walnuts_tpu as wt
import walnuts_tpu_torch as wtt
from walnuts_tpu.models import funnel as jax_funnel
from walnuts_tpu.models import stochastic_volatility as jax_sv
from walnuts_tpu.ops.pallas_kernels import logistic_regression_fused as jax_fused
from walnuts_tpu_torch.models import funnel, stochastic_volatility
from walnuts_tpu_torch.ops.logreg_fused import logistic_regression_fused


def _stack(outputs):
    return np.stack([np.asarray(c) for c in outputs])


def _run_both(jlogp, tlogp, jax_kw=None, torch_kw=None, **kw):
    kw = dict(return_info=True, save_inv_metric=True, **kw)
    jo, ji = wt.walnuts(jlogp, dtype=jnp.float64, **kw, **(jax_kw or {}))
    to, ti = wtt.walnuts(tlogp, dtype=torch.float64, device="cpu", **kw,
                         **(torch_kw or {}))
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


_GROUPS_KW = dict(num_params=5, num_chains=4, seed=11, min_warmup_iter=2,
                  max_warmup_iter=2, min_sampling_iter=4, max_sampling_iter=4,
                  block_size=2, thin=2, keep_dims=(0, 2))


@pytest.fixture(scope="module")
def funnel_groups():
    """funnel(5) in 2 cost-sorted groups (re-sorted every block of 2) with
    thinning and a dimension subset: the reference's run, the port's, and
    the port's in one group."""
    jo, ji, to, ti = _run_both(jax_funnel(5)[0], funnel(5)[0], batched_groups=2,
                               **_GROUPS_KW)
    one, i1 = wtt.walnuts(funnel(5)[0], dtype=torch.float64, device="cpu",
                          return_info=True, **_GROUPS_KW)
    return jo, ji, to, ti, one, i1


def test_groups_thin_keep_dims_match_reference(funnel_groups):
    """Groups in warmup and sampling, thinning and a dimension subset: the
    draws kept are the reference's, the counts exact."""
    jo, ji, to, ti, _, _ = funnel_groups
    _assert_counts_equal(ji, ti)
    assert _stack(to).shape == (4, 2, 2)
    np.testing.assert_allclose(_stack(to), _stack(jo), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose([c.warmup.stepsize for c in to],
                               [c.warmup.stepsize for c in jo], rtol=1e-9)


def test_groups_are_bitwise_on_funnel(funnel_groups):
    """Groups only schedule: on a model without a matrix product the draws
    and gradient counts of 1 and 2 groups are bitwise equal."""
    _, _, two, i2, one, i1 = funnel_groups
    np.testing.assert_array_equal(_stack(one), _stack(two))
    np.testing.assert_array_equal(i1.n_grads, i2.n_grads)
    assert i2.n_blocks == i1.n_blocks


def test_sv_model_dtype_matches_reference():
    """The stochastic-volatility model in float32 under a float64 sampler
    (precision islands): counts exact; draws to atol 1e-4, the float32
    model's own tolerance in this file. At 4 + 4 iterations the JAX
    package counts one non-finite step more on one chain at equal gradient
    counts: its jitted float32 model is NaN where tanh saturates, the
    port's finite (test_torch_targets.py::
    test_sv_f32_finite_where_tanh_saturates)."""
    jo, ji, to, ti = _run_both(
        jax_sv(13)[0], stochastic_volatility(13, device="cpu")[0], num_params=16,
        num_chains=4, seed=5, init_radius=0.2, min_warmup_iter=6,
        max_warmup_iter=6, min_sampling_iter=6, max_sampling_iter=6,
        jax_kw=dict(model_dtype=jnp.float32), torch_kw=dict(model_dtype=torch.float32))
    _assert_counts_equal(ji, ti)
    draws = _stack(to)
    assert draws.dtype == np.float64 and np.isfinite(draws).all()
    np.testing.assert_allclose(draws, _stack(jo), atol=1e-4)


def test_sv_wide_model_dtype_matches_reference(monkeypatch):
    """The stochastic-volatility model in float64 under a float32 sampler:
    the log densities stay float64 (the saved warmup's), the draws are
    float32, and the run is the reference's chain by chain (counts exact,
    floats to atol 1e-4). A trajectory's direction bit compares a uniform
    of the canonical float width with 0.5 in the reference: float64 under
    x64 (this test session), float32 without it (its TPU configuration).
    The port compares a uniform of the sampler's dtype, so the reference
    is run here with the float32 comparison."""
    bernoulli = jax.random.bernoulli
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None:
                        bernoulli(key, jnp.float32(p), shape))
    kw = dict(num_params=16, num_chains=4, seed=5, init_radius=0.2,
              min_warmup_iter=4, max_warmup_iter=4, min_sampling_iter=4,
              max_sampling_iter=4, save_warmup=True, return_info=True)
    jo, ji = wt.walnuts(jax_sv(13)[0], dtype=jnp.float32, model_dtype=jnp.float64, **kw)
    to, ti = wtt.walnuts(stochastic_volatility(13, device="cpu")[0],
                         dtype=torch.float32, model_dtype=torch.float64,
                         device="cpu", **kw)
    _assert_counts_equal(ji, ti)
    draws = _stack(to)
    assert draws.dtype == np.float32 and np.isfinite(draws).all()
    np.testing.assert_allclose(draws, _stack(jo), atol=1e-4)
    lps = np.stack([c.warmup.warmup_logps for c in to])
    assert lps.dtype == np.float64 and np.isfinite(lps).all()
    np.testing.assert_allclose(lps, np.stack([c.warmup.warmup_logps for c in jo]),
                               atol=1e-4)


@pytest.mark.parametrize("kw,match", [
    (dict(batched=False, batched_groups=2), "batched_groups requires batched"),
    (dict(num_chains=5, batched_groups=2), "must divide by batched_groups"),
    (dict(thin=0), "thin"),
    (dict(thin=4, block_size=10), "divide block_size"),
    (dict(mesh=object()), "mesh"),  # not a one-dimensional DeviceMesh
])
def test_reference_refusals(kw, match):
    kw = dict(dict(num_chains=4), **kw)
    with pytest.raises(ValueError, match=match):
        wtt.walnuts(funnel(3)[0], num_params=3, device="cpu", **kw)


def test_unknown_option_is_a_type_error():
    with pytest.raises(TypeError, match="no_such_option"):
        wtt.walnuts(funnel(3)[0], num_params=3, device="cpu", no_such_option=1)


def test_profile_dir_writes_a_trace(tmp_path):
    """profile_dir: a torch.profiler Chrome trace of the run, naming the
    run's operations."""
    wtt.walnuts(funnel(3)[0], num_params=3, num_chains=1, seed=1, device="cpu",
                min_warmup_iter=1, max_warmup_iter=1, min_sampling_iter=1,
                max_sampling_iter=1, profile_dir=str(tmp_path / "prof"))
    traces = list((tmp_path / "prof").glob("walnuts-*.pt.trace.json"))
    assert len(traces) == 1
    assert "aten::" in traces[0].read_text()


@pytest.fixture(scope="module")
def fresh_process(tmp_path_factory):
    """One new interpreter that imports every module of the port, runs
    ``python -m walnuts_tpu_torch.cli`` in it (``runpy``, as ``-m`` does)
    on the CPU, and prints the JAX modules loaded after both: its output,
    the CLI's exit code, and the ``--out`` file."""
    out = tmp_path_factory.mktemp("cli") / "draws.npz"
    argv = ["walnuts_tpu_torch.cli", "--model", "funnel", "--dim", "3", "--chains",
            "2", "--warmup", "3", "--sampling", "4", "--seed", "2", "--device",
            "cpu", "--out", str(out)]
    code = (
        "import json, runpy, sys, walnuts_tpu_torch, walnuts_tpu_torch.convert, "
        "walnuts_tpu_torch.ops.logreg_fused, walnuts_tpu_torch.ops._cuda, "
        "walnuts_tpu_torch.ops.integrator, walnuts_tpu_torch.ops.fused_pass, "
        "walnuts_tpu_torch.models.kernels, walnuts_tpu_torch.models.targets, "
        "walnuts_tpu_torch.summary_device, walnuts_tpu_torch.parity, "
        "walnuts_tpu_torch.models.stan, walnuts_tpu_torch.parallel.checkpoint\n"
        "from walnuts_tpu_torch import BlockCheckpointer, walnuts_pyfunc, "
        "walnuts_stan\n"
        f"sys.argv = {argv!r}\n"
        "try:\n"
        "    runpy.run_module('walnuts_tpu_torch.cli', run_name='__main__', "
        "alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'walnuts_tpu'"
        " or m.startswith('walnuts_tpu.'))\n"
        "print('JAX_MODULES', json.dumps(bad), rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                          capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parents[1])
    return proc.stdout, out


def test_cli_samples_on_the_cpu(fresh_process):
    """python -m walnuts_tpu_torch.cli: exit 0, the summary table and the
    built-in profile, and the draws written with --out."""
    stdout, out = fresh_process
    lines = stdout.splitlines()
    assert lines[0].split() == ["parameter", "mean", "sd", "mcse", "ess", "rhat"]
    assert [ln.split()[0] for ln in lines[1:4]] == ["theta[0]", "theta[1]", "theta[2]"]
    assert "gradient evaluations:" in stdout
    assert lines[-1].split()[-1] == "0"  # the CLI's exit code
    assert np.load(out)["draws"].shape == (2, 4, 3)


def test_import_loads_no_jax(fresh_process):
    """No module of the port, its entry points and its CLI run included,
    loads JAX or the JAX package."""
    last = fresh_process[0].splitlines()[-1].split(" ", 1)
    assert last[0] == "JAX_MODULES"
    assert last[1].rsplit(" ", 1)[0] == "[]", last[1]
