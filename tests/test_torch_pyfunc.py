"""The port's ``walnuts_pyfunc`` (a model evaluated on the host), on the
CPU.

The port's mirror of ``tests/test_pyfunc.py``: plain Python callables,
the numba-style ``.ctypes`` attribute and the ``(ctypes_cfunc, data)``
tuple of the ``RawLogpFunc`` C signature (``csrc/callback_model.c``, built
with ``gcc`` into ``build/walnuts_tpu_torch/``), and the trap of a raising
callable or an error code. Held against the JAX package's
``walnuts_pyfunc``: counts exact, draws to rtol 1e-9 in float64.
"""

import ctypes

import numpy as np
import pytest
import torch

import walnuts_tpu.api as jax_api
from walnuts_tpu_torch import walnuts_pyfunc
from walnuts_tpu_torch.ops._cuda import build_host

KW = dict(num_params=3, num_chains=2, seed=4, min_warmup_iter=5, max_warmup_iter=5,
          min_sampling_iter=5, max_sampling_iter=5)
SHORT = dict(min_warmup_iter=3, max_warmup_iter=3, min_sampling_iter=3,
             max_sampling_iter=3)


def py_logp(theta):
    return -0.5 * float(theta @ theta), -theta


def pyfunc(logp, **kw):
    return walnuts_pyfunc(logp, dtype=torch.float64, device="cpu", **{**KW, **kw})


def stack(out):
    return np.stack([np.asarray(c) for c in out])


@pytest.fixture(scope="module")
def cb_lib():
    """A standard normal in the RawLogpFunc C signature; ``data`` carries
    an inverse variance. ``logp_fail`` always returns an error code."""
    lib = ctypes.CDLL(str(build_host("csrc/callback_model.c")))
    proto = ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.c_size_t, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_void_p)
    return proto(("logp_cb", lib)), proto(("logp_fail", lib))


@pytest.fixture(scope="module")
def py_run():
    return pyfunc(py_logp, return_info=True)


def test_plain_callable(py_run):
    draws = stack(py_run[0])
    assert draws.shape == (2, 5, 3) and draws.dtype == np.float64
    assert np.isfinite(draws).all()


def test_matches_reference(py_run):
    """The JAX package's walnuts_pyfunc on the same callable: counts
    exact, draws to rtol 1e-9."""
    jo, ji = jax_api.walnuts_pyfunc(py_logp, return_info=True, **KW)
    to, ti = py_run
    np.testing.assert_array_equal(ti.n_grads, ji.n_grads)
    np.testing.assert_array_equal(ti.n_halve_fail, ji.n_halve_fail)
    np.testing.assert_array_equal(ti.n_nonfinite, ji.n_nonfinite)
    np.testing.assert_allclose(stack(to), stack(jo), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose([c.warmup.stepsize for c in to],
                               [c.warmup.stepsize for c in jo], rtol=1e-9)


def test_raising_callable_traps_to_rejection():
    def bad(theta):
        if theta[0] > 0.2:
            raise RuntimeError("boom")
        return -0.5 * float(theta @ theta), -theta

    assert np.isfinite(stack(pyfunc(bad, **SHORT))).all()


def test_cfunc_attribute_matches_python(cb_lib, py_run):
    """Anything carrying .ctypes (the numba @cfunc duck type) is called
    directly: the same model and seed as the plain callable, the same
    draws."""
    cfunc, _ = cb_lib

    class FakeNumbaCfunc:
        ctypes = cfunc

    np.testing.assert_allclose(stack(pyfunc(FakeNumbaCfunc())), stack(py_run[0]),
                               rtol=1e-6, atol=1e-7)


def test_ctypes_tuple_data_argument(cb_lib):
    """(cfunc, data): data rides through as the void* argument, inverse
    variance 4 is the Python model with inverse variance 4, draw for
    draw."""
    cfunc, _ = cb_lib
    out_c = pyfunc((cfunc, ctypes.c_double(4.0)), **SHORT)
    out_p = pyfunc(lambda t: (-2.0 * float(t @ t), -4.0 * t), **SHORT)
    np.testing.assert_allclose(stack(out_c), stack(out_p), rtol=1e-6, atol=1e-7)


def test_error_code_traps_to_rejection(cb_lib):
    _, fail = cb_lib
    draws = stack(pyfunc((fail, None), **SHORT))
    # every evaluation fails: the chains never move, but stay finite
    assert np.isfinite(draws).all()
    assert (draws == draws[:, :1]).all()
