"""The port's Stan path (``models/stan.py`` and its native bridge), on the
CPU.

The port's mirror of ``tests/test_stan.py``: a fake BridgeStan model
(``csrc/fake_stan_model.cpp``, the bs_* C ABI of a small analytic model)
and the eight-schools ABI model (``csrc/abi_models.cpp``) stand in for
compiled Stan models. Every library is built by
``walnuts_tpu_torch.ops._cuda.build_host`` into ``build/walnuts_tpu_torch/``,
never into ``csrc/``; the JAX package's ``walnuts_stan`` is given the same
bridge and model libraries. Held against the JAX package: counts exact,
constrained draws to rtol 1e-9 in float64; the ABI eight schools against
the port's autograd ``eight_schools``: counts exact, ``mu`` to 1e-3 (the
reference's own tolerance).
"""

import numpy as np
import pytest
import torch

import walnuts_tpu.models.stan as jax_stan
import walnuts_tpu_torch as wtt
from walnuts_tpu_torch.models import eight_schools
from walnuts_tpu_torch.models.stan import StanBridge, build_bridge, walnuts_stan
from walnuts_tpu_torch.ops._cuda import BUILD_DIR, build_host

RUN = dict(seed=5, num_chains=2, min_warmup_iter=4, max_warmup_iter=4,
           min_sampling_iter=4, max_sampling_iter=4, block_size=2,
           save_inv_metric=True, save_warmup=True)


@pytest.fixture(scope="module")
def fake_so():
    return str(build_host("csrc/fake_stan_model.cpp"))


def stan(model, **kw):
    return walnuts_stan(model, dtype=torch.float64, device="cpu", **kw)


@pytest.fixture(scope="module")
def fake_run(fake_so):
    return stan(fake_so, return_info=True, **RUN)


def test_libraries_are_built_outside_csrc(fake_so):
    for path in (fake_so, build_bridge()):
        assert path.startswith(str(BUILD_DIR)), path


class TestStanBridge:
    def test_open_and_introspect(self, fake_so):
        b = StanBridge(fake_so)
        assert b.param_unc_num == 3
        assert b.param_num() == 3
        assert b.param_names() == ["mu", "sigma", "z"]
        b.close()

    def test_batched_logp_grad(self, fake_so):
        b = StanBridge(fake_so, n_threads=2)
        theta = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [1.0, 1.0, 1.0]])
        lp, grad = b.logp_grad_batch(theta)
        np.testing.assert_allclose(lp, [-0.5, -2.0, -1.5])
        np.testing.assert_allclose(grad, -theta)
        # into caller buffers: what the host model passes
        lp2, grad2 = np.empty(3), np.empty((3, 3))
        assert b.logp_grad_batch(theta, lp2, grad2)[0] is lp2
        np.testing.assert_array_equal(lp2, lp)
        np.testing.assert_array_equal(grad2, grad)
        with pytest.raises(ValueError, match="C-contiguous"):
            b.logp_grad_batch(theta, np.empty(3), np.empty((3, 3))[:, ::-1])
        b.close()

    def test_error_rows_become_neg_inf(self, fake_so):
        """A failing evaluation yields -inf and a zero gradient for that row
        only (load_stan.hpp:132-146)."""
        b = StanBridge(fake_so, data='{"bad_region": true}')
        lp, grad = b.logp_grad_batch(np.array([[3.0, 0.0, 0.0], [1.0, 0.0, 0.0]]))
        assert lp[0] == -np.inf
        np.testing.assert_array_equal(grad[0], 0.0)
        assert lp[1] == pytest.approx(-0.5)
        b.close()

    def test_constrain_batch(self, fake_so):
        b = StanBridge(fake_so)
        unc = np.array([[0.5, 0.0, -1.0], [0.0, 1.0, 2.0]])
        con = b.constrain_batch(unc)
        np.testing.assert_allclose(con[:, 0], unc[:, 0])
        np.testing.assert_allclose(con[:, 1], np.exp(unc[:, 1]))
        np.testing.assert_allclose(con[:, 2], unc[:, 2])
        b.close()

    def test_missing_library_raises(self):
        with pytest.raises(RuntimeError):
            StanBridge("/nonexistent/model.so")


def test_failed_host_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build_host(bad)


class TestWalnutsStan:
    def test_end_to_end(self, fake_run):
        out, info = fake_run
        assert len(out) == 2
        assert out[0].parameters == ["mu", "sigma", "z"]
        assert out[0].data.shape == (4, 3)
        assert out[0].warmup_data.shape == (4, 3)
        assert (out[0]["sigma"] > 0).all()  # the constrained scale
        assert out[0].stepsize > 0
        assert out[0].inv_metric.shape == (3,)
        assert info.sampling_iters == 4

    def test_matches_reference(self, fake_so, fake_run, monkeypatch):
        """The JAX package's walnuts_stan on the same model library, with
        the port's bridge: counts exact, constrained draws to rtol 1e-9."""
        monkeypatch.setattr(jax_stan, "build_bridge", build_bridge)
        jo, ji = jax_stan.walnuts_stan(fake_so, return_info=True, **RUN)
        to, ti = fake_run
        np.testing.assert_array_equal(ti.n_grads, ji.n_grads)
        np.testing.assert_array_equal(ti.n_halve_fail, ji.n_halve_fail)
        np.testing.assert_array_equal(ti.n_nonfinite, ji.n_nonfinite)
        assert to[0].parameters == jo[0].parameters
        for a, b in zip(to, jo):
            np.testing.assert_allclose(a.data, b.data, rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(a.warmup_data, b.warmup_data, rtol=1e-9,
                                       atol=1e-9)
            np.testing.assert_allclose(a.stepsize, b.stepsize, rtol=1e-9)

    def test_checkpoint_resume_and_model_object(self, fake_so, fake_run, tmp_path):
        """A checkpointed run is the plain one, and a call on the finished
        checkpoint returns the same constrained draws without sampling. The
        model is an object with a ``lib_path``, as a bridgestan.StanModel
        (the bridgestan package itself is not needed)."""

        class StubStanModel:
            lib_path = fake_so

        kw = dict(RUN, checkpoint_dir=str(tmp_path / "ck"))
        first = stan(StubStanModel(), **kw)
        second, info = stan(fake_so, return_info=True, **kw)
        assert info.seconds["warmup"] == 0.0  # restored, not run
        for a, b, c in zip(fake_run[0], first, second):
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_array_equal(b.data, c.data)

    def test_abi_eight_schools_matches_autograd(self):
        """The eight-schools ABI model (csrc/abi_models.cpp, the density of
        models.eight_schools) through the bridge and the port's autograd
        model, same seed: the same gradient counts, mu to 1e-3."""
        so = build_host("csrc/abi_models.cpp", defines=("ABI_MODEL_EIGHT_SCHOOLS",))
        kw = dict(seed=31, num_chains=2, min_warmup_iter=5, max_warmup_iter=5,
                  min_sampling_iter=5, max_sampling_iter=5, return_info=True)
        outs_ffi, info_ffi = stan(so, **kw)
        logp, dim = eight_schools(device="cpu")
        outs_ag, info_ag = wtt.walnuts(logp, num_params=dim, dtype=torch.float64,
                                       device="cpu", **kw)
        np.testing.assert_array_equal(info_ffi.n_grads, info_ag.n_grads)
        assert outs_ffi[0].parameters[:2] == ["mu", "tau"]
        assert (outs_ffi[0]["tau"] > 0).all()
        for o_f, o_a in zip(outs_ffi, outs_ag):
            np.testing.assert_allclose(o_f["mu"], np.asarray(o_a)[:, 0], rtol=1e-3,
                                       atol=1e-3)

    def test_iteration_contract(self, fake_so):
        out = stan(fake_so, seed=6, num_chains=2, min_warmup_iter=3,
                   max_warmup_iter=5, min_sampling_iter=4, max_sampling_iter=8,
                   block_size=2)
        assert 4 <= out[0].data.shape[0] <= 8

    def test_create_inits(self, fake_run):
        inits = fake_run[0][0].create_inits(seed=1, chains=3)
        assert len(inits) == 3
        assert set(inits[0].keys()) == {"mu", "sigma", "z"}

    def test_bad_model_type(self):
        with pytest.raises(TypeError):
            walnuts_stan(12345)

    def test_unknown_parameter_keyerror(self, fake_run):
        with pytest.raises(KeyError):
            fake_run[0][0]["nope"]


class TestInitDicts:
    @pytest.mark.parametrize("many", [True, False], ids=["per_chain", "single"])
    def test_constrained_init_dicts_unconstrained_via_model(self, fake_so, fake_run,
                                                            many):
        """Constrained init dicts (create_inits's, or one dict) are
        unconstrained through the model (stan.py:233-236)."""
        inits = (fake_run[0][0].create_inits(seed=2, chains=2) if many
                 else {"mu": 0.5, "sigma": 1.0, "z": -0.2})
        out = stan(fake_so, seed=10, num_chains=2, inits=inits, min_warmup_iter=2,
                   max_warmup_iter=2, min_sampling_iter=2, max_sampling_iter=2)
        assert len(out) == 2 and out[0].data.shape == (2, 3)
