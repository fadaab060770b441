"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips. The file imports no JAX, so it also runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_gpu.py -q`` (``--noconftest`` keeps the suite's JAX setup
out). The replay kernel is integer arithmetic and must be bitwise equal;
the logistic-regression kernel sums in another order than the plain
version's matrix products, so it is held to ``tests/test_pallas.py``'s
float32 tolerances. The fused tier-2 pass kernel is held to its plain
version on the same synthetic lane states: integers, flags and keys equal
on every lane; rows to a few ulp (the restart's normals run the same
polynomial, rounded step by step on both sides); per-lane floats to rtol
1e-5 / atol 1e-4 in float32 (1e-10 in float64), because the momentum
energy of a restart is a warp sum in the kernel and PyTorch's reduction in
the plain version. The fused integrator is held to ``integrate_plain`` on
the card: zero-step lanes bitwise; the simple bodies repeat the plain
version's arithmetic product by product (``-fmad=false``) and differ by the
order of their feature sums only (float32 rtol 1e-4 / atol 1e-4, float64
1e-9 over up to 256 steps); the logistic-regression body sums its 1000-row
products in another order than the plain version's matrix products (rtol
1e-3 / atol 5e-3). The whole-transition kernels are held to their plain
versions chain by chain: the decision uniforms are the same hash on both
sides, so ``depth`` and ``n_grads`` must be equal on at least 0.98 of the
chains (a chain whose energy error sits at ``max_error`` may take another
branch through the last bits of ``exp`` / ``log`` or the order of a sum),
and on those chains theta, grad and logp agree within rtol 1e-3 / atol 5e-3
(the funnel rtol 5e-3: its gradients reach the hundreds in the neck, and
over 8 draws at D = 300 the order of a feature sum grew to 1.4e-3 of an
entry on one of 30000).
"""

import numpy as np
import pytest
import torch

from walnuts_tpu_torch.config import SamplingConfig, WarmupConfig
from walnuts_tpu_torch.convert import (
    key_data_torch,
    lane_state_from_fields,
    logreg_tensors,
)
from walnuts_tpu_torch.core.sampler import (
    freeze_params,
    init_sample_state,
    init_warmup_state,
)
from walnuts_tpu_torch.models import kernels
from walnuts_tpu_torch.models.targets import logistic_regression_data
from walnuts_tpu_torch.ops import fused_pass as fp
from walnuts_tpu_torch.ops import fused_transition as ft
from walnuts_tpu_torch.ops import integrator as integ
from walnuts_tpu_torch.ops import prng
from walnuts_tpu_torch.ops.logreg_fused import (
    logistic_regression_fused,
    logreg_value_grad,
    logreg_value_grad_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _replay_inputs(c, seed):
    rng = np.random.default_rng(seed)
    kd = rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.uint32)
    ku = rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.uint32)
    n_ends = rng.integers(0, 13, size=c).astype(np.int32)
    leaf_end_at = (rng.random(c) * (n_ends + 1)).astype(np.int32)
    return (key_data_torch(kd), key_data_torch(ku), torch.from_numpy(n_ends),
            torch.from_numpy(leaf_end_at))


@pytest.mark.parametrize("c", [1, 100, 4096])
def test_replay_kernel_bitwise_vs_plain(cuda, c):
    args = _replay_inputs(c, c)
    want = prng.replay_split_chain_plain(*args)
    before = prng.replay_split_chain.launches
    got = prng.replay_split_chain(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    assert prng.replay_split_chain.launches == before + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_replay_kernel_refuses_bad_input(cuda):
    k, ku, n, at = (a.to(cuda) for a in _replay_inputs(8, 1))
    with pytest.raises(ValueError, match="n_ends"):
        prng.replay_split_chain(k, ku, n.long(), at)
    with pytest.raises(ValueError, match="key_data"):
        prng.replay_split_chain(k.t().contiguous().t(), ku, n, at)


@pytest.mark.parametrize("b", [1, 37, 4096])
def test_logreg_kernel_vs_plain(cuda, b):
    design, y = logistic_regression_data()
    x_t, y_t = logreg_tensors(design, y, cuda)
    rng = np.random.default_rng(b)
    theta = torch.from_numpy((0.3 * rng.standard_normal((b, 25))).astype(np.float32))
    lp_p, g_p = logreg_value_grad_plain(theta.to(cuda), x_t, y_t)
    before = logreg_value_grad.launches
    lp_k, g_k = logreg_value_grad(theta.to(cuda), x_t, y_t)
    torch.cuda.synchronize()
    assert logreg_value_grad.launches == before + 1
    np.testing.assert_allclose(lp_k.cpu().numpy(), lp_p.cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(),
                               rtol=1e-4, atol=2e-3)


def test_logreg_kernel_other_widths(cuda):
    """Feature counts 1..32 and row counts beyond one staged chunk."""
    for n, p in ((50, 1), (1500, 32), (3000, 7)):
        design, y = logistic_regression_data(n, p, 3)
        x_t, y_t = logreg_tensors(design, y, cuda)
        theta = 0.2 * torch.randn((70, p), device=cuda)
        lp_p, g_p = logreg_value_grad_plain(theta, x_t, y_t)
        lp_k, g_k = logreg_value_grad(theta, x_t, y_t)
        torch.cuda.synchronize()
        np.testing.assert_allclose(lp_k.cpu().numpy(), lp_p.cpu().numpy(), rtol=1e-5)
        np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(),
                                   rtol=1e-4, atol=2e-3 * n / 1000)


def test_logreg_kernel_refuses_bad_input(cuda):
    design, y = logistic_regression_data()
    x_t, y_t = logreg_tensors(design, y, cuda)
    theta = torch.zeros((4, 25), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        logreg_value_grad(theta.double(), x_t, y_t)
    with pytest.raises(ValueError, match="features"):
        wide = torch.zeros((4, 33), device=cuda)
        logreg_value_grad(wide, torch.zeros((10, 33), device=cuda), y_t[:10])


def test_fused_model_on_the_card_is_a_float32_island(cuda):
    fused, dim = logistic_regression_fused(device=cuda)
    theta = 0.1 * torch.randn((9, dim), dtype=torch.float64, device=cuda)
    lp, g = fused(theta)
    assert lp.dtype == torch.float64 and g.device.type == "cuda"
    assert torch.isfinite(lp).all() and torch.isfinite(g).all()


def _pass_inputs(c, d, max_depth, r, seed, device, dtype):
    fields, p = fp.synthetic_pass_inputs(c, d, max_depth, r, seed)
    st = lane_state_from_fields(fields, dtype, device)
    step = torch.tensor(p["step"], dtype=dtype, device=device)
    inv_mass = torch.tensor(p["inv_mass"], dtype=dtype, device=device)
    min_micro = torch.tensor(p["min_micro"], device=device)
    out = (torch.zeros((r, c, d), dtype=dtype, device=device),
           torch.zeros((r, c), dtype=dtype, device=device),
           torch.zeros((r, c), dtype=torch.int32, device=device))
    return st, (step, inv_mass, min_micro), out


@pytest.mark.parametrize(
    "c,d,dtype",
    [(c, d, torch.float32) for c in (1, 100, 4096) for d in (25, 101)]
    + [(100, d, torch.float64) for d in (25, 101)])
def test_fused_pass_kernel_vs_plain(cuda, c, d, dtype):
    max_depth, r, cap = 5, 6, 5
    seed = c + d
    st_k, params, out_k = _pass_inputs(c, d, max_depth, r, seed, cuda, dtype)
    st_p, _, out_p = _pass_inputs(c, d, max_depth, r, seed, cuda, dtype)
    before = fp.fused_pass.launches
    fp.fused_pass(st_k, *params, cap, r, max_depth, out_k)
    torch.cuda.synchronize()
    assert fp.fused_pass.launches == before + 1
    fp.fused_pass_plain(st_p, *params, cap, r, max_depth, out_p)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    row_tol = dict(rtol=2e-6, atol=1e-6) if f32 else dict(rtol=1e-12, atol=1e-12)
    lane_tol = dict(rtol=1e-5, atol=1e-4) if f32 else dict(rtol=1e-10, atol=1e-10)
    for name in fp.RW_FIELDS:
        k = fp.lane_field(st_k, name).cpu().numpy()
        p = fp.lane_field(st_p, name).cpu().numpy()
        if k.dtype.kind != "f":
            np.testing.assert_array_equal(k, p, err_msg=name)
        else:
            tol = lane_tol if k.ndim == 1 else row_tol
            np.testing.assert_allclose(k, p, err_msg=name, **tol)
    # the banked draws, log densities and depths
    np.testing.assert_array_equal(out_k[2].cpu().numpy(), out_p[2].cpu().numpy())
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_p[0].cpu().numpy(),
                               **row_tol)
    np.testing.assert_allclose(out_k[1].cpu().numpy(), out_p[1].cpu().numpy(),
                               **lane_tol)
    if c > 1:
        assert (out_k[2].cpu().numpy() > 0).any()  # some lanes banked


def test_fused_pass_kernel_refuses_bad_input(cuda):
    st, (step, im, mm), out = _pass_inputs(8, 25, 5, 6, 1, cuda, torch.float32)
    with pytest.raises(ValueError, match="inv_mass"):
        fp.fused_pass(st, step, im.double(), mm, 5, 6, 5, out)
    with pytest.raises(ValueError, match="step"):
        fp.fused_pass(st, step.cpu(), im, mm, 5, 6, 5, out)
    with pytest.raises(ValueError, match="share memory"):
        fp.fused_pass(st._replace(cur_th=st.ms_th), step, im, mm, 5, 6, 5, out)
    with pytest.raises(ValueError, match="draws"):
        fp.fused_pass(st, step, im, mm, 5, 7, 5, out)  # R disagrees with out


def test_run_sampling_fused_route_on_card(cuda):
    """Both routes of run_sampling on the card from one state: the fused
    route launches the kernel once per tier-2 pass and gives finite draws
    (a few chains may part ways with the unfused route through summation
    order, so the two are not compared)."""
    from walnuts_tpu_torch.models import funnel
    from walnuts_tpu_torch.ops.math import make_logp_grad
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    c, dim = 256, 11
    lg = make_logp_grad(funnel(dim)[0])
    wcfg = WarmupConfig(min_iter=0, max_iter=0, block_size=10)
    scfg = SamplingConfig(min_iter=20, max_iter=20, block_size=10,
                          max_step_halvings=6)
    keys = prng.fold_in(prng.key(3, cuda), torch.arange(c, device=cuda))
    theta = prng.normal(prng.key(4, cuda), (c, dim), torch.float32)
    ws = init_warmup_state(keys, theta, torch.ones_like(theta),
                           torch.full((c,), 0.3, device=cuda), wcfg, scfg)
    params, ss = freeze_params(ws), init_sample_state(ws)
    before = fp.fused_pass.launches
    _, d_f, l_f, info = run_sampling(lg, ss, params, scfg, pallas_pass=True)
    torch.cuda.synchronize()
    assert fp.fused_pass.launches - before == info.n_outer_trips["sampling"] > 0
    _, d_u, _, _ = run_sampling(lg, ss, params, scfg)
    assert d_f.shape == d_u.shape == (20, c, dim)
    assert torch.isfinite(d_f).all() and torch.isfinite(l_f).all()


# body -> (factory, input scales, dtypes)
_INTEGRATOR_CASES = {
    "std_normal": (lambda dev: kernels.std_normal_vg(100), {},
                   (torch.float32, torch.float64)),
    "funnel": (lambda dev: kernels.funnel_vg(101),
               dict(theta_scale=0.5, dt_range=(0.01, 0.05)),
               (torch.float32, torch.float64)),
    "ill_conditioned_normal": (
        lambda dev: kernels.ill_conditioned_normal_vg(100, device=dev), {},
        (torch.float32, torch.float64)),
    "wide_normal": (lambda dev: kernels.ill_conditioned_normal_vg(300, device=dev),
                    {}, (torch.float32, torch.float64)),
    "logistic_regression": (
        lambda dev: kernels.logistic_regression_vg(device=dev),
        dict(theta_scale=0.3, inv_mass_scale=0.005, dt_range=(0.05, 0.2)),
        (torch.float32,)),
}


@pytest.mark.parametrize("c", [1, 100, 4096])
@pytest.mark.parametrize("body", sorted(_INTEGRATOR_CASES))
def test_integrator_kernel_vs_plain(cuda, body, c):
    factory, scales, dtypes = _INTEGRATOR_CASES[body]
    model = factory(cuda)
    vg, dim, _ = model
    for dtype in dtypes:
        inp = integ.synthetic_attempt_inputs(c, dim, c + dim, **scales)
        if c > 1:
            inp["n_steps"][:2] = [0, 256]
        args = integ.attempt_tensors(vg, inp, dtype, cuda)
        fused = integ.make_fused_integrator(model)
        cur_k, lp_k = fused(*args)
        torch.cuda.synchronize()
        assert fused.launches == 1
        cur_p, lp_p = integ.integrate_plain(vg, *args)
        zero = args[3] == 0
        assert torch.equal(cur_k[zero], args[0][zero])
        assert bool((lp_k[zero] == float("-inf")).all())
        if body == "logistic_regression":
            tol = dict(rtol=1e-3, atol=5e-3)
        elif dtype == torch.float32:
            tol = dict(rtol=1e-4, atol=1e-4)
        else:
            tol = dict(rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(cur_k.cpu().numpy(), cur_p.cpu().numpy(), **tol)
        np.testing.assert_allclose(lp_k[~zero].cpu().numpy(),
                                   lp_p[~zero].cpu().numpy(), **tol)


def test_integrator_kernel_refuses_bad_input(cuda):
    model = kernels.std_normal_vg(5)
    inp = integ.synthetic_attempt_inputs(8, 5, 1, max_steps=4)
    cur, im, dt, n = integ.attempt_tensors(model[0], inp, torch.float32, cuda)
    fused = integ.make_fused_integrator(model)
    with pytest.raises(ValueError, match="n_steps"):
        fused(cur, im, dt, n.long())
    with pytest.raises(ValueError, match="inv_mass"):
        fused(cur, im.cpu(), dt, n)
    with pytest.raises(ValueError, match="cur"):
        fused(cur.transpose(0, 1).contiguous().transpose(0, 1), im, dt, n)
    # a value-and-gradient with no device body raises on the card
    other = kernels.BatchedVG(model[0].fn, "mine", 5)
    with pytest.raises(ValueError, match="no device body"):
        integ.make_fused_integrator(other)(cur, im, dt, n)
    assert fused.launches == 0


def test_run_sampling_classic_with_integrator_on_card(cuda):
    """The classic sampler on the card with the kernel: one launch per
    attempt, finite draws, and the plain route's draws on nearly every
    lane (a lane may part ways through the order of a feature sum)."""
    from walnuts_tpu_torch.models import funnel
    from walnuts_tpu_torch.ops.math import make_logp_grad
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    c, dim = 256, 11
    lg = make_logp_grad(funnel(dim)[0])
    wcfg = WarmupConfig(min_iter=0, max_iter=0, block_size=10)
    scfg = SamplingConfig(min_iter=10, max_iter=10, block_size=10,
                          max_step_halvings=6)
    keys = prng.fold_in(prng.key(3, cuda), torch.arange(c, device=cuda))
    theta = prng.normal(prng.key(4, cuda), (c, dim), torch.float32)
    ws = init_warmup_state(keys, theta, torch.ones_like(theta),
                           torch.full((c,), 0.3, device=cuda), wcfg, scfg)
    params, ss = freeze_params(ws), init_sample_state(ws)
    fused = integ.make_fused_integrator(kernels.funnel_vg(dim))
    _, d_k, l_k, info = run_sampling(lg, ss, params, scfg, batched=False,
                                     integrator=fused)
    torch.cuda.synchronize()
    assert fused.launches == info.n_outer_trips["sampling"] > 0
    _, d_p, _, _ = run_sampling(lg, ss, params, scfg, batched=False)
    assert d_k.shape == d_p.shape == (10, c, dim)
    assert torch.isfinite(d_k).all() and torch.isfinite(l_k).all()
    same = torch.isclose(d_k, d_p, rtol=1e-3, atol=1e-3).all(-1).all(0)
    assert same.float().mean() > 0.9


def test_integrator_kernel_as_before_the_shared_leapfrog_header(cuda):
    """The leapfrog loop moved into ``csrc/leapfrog.cuh``, which the
    transition kernels share. At C = 4096 and 0..256 steps the simple
    bodies still equal the plain version bit for bit in float32, and the
    logistic-regression body stays within the 1.160e-03 largest absolute
    difference it had before the move (NVIDIA H100 80GB HBM3)."""
    for body in ("std_normal", "funnel", "ill_conditioned_normal",
                 "logistic_regression"):
        factory, scales, _ = _INTEGRATOR_CASES[body]
        model = factory(cuda)
        vg, dim, _ = model
        args = integ.attempt_tensors(
            vg, integ.synthetic_attempt_inputs(4096, dim, 2029, **scales),
            torch.float32, cuda)
        cur_k, lp_k = integ.make_fused_integrator(model)(*args)
        cur_p, lp_p = integ.integrate_plain(vg, *args)
        torch.cuda.synchronize()
        moved = args[3] > 0
        if body == "logistic_regression":
            err = max(float((cur_k - cur_p).abs().max()),
                      float((lp_k - lp_p)[moved].abs().max()))
            assert err <= 1.2e-3
        else:
            assert torch.equal(cur_k, cur_p)
            assert torch.equal(lp_k[moved], lp_p[moved])


# model -> (factory, input scales)
_TRANSITION_CASES = {
    "std_normal": (lambda d, dev: kernels.std_normal_vg(d),
                   dict(step_range=(0.2, 0.8))),
    "funnel": (lambda d, dev: kernels.funnel_vg(d),
               dict(theta_scale=0.5, step_range=(0.05, 0.3))),
    "ill_conditioned_normal": (
        lambda d, dev: kernels.ill_conditioned_normal_vg(d, device=dev),
        dict(step_range=(0.2, 0.8))),
    "logistic_regression": (
        lambda d, dev: kernels.logistic_regression_vg(
            1000 if d == 25 else 200, d, device=dev),
        dict(theta_scale=0.3, inv_mass_scale=0.005, step_range=(0.3, 1.0))),
}
_TRANSITION_TOL = dict(rtol=1e-3, atol=5e-3)


@pytest.mark.parametrize("num_draws", [None, 1, 8], ids=("5a", "5b-1", "5b-8"))
@pytest.mark.parametrize("body,dim", [
    (b, d) for b in ("std_normal", "funnel", "ill_conditioned_normal")
    for d in (25, 101, 300)] + [("logistic_regression", 25),
                                ("logistic_regression", 7)])
def test_transition_kernels_vs_plain(cuda, body, dim, num_draws):
    """100 chains: no multiple of the 8 chains (logistic regression: 32) a
    block takes."""
    c, md, mh = 100, 5, 6
    factory, scales = _TRANSITION_CASES[body]
    model = factory(dim, cuda)
    vg = model[0]
    t = ft.transition_tensors(vg, ft.synthetic_transition_inputs(
        c, dim, c + dim, num_draws=num_draws or 1, **scales), cuda)
    tail = (t["step"], t["inv_mass"], t["min_micro"], 0.5)
    if num_draws is None:
        fused = ft.make_fused_transition(model, dim, md, mh)
        args = (-5, t["theta"], t["rho"][0].contiguous(), t["logp0"], t["grad0"],
                *tail)
        want = ft.fused_transition_plain(vg, *args, max_depth=md,
                                         max_step_halvings=mh)
        ints, floats = (3, 4), (0, 1, 2)
    else:
        fused = ft.make_fused_sample_block(model, dim, md, mh, num_draws)
        args = (-5, t["theta"], t["logp0"], t["grad0"], t["rho"], *tail)
        want = ft.fused_sample_block_plain(vg, *args, max_depth=md,
                                           max_step_halvings=mh)
        ints, floats = (5,), (0, 1, 2, 3, 4)
    got = fused(*args)
    torch.cuda.synchronize()
    assert fused.launches == 1
    same = torch.ones(c, dtype=torch.bool, device=cuda)
    for i in ints:
        assert got[i].dtype == torch.int32
        same &= got[i] == want[i]
    assert same.float().mean() >= 0.98
    assert int(want[ints[-1]].max()) > int(want[ints[-1]].min())  # chains differ
    for i in floats:
        g, w = (x[i].movedim(1, 0) if num_draws and i < 2 else x[i]
                for x in (got, want))
        tol = dict(_TRANSITION_TOL, rtol=5e-3) if body == "funnel" else _TRANSITION_TOL
        np.testing.assert_allclose(g[same].cpu().numpy(), w[same].cpu().numpy(),
                                   **tol)
    if num_draws:
        assert torch.equal(got[0][-1], got[2])  # the last draw is the final point


def test_transition_kernels_refuse_bad_input(cuda):
    model = kernels.std_normal_vg(5)
    t = ft.transition_tensors(model[0], ft.synthetic_transition_inputs(8, 5, 1), cuda)
    args = [0, t["theta"], t["rho"][0].contiguous(), t["logp0"], t["grad0"],
            t["step"], t["inv_mass"], t["min_micro"], 0.5]
    fused = ft.make_fused_transition(model, 5, 5, 5)
    with pytest.raises(ValueError, match="min_micro"):
        fused(*args[:7], t["min_micro"].long(), 0.5)
    with pytest.raises(ValueError, match="inv_mass"):
        fused(*args[:6], t["inv_mass"].cpu(), *args[7:])
    with pytest.raises(ValueError, match="float32"):
        fused(0, t["theta"].double(), *args[2:])
    # a value-and-gradient with no device body raises on the card
    other = kernels.BatchedVG(model[0].fn, "mine", 5)
    with pytest.raises(ValueError, match="no device body"):
        ft.make_fused_transition(other, 5, 5, 5)(*args)
    with pytest.raises(ValueError, match="no device body"):
        ft.make_fused_sample_block(other, 5, 5, 5, 1)(
            0, t["theta"], t["logp0"], t["grad0"], t["rho"], *args[5:])
    assert fused.launches == 0


def test_normal_draws_without_a_host_sync(cuda):
    """Momenta are drawn inside sampling loops: ``prng.normal`` must enqueue
    its work without waiting for the stream (no tensor made from a host
    number on the device)."""
    key = prng.key(3, cuda)
    want = prng.normal(key, (64, 5), torch.float32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = prng.normal(key, (64, 5), torch.float32)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
