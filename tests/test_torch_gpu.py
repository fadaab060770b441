"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips. The file imports no JAX, so it also runs on a machine that has only
PyTorch: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_gpu.py -q`` (``--noconftest`` keeps the suite's JAX setup
out). The replay kernel is integer arithmetic and must be bitwise equal;
the logistic-regression kernel sums in another order than the plain
version's matrix products, so it is held to ``tests/test_pallas.py``'s
float32 tolerances, at every padded width, and must repeat bit for bit. The fused tier-2 pass kernel is held to its plain
version on the same synthetic lane states: integers, flags and keys equal
on every lane; rows to a few ulp (the restart's normals run the same
polynomial, rounded step by step on both sides); per-lane floats to rtol
1e-5 / atol 1e-4 in float32 (1e-10 in float64), because the momentum
energy of a restart is a warp sum in the kernel and PyTorch's reduction in
the plain version. Both kernels are also run on states built to reach
every case of their control flow (every latch round of a warp; every
cascade depth, a sub-U-turn at each slot, all lanes pending or none, at
widths below, at and above a chunk of 32 features and at chain counts
below and above a block), held to the smoke's criterion (integers, flags
and keys equal, floats within 1e-3), and must repeat bit for bit. The fused integrator is held to ``integrate_plain`` on
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
entry on one of 30000). Their logistic-regression chains are also run, on
the group of warps a chain that each entry point takes, at chain counts
below, at and above a multiple of the card's warps, and must repeat bit
for bit from launch to launch and from one chain order to the other.

The bench's other configurations: the stochastic-volatility and
eight-schools posteriors at the distribution level against the native C++
sampler's draws (``tests/data/native_*_draws.npz``), by the JAX package's
protocol and KS thresholds (``tests/test_native_parity.py``: float64,
``keep_dims``, SV conditioned on the chains that moved; SV's only with
``WALNUTS_TORCH_SV_PARITY=1``, as it outlasts a card call today); funnel(101) x
4096 with 1 and 4 cost-sorted groups bit for bit; and the fused pass at
D = 1003 on lane states of a run from a warmed stochastic-volatility
state, against plain by the smoke's criterion.

The unfused tier-2 pass, which the card replays as one CUDA graph a shape:
warmup and sampling of logreg x 4096 (kernel 2) and of funnel(101) x 4096
in 4 groups, through the graph and through the eager pass, bit for bit
(draws, log densities, depths, keys, counters, trips, passes, syncs), with
every pass a replay and kernel 1 counted at each replay.
"""

import os

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


def _logreg_case(b, p, n, seed, device):
    """theta (b, p) ~ 0.3 N(0, 1), X (n, p) ~ N(0, 1), labels +-1, float32."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return (t(0.3 * rng.standard_normal((b, p))), t(rng.standard_normal((n, p))),
            t(np.where(rng.random(n) < 0.5, -1.0, 1.0)))


@pytest.mark.parametrize("n", [1, 12, 1000, 1024, 1500])
@pytest.mark.parametrize("p", [1, 4, 7, 25, 28, 29, 32])
def test_logreg_kernel_vs_plain_every_width(cuda, p, n):
    """Every padded width (P rounded up to 4), rows within one staged chunk
    and over several (1500), and chain counts around the 32-chain tile."""
    for b in (1, 31, 33, 4096, 4097):
        theta, x, y = _logreg_case(b, p, n, 1000 * p + n + b, cuda)
        lp_p, g_p = logreg_value_grad_plain(theta, x, y)
        lp_k, g_k = logreg_value_grad(theta, x, y)
        torch.cuda.synchronize()
        np.testing.assert_allclose(lp_k.cpu().numpy(), lp_p.cpu().numpy(),
                                   rtol=1e-5, err_msg=f"B={b}")
        np.testing.assert_allclose(g_k.cpu().numpy(), g_p.cpu().numpy(),
                                   rtol=1e-4, atol=2e-3 * n / 1000, err_msg=f"B={b}")


def test_logreg_kernel_repeats_bitwise(cuda):
    """Every sum in a fixed order, no atomics: two launches agree bit for bit."""
    theta, x, y = _logreg_case(4096, 25, 1000, 7, cuda)
    first = logreg_value_grad(theta, x, y)
    second = logreg_value_grad(theta, x, y)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_logreg_kernel_refuses_bad_input(cuda):
    from walnuts_tpu_torch.ops import _cuda

    design, y = logistic_regression_data()
    x_t, y_t = logreg_tensors(design, y, cuda)
    theta = torch.zeros((4, 25), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        logreg_value_grad(theta.double(), x_t, y_t)
    with pytest.raises(ValueError, match="features"):
        wide = torch.zeros((4, 33), device=cuda)
        logreg_value_grad(wide, torch.zeros((10, 33), device=cuda), y_t[:10])
    # the C entry point refuses P = 33 too (cudaErrorInvalidValue)
    wide = torch.zeros((4, 33), device=cuda)
    x33 = torch.zeros((10, 33), device=cuda)
    out = torch.empty((4, 33), device=cuda)
    err = _cuda.library("logreg").wt_logreg_value_grad(
        wide.data_ptr(), x33.data_ptr(), y_t.data_ptr(), out.data_ptr(),
        out.data_ptr(), 4, 33, 10, torch.cuda.current_stream().cuda_stream)
    assert err == 1


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


def _replay_case(c, mode, seed):
    """Replay operands: ``every_round``: n_ends 12 and lane j latching at
    round j mod 13, so the lanes of a warp latch at every round (and some
    never); ``zero``: n_ends 0 everywhere; ``mixed``: n_ends in [0, 12],
    the latch anywhere up to one past it."""
    rng = np.random.default_rng(seed)
    kd = rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.uint32)
    ku = rng.integers(0, 2**32, size=(c, 2), dtype=np.uint64).astype(np.uint32)
    if mode == "every_round":
        n_ends = np.full(c, 12, np.int32)
        at = (np.arange(c) % 13).astype(np.int32)
    elif mode == "zero":
        n_ends = np.zeros(c, np.int32)
        at = rng.integers(0, 3, size=c).astype(np.int32)
    else:
        n_ends = rng.integers(0, 13, size=c).astype(np.int32)
        at = rng.integers(0, n_ends + 2).astype(np.int32)
    return (key_data_torch(kd), key_data_torch(ku), torch.from_numpy(n_ends),
            torch.from_numpy(at))


@pytest.mark.parametrize("c", [1, 31, 33, 4096, 4097])
@pytest.mark.parametrize("mode", ["every_round", "zero", "mixed"])
def test_replay_kernel_bitwise_at_every_latch_round(cuda, mode, c):
    args = _replay_case(c, mode, 7 * c)
    want = prng.replay_split_chain_plain(*args)
    got = prng.replay_split_chain(*(a.to(cuda) for a in args))
    again = prng.replay_split_chain(*(a.to(cuda) for a in args))
    torch.cuda.synchronize()
    for g, h, w in zip(got, again, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())
        assert torch.equal(g, h)


def pass_case_fields(c, d, seed, case, max_depth=5, r=6):
    """``synthetic_pass_inputs`` made into one of the kernel checks' cases:

    - ``every_index``: every lane pending at the deepest doubling with its
      leaf at index c mod 2^(max_depth - 1), so every merge count, every
      cascade depth and the subtree's last leaf occur; straight orbits, so
      the U-turn checks pass;
    - ``fail_each_slot``: every lane on the last leaf (a merge over every
      stack slot), straight orbits, and lane c's slot c mod (n_slots + 1)
      turned back: a sub-U-turn at each slot (none on the last group);
    - ``all_pending`` / ``none_pending``: the synthetic state with every
      lane's leaf latched, or none.

    Active lanes have draws_done below ``r``, so completing lanes restart
    or end the block."""
    fields, p = fp.synthetic_pass_inputs(c, d, max_depth, r, seed)
    rng = np.random.default_rng(seed + 1)
    n_slots = max(max_depth - 1, 1)
    if case in ("every_index", "fail_each_slot"):
        n_leaves = 1 << (max_depth - 1)
        fields["depth"][:] = max_depth
        fields["n_leaves"][:] = n_leaves
        fields["leaf_idx"][:] = (np.arange(c) % n_leaves if case == "every_index"
                                 else n_leaves - 1)
        fields["leaf_done"][:] = True
        fields["leaf_ok"][:] = True
        fields["draws_done"][:] = rng.integers(0, r, c)
        fields["run_logw"] = np.where(fields["leaf_idx"] == 0, -np.inf,
                                      -10.0 + rng.standard_normal(c))
        im = p["inv_mass"]
        sgn = np.where(fields["forward"], 1.0, -1.0)[:, None]
        v = rng.standard_normal((c, d))
        fth = fields["fwd_th"]
        fields["fwd_rho"] = v + 0.1 * rng.standard_normal((c, d))

        def older():
            a = 0.5 + rng.random((c, 1))
            return fth - sgn * a * v / im, v + 0.1 * rng.standard_normal((c, d))

        fields["acc_th_bk"], fields["acc_rho_bk"] = older()
        fields["acc_th_fw"], fields["acc_rho_fw"] = older()
        stack = fields["stack_e"]
        for i in range(n_slots):
            stack[:, i, 0], stack[:, i, 1] = older()
        if case == "fail_each_slot":
            turned = np.arange(c) % (n_slots + 1)
            for i in range(n_slots):
                stack[turned == i, i, 1] *= -1.0
    elif case == "all_pending":
        fields["leaf_done"][:] = True
        fields["draws_done"][:] = rng.integers(0, r, c)
    else:
        fields["leaf_done"][:] = False
    return fields, p


def _pass_state(fields, p, c, d, r, dtype, device):
    st = lane_state_from_fields(fields, dtype, device)
    params = tuple(torch.tensor(p[n], dtype=t, device=device) for n, t in
                   (("step", dtype), ("inv_mass", dtype), ("min_micro", torch.int32)))
    out = (torch.zeros((r, c, d), dtype=dtype, device=device),
           torch.zeros((r, c), dtype=dtype, device=device),
           torch.zeros((r, c), dtype=torch.int32, device=device))
    return st, params, out


@pytest.mark.parametrize("case", ["every_index", "fail_each_slot", "all_pending",
                                  "none_pending"])
@pytest.mark.parametrize("c", [1, 33, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("d", [1, 25, 32, 33, 101, 1003])
def test_fused_pass_kernel_cases_vs_plain(cuda, d, dtype, c, case):
    """The kernel against plain on every lane (integers, flags and keys
    equal, floats within 1e-3: chip_smoke.py's criterion), and two launches
    from the same state bitwise equal."""
    max_depth, r = 5, 6
    fields, p = pass_case_fields(c, d, 11 * c + d, case, max_depth, r)
    runs = []
    for _ in range(2):
        st, params, out = _pass_state(fields, p, c, d, r, dtype, cuda)
        fp.fused_pass(st, *params, r, r, max_depth, out)
        runs.append([fp.lane_field(st, n) for n in fp.RW_FIELDS] + list(out))
    st_p, params, out_p = _pass_state(fields, p, c, d, r, dtype, cuda)
    fp.fused_pass_plain(st_p, *params, r, r, max_depth, out_p)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    want = [fp.lane_field(st_p, n) for n in fp.RW_FIELDS] + list(out_p)
    for name, k, w in zip(fp.RW_FIELDS + fp.BANK, runs[0], want):
        if k.is_floating_point():
            assert torch.equal(torch.isfinite(k), torch.isfinite(w)), name
            both = torch.isfinite(k)
            if both.any():
                assert float((k - w)[both].abs().max()) <= 1e-3, name
        else:
            assert torch.equal(k, w), name
    if case == "none_pending":  # only the replay moved
        assert torch.equal(out_p[2], torch.zeros_like(out_p[2]))


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
    _, d_f, l_f, info = run_sampling(lg, ss, params, scfg, batched=True,
                                     device_draws=True, pallas_pass=True)
    torch.cuda.synchronize()
    assert fp.fused_pass.launches - before == info.n_outer_trips["sampling"] > 0
    _, d_u, _, _ = run_sampling(lg, ss, params, scfg, batched=True,
                                device_draws=True)
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
    # the body's other padded widths: P = 7 (to 8) and P = 32
    "logistic_regression_p7": (
        lambda dev: kernels.logistic_regression_vg(1000, 7, device=dev),
        dict(theta_scale=0.3, inv_mass_scale=0.005, dt_range=(0.05, 0.2)),
        (torch.float32,)),
    "logistic_regression_p32": (
        lambda dev: kernels.logistic_regression_vg(1000, 32, device=dev),
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
        if body.startswith("logistic_regression"):
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
                                     device_draws=True, integrator=fused)
    torch.cuda.synchronize()
    assert fused.launches == info.n_outer_trips["sampling"] > 0
    _, d_p, _, _ = run_sampling(lg, ss, params, scfg, batched=False,
                                device_draws=True)
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
                                ("logistic_regression", 7),
                                ("logistic_regression", 32)])
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


_PLAIN_TRANSITIONS = {}  # (kind, C, P) -> the case's operands and plain result


def _logreg_transition_case(cuda, kind, c, p):
    """Logistic regression (1000 rows at P = 25, else 200), max_depth 5,
    max_step_halvings 8, 5a or 5b of 3 draws: the factory's arguments, the
    call's arguments and the plain version's result, made once per case."""
    key = (kind, c, p)
    if key not in _PLAIN_TRANSITIONS:
        factory, scales = _TRANSITION_CASES["logistic_regression"]
        model = factory(p, cuda)
        vg = model[0]
        n = 1 if kind == "5a" else 3
        t = ft.transition_tensors(vg, ft.synthetic_transition_inputs(
            c, p, 7 * c + p, num_draws=n, **scales), cuda)
        tail = (t["step"], t["inv_mass"], t["min_micro"], 0.5)
        static = dict(max_depth=5, max_step_halvings=8)
        if kind == "5a":
            args = (11, t["theta"], t["rho"][0].contiguous(), t["logp0"],
                    t["grad0"], *tail)
            want = ft.fused_transition_plain(vg, *args, **static)
        else:
            args = (11, t["theta"], t["logp0"], t["grad0"], t["rho"], *tail)
            want = ft.fused_sample_block_plain(vg, *args, **static)
        _PLAIN_TRANSITIONS[key] = (model, args, want)
    return _PLAIN_TRANSITIONS[key]


@pytest.mark.parametrize("p", [1, 7, 25, 32])
@pytest.mark.parametrize("c", [1, 31, 33, 4096, 4097])
@pytest.mark.parametrize("kind", ["5a", "5b"])
def test_transition_logreg_counter_and_groups(cuda, kind, c, p):
    """The logistic-regression chains of 5a and 5b, taken from the counter
    by groups of the entry point's ``GROUP_WARPS`` warps: two launches in a
    row are bitwise equal (the counter starts from 0 at every launch; the
    first takes the chains in index order, the second in the order the
    first measured), and
    depth and n_grads equal the plain version's on at least 0.98 of the
    chains, with theta, grad and logp (5b: every draw) within rtol 1e-3 /
    atol 5e-3 on every one of those chains."""
    model, args, want = _logreg_transition_case(cuda, kind, c, p)
    if kind == "5a":
        fused = ft.make_fused_transition(model, p, 5, 8)
        ints, floats = (3, 4), (0, 1, 2)
    else:
        fused = ft.make_fused_sample_block(model, p, 5, 8, 3)
        ints, floats = (5,), (0, 1, 2, 3, 4)
    ft._MEASURED[:] = [None, None]  # no earlier case's measurement
    got = fused(*args)
    again = fused(*args)
    torch.cuda.synchronize()
    assert fused.launches == 2
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    same = torch.ones(c, dtype=torch.bool, device=cuda)
    for i in ints:
        same &= got[i] == want[i]
    assert same.float().mean() >= 0.98
    for i in floats:
        # the chain axis first
        g, w = (x[i].movedim(1, 0) if kind == "5b" and i < 2 else x[i]
                for x in (got, want))
        np.testing.assert_allclose(g[same].cpu().numpy(), w[same].cpu().numpy(),
                                   **_TRANSITION_TOL)
    if c > 1:
        assert int(want[ints[-1]].max()) > int(want[ints[-1]].min())  # chains differ


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


# --- the funnel and stochastic-volatility configurations ------------------

_DATA = os.path.join(os.path.dirname(__file__), "data")
# two-sample KS threshold c(alpha) sqrt(1/ne1 + 1/ne2), alpha = 1e-3
# (tests/test_native_parity.py)
_KS_C = float(np.sqrt(-np.log(0.0005) / 2.0))


def _pooled_neff(draws_cnd, dim):
    from walnuts_tpu_torch.summary import effective_sample_size

    return float(effective_sample_size(
        [draws_cnd[c, :, dim:dim + 1] for c in range(draws_cnd.shape[0])])[0])


def _ks(a, b):
    a, b = np.sort(a), np.sort(b)
    grid = np.concatenate([a, b])
    ca = np.searchsorted(a, grid, side="right") / a.size
    cb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.max(np.abs(ca - cb)))


def _ks_check(native, ours, dim, label):
    ne_n, ne_o = _pooled_neff(native, dim), _pooled_neff(ours, dim)
    d = _ks(native[:, :, dim].ravel(), ours[:, :, dim].ravel())
    thresh = _KS_C * np.sqrt(1.0 / ne_n + 1.0 / ne_o)
    assert d < thresh, (f"{label}: KS={d:.4f} >= {thresh:.4f} "
                        f"(n_eff native={ne_n:.0f}, ours={ne_o:.0f})")


def _run_port(model, dim, num_draws, seed, num_chains, num_warmup, device):
    """tests/test_native_parity.py's protocol: float64, halvings 8, block
    100, the first ``dim`` dimensions kept."""
    import walnuts_tpu_torch as wtt

    logp, D = model
    outs = wtt.walnuts(
        logp, num_params=D, num_chains=num_chains, seed=seed, device=device,
        min_warmup_iter=num_warmup, max_warmup_iter=num_warmup,
        min_sampling_iter=num_draws, max_sampling_iter=num_draws,
        block_size=100, max_step_halvings=8, dtype=torch.float64,
        keep_dims=tuple(range(dim)) if dim < D else None)
    return np.stack([np.asarray(o) for o in outs])  # (C, n, dim)


@pytest.fixture(scope="module")
def sv_native_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from walnuts_tpu_torch.models import stochastic_volatility

    native = np.load(f"{_DATA}/native_sv_draws.npz")["draws"].astype(np.float64)
    ours = _run_port(stochastic_volatility(device="cuda"), 3, 2000, 654, 32, 200,
                     "cuda")
    # condition both sides on the chains that moved (radius-2 inits leave
    # about half the SV chains stuck from birth in both implementations)
    live = lambda d: d[np.any(np.diff(d[:, :, 0], axis=1) != 0.0, axis=1)]
    return live(native), live(ours)


@pytest.fixture(scope="module")
def es_native_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from walnuts_tpu_torch.models import eight_schools

    native = np.load(f"{_DATA}/native_eight_schools_draws.npz")["draws"].astype(
        np.float64)
    return native, _run_port(eight_schools(device="cuda"), 10, 2000, 321, 16, 400,
                             "cuda")


@pytest.mark.skipif(
    not os.environ.get("WALNUTS_TORCH_SV_PARITY"),
    reason="32 chains x 2200 iterations of SV(1003) in float64 ran past 45 min "
    "on an H100 with the host-driven trip (~6-7 ms a trip); set "
    "WALNUTS_TORCH_SV_PARITY=1 to run it, once device-side loop control "
    "(ROADMAP.md Queue 1 item 5) makes it fit a call")
@pytest.mark.parametrize("dim,label", [(0, "mu"), (1, "phi_raw"), (2, "log_sigma")])
def test_sv_native_parity(sv_native_pair, dim, label):
    """The SV hyperparameters' marginals over the live cohort against the
    native C++ sampler's draws (the KS protocol of the JAX package)."""
    native, ours = sv_native_pair
    assert native.shape[0] >= 4 and ours.shape[0] >= 4, "too few live chains"
    _ks_check(native, ours, dim, f"sv {label}")


@pytest.mark.parametrize("dim,label", [(0, "mu"), (1, "log_tau")])
def test_eight_schools_native_parity(es_native_pair, dim, label):
    native, ours = es_native_pair
    _ks_check(native, ours, dim, f"eight_schools {label}")


def test_eight_schools_native_effect_tails(es_native_pair):
    """School 1's effect mu + tau z1: quantiles within the native run's
    own half-against-half noise."""
    native, ours = es_native_pair
    effect = lambda d: d[:, :, 0] + np.exp(d[:, :, 1]) * d[:, :, 2]
    e_n, e_o = effect(native), effect(ours)
    h1, h2 = e_n[:8].ravel(), e_n[8:].ravel()
    for p in (0.05, 0.5, 0.95):
        noise = max(abs(np.quantile(h1, p) - np.quantile(h2, p)), 0.05)
        diff = abs(np.quantile(e_n.ravel(), p) - np.quantile(e_o.ravel(), p))
        assert diff < 3.0 * noise + 0.15, f"effect q{p}: {diff:.3f} vs {noise:.3f}"


def test_batched_groups_bitwise_on_funnel_card(cuda):
    """funnel(101) x 4096, float32, at a short length (blocks of one
    iteration, so the groups are re-sorted every iteration): 1 and 4
    cost-sorted groups give the same draws and gradient counts bit for
    bit."""
    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.models import funnel

    kw = dict(num_params=101, num_chains=4096, seed=29, device="cuda",
              dtype=torch.float32, min_warmup_iter=3, max_warmup_iter=3,
              min_sampling_iter=3, max_sampling_iter=3, block_size=1,
              runahead=4, max_step_halvings=8, return_info=True)
    runs = [wtt.walnuts(funnel(101)[0], batched_groups=g, **kw) for g in (1, 4)]
    (one, i1), (four, i4) = runs
    a = np.stack([np.asarray(c) for c in one])
    b = np.stack([np.asarray(c) for c in four])
    assert np.isfinite(a).all()
    same = np.all(a == b, axis=(1, 2))
    assert same.all(), f"draws differ on {int((~same).sum())} of 4096 chains"
    np.testing.assert_array_equal(i1.n_grads, i4.n_grads)


def _clone_tree(t):
    if isinstance(t, tuple):
        return type(t)(*(_clone_tree(x) for x in t))
    return t.clone()


def test_fused_pass_kernel_on_warmed_sv_state(cuda):
    """Kernel 4 at D = 1003 on lane states of a sampling run from a warmed
    stochastic-volatility state (256 chains, 30 warmup iterations): against
    plain on every lane with the smoke's criterion (integers, flags and keys
    equal, floats within 1e-3)."""
    from walnuts_tpu_torch.core import batched
    from walnuts_tpu_torch.models import stochastic_volatility
    from walnuts_tpu_torch.ops.math import make_logp_grad
    from walnuts_tpu_torch.parallel.runtime import run_sampling, run_warmup

    c = 256
    lg = make_logp_grad(stochastic_volatility(device="cuda")[0])
    wcfg = WarmupConfig(min_iter=30, max_iter=30, block_size=30)
    scfg = SamplingConfig(min_iter=10, max_iter=10, block_size=10,
                          max_step_halvings=8)
    keys = prng.fold_in(prng.key(8, cuda), torch.arange(c, device=cuda))
    theta = 0.5 * prng.normal(prng.key(9, cuda), (c, 1003), torch.float32)
    ws = init_warmup_state(keys, theta, torch.ones_like(theta),
                           torch.full((c,), 0.05, device=cuda), wcfg, scfg)
    ws = run_warmup(lg, ws, wcfg, scfg, batched=True, tier2_every=12)[0]
    kept, calls, real = [], [0], batched.fused_pass

    def keep(s, *args, **kwargs):
        if calls[0] % 7 == 0 and len(kept) < 6:  # launches 0, 7, ..., 35
            kept.append((_clone_tree(s), args))
        calls[0] += 1
        return real(s, *args, **kwargs)

    batched.fused_pass = keep
    try:
        run_sampling(lg, init_sample_state(ws), freeze_params(ws), scfg,
                     batched=True, device_draws=True, runahead=8, tier2_every=12,
                     pallas_pass=True)
    finally:
        batched.fused_pass = real
    assert kept
    for s, (step, inv_mass, min_micro, cap, R, max_depth, out) in kept:
        runs = []
        for fn in (fp.fused_pass, fp.fused_pass_plain):
            st, o = _clone_tree(s), tuple(torch.zeros_like(x) for x in out)
            fn(st, step, inv_mass, min_micro, cap, R, max_depth, o)
            runs.append([fp.lane_field(st, n) for n in fp.RW_FIELDS] + list(o))
        torch.cuda.synchronize()
        for name, k, w in zip(fp.RW_FIELDS + fp.BANK, *runs):
            if k.is_floating_point():
                assert torch.equal(torch.isfinite(k), torch.isfinite(w)), name
                both = torch.isfinite(k)
                if both.any():
                    assert float((k - w)[both].abs().max()) <= 1e-3, name
            else:
                assert torch.equal(k, w), name


def test_checkpoint_crash_resume_bitwise_on_card(cuda, tmp_path):
    """logreg(25) x 4096 with kernel 2 (``fused=True``), 10 + 10 in blocks
    of 5: a run crashed after its first sampling block and resumed from its
    checkpoint is the uninterrupted run bit for bit (draws, step sizes,
    inverse metrics, ``n_grads``)."""
    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.parallel.checkpoint import BlockCheckpointer

    lg, dim = logistic_regression_fused(device="cuda")
    kw = dict(fused=True, num_params=dim, num_chains=4096, dtype=torch.float32,
              seed=41, device="cuda", min_warmup_iter=10, max_warmup_iter=10,
              min_sampling_iter=10, max_sampling_iter=10, block_size=5,
              max_step_halvings=8, save_inv_metric=True, return_info=True)
    before = logreg_value_grad.launches
    plain, info = wtt.walnuts(lg, **kw)
    assert logreg_value_grad.launches > before
    real = BlockCheckpointer.block

    def block_then_crash(self, phase, it, *args, **kwargs):
        real(self, phase, it, *args, **kwargs)
        if (phase, it) == ("sampling", 5):
            raise KeyError("simulated preemption")

    BlockCheckpointer.block = block_then_crash
    try:
        with pytest.raises(KeyError, match="simulated preemption"):
            wtt.walnuts(lg, checkpoint_dir=str(tmp_path), **kw)
    finally:
        BlockCheckpointer.block = real
    resumed, info_r = wtt.walnuts(lg, checkpoint_dir=str(tmp_path), **kw)
    a = np.stack([np.asarray(c) for c in plain])
    assert np.isfinite(a).all()
    np.testing.assert_array_equal(a, np.stack([np.asarray(c) for c in resumed]))
    assert [c.warmup.stepsize for c in plain] == [c.warmup.stepsize for c in resumed]
    np.testing.assert_array_equal(np.stack([c.warmup.inv_metric for c in plain]),
                                  np.stack([c.warmup.inv_metric for c in resumed]))
    np.testing.assert_array_equal(info.n_grads, info_r.n_grads)


def _root():
    from pathlib import Path

    return Path(__file__).resolve().parents[1]


def test_walnuts_stan_eight_schools_vs_autograd_on_card(cuda):
    """The eight-schools ABI model through the native bridge against the
    port's autograd model, 1024 chains, float64, 30 + 30, same seed: at
    least 0.99 of the chains with equal ``n_grads``, and on those ``mu`` to
    rtol / atol 1e-3 (the reference's parity test at the card's width)."""
    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.models import eight_schools
    from walnuts_tpu_torch.ops._cuda import build_host

    so = build_host(_root() / "csrc" / "abi_models.cpp",
                    defines=("ABI_MODEL_EIGHT_SCHOOLS",))
    kw = dict(seed=43, num_chains=1024, dtype=torch.float64, device="cuda",
              min_warmup_iter=30, max_warmup_iter=30, min_sampling_iter=30,
              max_sampling_iter=30, return_info=True)
    before = prng.replay_split_chain.launches
    out_s, info_s = wtt.walnuts_stan(str(so), **kw)
    assert prng.replay_split_chain.launches > before
    out_a, info_a = wtt.walnuts(eight_schools(device="cuda")[0], num_params=10, **kw)
    equal = info_s.n_grads == info_a.n_grads
    assert equal.mean() >= 0.99, equal.mean()
    mu_s = np.stack([o["mu"] for o in out_s], axis=1)[:, equal]
    mu_a = np.stack([np.asarray(o)[:, 0] for o in out_a], axis=1)[:, equal]
    np.testing.assert_allclose(mu_s, mu_a, rtol=1e-3, atol=1e-3)


def test_walnuts_pyfunc_ctypes_callback_on_card(cuda):
    """walnuts_pyfunc with the ``(ctypes_cfunc, data)`` form of
    ``csrc/callback_model.c`` (a standard normal, D = 100) x 256 chains, 30
    + 30: every coordinate's pooled mean within 0.1 of 0, its sd within 10 %
    of 1; the replay kernel runs."""
    import ctypes

    import walnuts_tpu_torch as wtt
    from walnuts_tpu_torch.ops._cuda import build_host

    lib = ctypes.CDLL(str(build_host(_root() / "csrc" / "callback_model.c")))
    proto = ctypes.CFUNCTYPE(
        ctypes.c_int, ctypes.c_size_t, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_void_p)
    before = prng.replay_split_chain.launches
    out = wtt.walnuts_pyfunc((proto(("logp_cb", lib)), None), num_params=100,
                             num_chains=256, seed=47, device="cuda",
                             min_warmup_iter=30, max_warmup_iter=30,
                             min_sampling_iter=30, max_sampling_iter=30)
    assert prng.replay_split_chain.launches > before
    d = np.stack([np.asarray(c) for c in out]).reshape(-1, 100)
    assert np.isfinite(d).all()
    assert np.abs(d.mean(0)).max() <= 0.1
    assert np.abs(d.std(0) - 1.0).max() <= 0.1


def test_failed_host_build_raises_on_card(cuda, tmp_path):
    from walnuts_tpu_torch.ops._cuda import build_host

    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="failed"):
        build_host(bad)


# ---------------------------------------------------------------------------
# the scheduler options and runtime keywords on the card
# ---------------------------------------------------------------------------

def _options_start(cuda, c=256, dim=11):
    """A funnel(dim) start of ``c`` chains on the card, its model by
    autograd, kernel 3 for the funnel, and kernel 3's own value and
    gradient (one step of size 0 from ``(theta, 0, 0)``): with the latter
    as the model a transition's start point has the same bits whether the
    classic path re-evaluates it or the flattened sampler caches it."""
    scfg = SamplingConfig(min_iter=10, max_iter=10, block_size=5,
                          max_step_halvings=6)
    wcfg = WarmupConfig(min_iter=0, max_iter=0, block_size=10)
    keys = prng.fold_in(prng.key(13, cuda), torch.arange(c, device=cuda))
    theta = prng.normal(prng.key(14, cuda), (c, dim), torch.float32)
    ws = init_warmup_state(keys, theta, torch.ones_like(theta),
                           torch.full((c,), 0.3, device=cuda), wcfg, scfg)
    fused = integ.make_fused_integrator(kernels.funnel_vg(dim))

    def k3_value_grad(th):
        n = th.shape[0]
        cur = torch.stack([th, torch.zeros_like(th), torch.zeros_like(th)], 1)
        out, lp = fused(cur, torch.ones_like(th), torch.zeros(n, device=th.device),
                        torch.ones(n, dtype=torch.int32, device=th.device))
        return lp, out[:, 2]

    return scfg, freeze_params(ws), init_sample_state(ws), fused, k3_value_grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_bf16_rounding_on_card_is_the_cpus(cuda, dtype):
    from walnuts_tpu_torch.core.transition import round_bf16

    rng = np.random.default_rng(17)
    x = rng.standard_normal(10**6) * np.exp(rng.uniform(-30, 30, 10**6))
    mid = np.arange(1, 4097, dtype=np.float64) * 2.0**-7 + 2.0**-8 + 1.0
    x = np.concatenate([x, mid, np.nextafter(mid, 0), np.nextafter(mid, 4), -mid])
    v = torch.from_numpy(x).to(dtype)
    assert torch.equal(round_bf16(v.to(cuda)).cpu(), round_bf16(v))


def test_flatten_with_kernel_3_is_the_classic_chain(cuda):
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    scfg, params, ss, fused, lg3 = _options_start(cuda)
    kw = dict(integrator=fused, device_draws=True)
    _, d_c, l_c, i_c = run_sampling(lg3, ss, params, scfg, **kw)
    _, d_f, l_f, i_f = run_sampling(lg3, ss, params, scfg, flatten=True, **kw)
    assert torch.equal(d_f, d_c) and torch.equal(l_f, l_c)
    # no start evaluation a transition, the bank's one, its run-ahead
    assert np.all(i_f.n_grads - i_c.n_grads >= 1 - 10)


def test_chain_groups_with_kernel_3_is_the_classic_chain(cuda):
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    scfg, params, ss, fused, lg3 = _options_start(cuda)
    kw = dict(integrator=fused, device_draws=True)
    s_c, d_c, l_c, i_c = run_sampling(lg3, ss, params, scfg, **kw)
    s_g, d_g, l_g, i_g = run_sampling(lg3, ss, params, scfg, chain_groups=2, **kw)
    assert torch.equal(s_g.key, s_c.key)
    np.testing.assert_array_equal(i_g.n_grads, i_c.n_grads)
    assert torch.equal(d_g, d_c) and torch.equal(l_g, l_c)


@pytest.mark.parametrize("kw", [dict(defer_splits=False), dict(min_latched=64),
                                dict(fresh_cur=True), dict(bounded_sweeps=True)],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_batched_option_on_card_is_the_default_block(cuda, kw):
    """Each scheduling option on the card against the deferred, static
    default: draws, log densities, end keys and n_grads bit for bit;
    defer_splits=False splits in every trip through kernel 1."""
    from walnuts_tpu_torch.models import funnel
    from walnuts_tpu_torch.ops.math import make_logp_grad
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    scfg, params, ss, _, _ = _options_start(cuda)
    lg = make_logp_grad(funnel(11)[0])
    s_a, d_a, l_a, i_a = run_sampling(lg, ss, params, scfg, batched=True)
    before = prng.replay_split_chain.launches
    s_b, d_b, l_b, i_b = run_sampling(lg, ss, params, scfg, batched=True, **kw)
    if "defer_splits" in kw:
        assert prng.replay_split_chain.launches - before >= i_b.n_inner_trips["sampling"]
    assert torch.equal(s_b.key, s_a.key)
    np.testing.assert_array_equal(i_b.n_grads, i_a.n_grads)
    assert torch.equal(d_b, d_a) and torch.equal(l_b, l_a)


@pytest.mark.parametrize("device_draws", [False, True])
def test_device_draws_placement_on_card(cuda, device_draws):
    from walnuts_tpu_torch.models import funnel
    from walnuts_tpu_torch.ops.math import make_logp_grad
    from walnuts_tpu_torch.parallel.runtime import run_sampling

    scfg, params, ss, _, _ = _options_start(cuda, c=64)
    lg = make_logp_grad(funnel(11)[0])
    _, d, lp, _ = run_sampling(lg, ss, params, scfg, batched=True,
                               device_draws=device_draws)
    _, d_ref, _, _ = run_sampling(lg, ss, params, scfg, batched=True,
                                  device_draws=not device_draws)
    assert d.device.type == ("cuda" if device_draws else "cpu")
    assert d.is_pinned() == (not device_draws)
    assert torch.equal(d.cpu(), d_ref.cpu())


# --- the unfused pass replayed as a CUDA graph ----------------------------


def _routes(monkeypatch, logp_grad, ws, wcfg, scfg, **kw):
    """``ws``'s warmup and then sampling on the card (``run_warmup`` /
    ``run_sampling``, batched, ``kw``), once through the CUDA graph of each
    pass and once through the eager pass. Per route: the draws and log
    densities of both phases, every block's depths, end keys and counter
    deltas, the final states, the RunInfo and kernel 1's launches."""
    from walnuts_tpu_torch.core import batched
    from walnuts_tpu_torch.parallel import runtime

    warm_factory = runtime.make_batched_warmup_block
    sample_factory = runtime.make_batched_sample_block
    routes = {}
    for graphed in (True, False):
        blocks = []

        def kept(res):
            blocks.append(tuple(t.cpu() for t in (res.depths, res.key,
                                                  res.n_grads_delta, *res.fails_delta)))

        def warm(*a, **k):
            block = warm_factory(*a, **k)

            def run(ws, n, out=None):
                ws, res = block(ws, n, out)
                kept(res)
                return ws, res
            return run

        def sample(*a, **k):
            start, block = sample_factory(*a, **k)

            def run(*b, **c):
                res = block(*b, **c)
                kept(res)
                return res
            return start, run

        monkeypatch.setattr(batched, "_graph_passes", lambda device, g=graphed: g)
        monkeypatch.setattr(runtime, "make_batched_warmup_block", warm)
        monkeypatch.setattr(runtime, "make_batched_sample_block", sample)
        before = prng.replay_split_chain.launches
        w, wd, wl, info = runtime.run_warmup(
            logp_grad, _clone_tree(ws), wcfg, scfg, batched=True, save_warmup=True,
            block_budget=0, runahead=4, tier2_every=12, **kw)
        s, d, lp, info = runtime.run_sampling(
            logp_grad, init_sample_state(w), freeze_params(w), scfg, info=info,
            batched=True, device_draws=True, block_budget=0, **kw)
        torch.cuda.synchronize()
        routes[graphed] = dict(
            out=tuple(t.cpu() for t in (wd, wl, d, lp)) + tuple(blocks),
            states=(_clone_tree(w), _clone_tree(s)), info=info,
            launches=prng.replay_split_chain.launches - before)
    return routes[True], routes[False]


def _assert_routes_bitwise(graph, eager):
    from walnuts_tpu_torch.ops.fused_pass import _leaves

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def same(a, b):
        a, b = _leaves(a), _leaves(b)
        return len(a) == len(b) and all(
            x.shape == y.shape and torch.equal(bits(x.cpu()), bits(y.cpu()))
            for x, y in zip(a, b))

    assert same(graph["out"], eager["out"]), "draws, log densities or blocks differ"
    assert same(graph["states"], eager["states"]), "end states differ"
    gi, ei = graph["info"], eager["info"]
    for k in ("n_inner_trips", "n_outer_trips", "n_syncs", "n_blocks"):
        assert getattr(gi, k) == getattr(ei, k), k
    for k in ("n_grads", "n_halve_fail", "n_nonfinite", "n_depth_exhausted"):
        np.testing.assert_array_equal(getattr(gi, k), getattr(ei, k))
    assert gi.n_pass_replays == gi.n_outer_trips
    assert gi.n_pass_captures == {"warmup": 1, "sampling": 1}  # one shape a phase
    assert ei.n_pass_replays == ei.n_pass_captures == {"warmup": 0, "sampling": 0}
    # kernel 1 once a pass on either route, and once in the eager pass
    # before each capture
    assert eager["launches"] == sum(ei.n_outer_trips.values())
    assert graph["launches"] == (sum(gi.n_pass_replays.values())
                                 + sum(gi.n_pass_captures.values()))


def test_graphed_pass_is_the_eager_pass_on_logreg_card(cuda, monkeypatch):
    """logreg(25) x 4096 with kernel 2, float32, 10 + 10 in blocks of 5:
    the pass replayed as one CUDA graph a phase gives the eager pass's
    draws, log densities, depths, keys, counters, trips, passes and syncs
    bit for bit, and replays every pass."""
    lg, dim = logistic_regression_fused(device="cuda")
    c = 4096
    wcfg = WarmupConfig(min_iter=10, max_iter=10, block_size=5)
    scfg = SamplingConfig(min_iter=10, max_iter=10, block_size=5, max_step_halvings=8)
    keys = prng.fold_in(prng.key(61, cuda), torch.arange(c, device=cuda))
    theta = 0.5 * prng.normal(prng.key(62, cuda), (c, dim), torch.float32)
    ws = init_warmup_state(keys, theta, torch.ones_like(theta),
                           torch.full((c,), 0.1, device=cuda), wcfg, scfg)
    _assert_routes_bitwise(*_routes(monkeypatch, lg, ws, wcfg, scfg))


def test_graphed_pass_is_the_eager_pass_on_funnel_groups_card(cuda, monkeypatch):
    """funnel(101) x 4096, float32, 4 cost-sorted groups, 3 + 3 in blocks
    of one: every group replays its phase's one graph (the groups share a
    shape), and each route is the other bit for bit."""
    from walnuts_tpu_torch.models import funnel
    from walnuts_tpu_torch.ops.math import make_logp_grad

    c, dim = 4096, 101
    wcfg = WarmupConfig(min_iter=3, max_iter=3, block_size=1)
    scfg = SamplingConfig(min_iter=3, max_iter=3, block_size=1, max_step_halvings=8)
    keys = prng.fold_in(prng.key(63, cuda), torch.arange(c, device=cuda))
    theta = prng.normal(prng.key(64, cuda), (c, dim), torch.float32)
    ws = init_warmup_state(keys, theta, torch.ones_like(theta),
                           torch.full((c,), 0.2, device=cuda), wcfg, scfg)
    _assert_routes_bitwise(*_routes(monkeypatch, make_logp_grad(funnel(dim)[0]), ws,
                                    wcfg, scfg, batched_groups=4))
