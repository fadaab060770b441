"""The port's fused tier-2 pass against the JAX package's (CPU, float64).

One pass: synthetic lane states made with NumPy (pending and idle lanes,
n_ends up to 12, merge counts over every stack slot, max_depth 3 and 5,
completions at the run-ahead cap and at the block end) go through the
reference's ``fused_pass_call`` in interpret mode, packed as
``walnuts_tpu/core/batched.py`` packs them, and through the port's
``fused_pass`` on CPU tensors (its plain version). Integers, flags and keys
must be equal; floats agree to rtol 1e-10 (the restart's normals are within
a few ulp of ``jax.random.normal``, and the momentum energy sums in another
order). Completed draws are banked at the draw index whose ring slot the
reference writes.

The slice: ``run_sampling(pallas_pass=True)`` against the reference's
``run_sampling(batched=True, pallas_pass=True)`` from the same states, and
the port's fused route against its unfused route, bit for bit, for several
run-ahead depths and tier-2 cadences. The direction bit is compared in
float64 only: under x64 the reference draws it from a float64 uniform
whatever the state's dtype, the port from the state's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walnuts_tpu.config import SamplingConfig, WarmupConfig
from walnuts_tpu.core.sampler import freeze_params, init_sample_state, init_warmup_state
from walnuts_tpu.models import funnel as jax_funnel
from walnuts_tpu.ops.fused_pass import fused_pass_call
from walnuts_tpu.ops.math import make_logp_grad as jax_logp_grad
from walnuts_tpu.parallel.runtime import run_sampling as jax_run_sampling
from walnuts_tpu_torch import convert
from walnuts_tpu_torch.config import SamplingConfig as TSamplingConfig
from walnuts_tpu_torch.core import batched
from walnuts_tpu_torch.models import funnel
from walnuts_tpu_torch.ops import fused_pass as fp
from walnuts_tpu_torch.ops.math import make_logp_grad
from walnuts_tpu_torch.parallel.runtime import run_sampling

C = 64
B = 8  # the reference's ring depth in the single-pass check


def _pack(s, p, cap):
    """The reference fused pass's operands (walnuts_tpu/core/batched.py
    1054-1096), in NumPy."""
    cm = lambda x: np.moveaxis(x, 0, -1)
    stk3 = lambda *xs: np.stack([x.T for x in xs], 0)
    fpk = np.stack([s[n] for n in convert._PACK_F], 0)
    ipk = np.stack([s[n] for n in convert._PACK_I], 0)
    bpk = np.stack([s[n] for n in convert._PACK_B], 0)
    upk = np.concatenate([s["key"].T, s["ku"].T], 0)
    rows = {k: stk3(*(s[n] for n in names))
            for k, names in convert._PACK_ROWS.items()}
    one = {k: cm(s[n]) for k, n in convert._PACK_ROW.items()}
    rof = np.stack([s["fwd_logp_pos"], s["fwd_joint"], p["step"]], 0)
    return dict(fp=fpk, ip=ipk, bp=bpk, up=upk, acc_v=rows["acc_v"],
                agb=one["agb"], ags=one["ags"], agf=one["agf"],
                stack_e=cm(s["stack_e"]), run_sel=one["run_sel"],
                rsg=one["rsg"], ms=rows["ms"], cur=rows["cur"],
                fwd=rows["fwd"], inv_mass=cm(p["inv_mass"]), rof=rof,
                mm=p["min_micro"][None], cap=np.full((1, 1), cap, np.int32))


@pytest.mark.parametrize("D,max_depth,cap,R", [(11, 3, 4, 6), (25, 5, 6, 6)])
def test_one_pass_matches_reference(D, max_depth, cap, R):
    s, p = fp.synthetic_pass_inputs(C, D, max_depth, R, seed=D + max_depth)
    ops = _pack(s, p, cap)
    bt = np.zeros((B, D, C))
    bl = np.full((B, C), -np.inf)
    bd = np.zeros((B, C), np.int32)
    n_slots = max(max_depth - 1, 1)
    j = fused_pass_call(
        *(jnp.asarray(ops[k]) for k in ("fp", "ip", "bp", "up", "acc_v", "agb",
                                        "ags", "agf", "stack_e", "run_sel",
                                        "rsg", "ms", "cur")),
        jnp.asarray(bt), jnp.asarray(bl), jnp.asarray(bd),
        *(jnp.asarray(ops[k]) for k in ("fwd", "inv_mass", "rof", "mm", "cap")),
        max_depth=max_depth, n_slots=n_slots, B=B, R=R, ct=32, interpret=True)
    j = [np.asarray(x) for x in j]
    want = convert.lane_state_from_pass(*j[:13], ops["fwd"], ops["rof"])
    bt, bl, bd = j[13:]

    st = convert.lane_state_from_fields(s)
    t = lambda x: torch.from_numpy(np.array(x))
    draws = torch.zeros((R, C, D), dtype=torch.float64)
    logps = torch.zeros((R, C), dtype=torch.float64)
    depths = torch.zeros((R, C), dtype=torch.int32)
    fp.fused_pass(st, t(p["step"]), t(p["inv_mass"]), t(p["min_micro"]), cap,
                  R, max_depth, (draws, logps, depths))

    for name in fp.RW_FIELDS:
        got = fp.lane_field(st, name).numpy()
        ref = fp.lane_field(want, name).numpy()
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, rtol=1e-10, err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)

    # banking: the reference's ring slot is the draw index mod B
    done0 = s["draws_done"]
    done1 = st.draws_done.numpy()
    comp = done1 > done0
    idx = done1 - 1
    lanes = np.nonzero(comp)[0]
    np.testing.assert_allclose(draws.numpy()[idx[lanes], lanes],
                               bt[idx[lanes] % B, :, lanes], rtol=1e-10)
    np.testing.assert_allclose(logps.numpy()[idx[lanes], lanes],
                               bl[idx[lanes] % B, lanes], rtol=1e-10)
    np.testing.assert_array_equal(depths.numpy()[idx[lanes], lanes],
                                  bd[idx[lanes] % B, lanes])
    banked = np.zeros((R, C), bool)
    banked[idx[lanes], lanes] = True
    assert not draws.numpy()[~banked].any() and not depths.numpy()[~banked].any()

    # the states exercise every outcome of the pass
    depth0, depth1 = s["depth"], st.depth.numpy()
    restart = comp & (done1 < R)
    assert restart.any() and (comp & (done1 == cap)).any()
    assert ((depth1 == depth0 + 1) & ~comp).any()                  # deeper
    assert ((st.leaf_idx.numpy() == s["leaf_idx"] + 1) & (depth1 == depth0)).any()
    assert (st.fails.n_depth_exhausted.numpy() > s["n_depth_exhausted"]).any()
    assert (s["n_ends"] == 12).any()
    if cap == R:
        assert (comp & ~restart).any()                             # block end


# ---------------------------------------------------------------------------
# the slice: run_sampling with the fused pass
# ---------------------------------------------------------------------------

DRAWS = 20


def _np_tree(tree):
    return jax.tree.map(
        lambda x: np.asarray(jax.random.key_data(x))
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else np.asarray(x),
        tree)


@pytest.fixture(scope="module")
def start():
    """Funnel(11), 32 chains: an unadapted start (step 0.3, unit mass)
    and the reference's fused-pass sampling run from it."""
    logp, dim = jax_funnel(11)
    lg = jax_logp_grad(logp)
    n = 32
    wcfg = WarmupConfig(min_iter=0, max_iter=0, block_size=10)
    scfg = SamplingConfig(min_iter=DRAWS, max_iter=DRAWS, block_size=10,
                          max_step_halvings=6, max_trajectory_doublings=5)
    base = jax.random.key(5)
    keys = jax.vmap(lambda c: jax.random.fold_in(base, c))(jnp.arange(n))
    theta0 = jax.random.normal(jax.random.fold_in(base, 99), (n, dim))
    ws = jax.vmap(lambda k, t: init_warmup_state(
        k, t, jnp.ones(dim), jnp.asarray(0.3), wcfg, scfg))(keys, theta0)
    params = jax.vmap(freeze_params)(ws)
    ss = jax.vmap(init_sample_state)(ws)
    ref = jax_run_sampling(lg, ss, params, scfg, batched=True, pallas_pass=True,
                           pass_tile=32)
    return dict(ss=_np_tree(ss), params=_np_tree(params), ref=_np_tree(ref[:3]),
                info=ref[3])


def _port_run(start, draws=DRAWS, **kw):
    scfg = TSamplingConfig(min_iter=draws, max_iter=draws, block_size=10,
                           max_step_halvings=6, max_trajectory_doublings=5)
    ss = convert.sample_state(start["ss"])
    params = convert.frozen_params(start["params"])
    return run_sampling(make_logp_grad(funnel(11)[0]), ss, params, scfg, **kw)


@pytest.fixture(scope="module")
def fused(start):
    return _port_run(start, pallas_pass=True)


def test_run_sampling_fused_matches_reference(start, fused):
    (jss, jd, jl), ji = start["ref"], start["info"]
    ss, d, lp, info = fused
    np.testing.assert_array_equal(convert.key_data_numpy(ss.key), jss.key)
    np.testing.assert_array_equal(ss.n_grads.numpy(), jss.n_grads)
    for a, b in zip(ss.fails, jss.fails):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(lp.numpy(), jl, rtol=1e-10)
    assert info.sampling_iters == ji.sampling_iters == DRAWS
    assert info.n_outer_trips["sampling"] > 0


@pytest.mark.parametrize("B_,K", [(2, 3), (4, 6), (8, 1)])
def test_fused_route_equals_unfused_route(start, fused, B_, K):
    """The fused route (fused_pass's plain version on the CPU) and the
    unfused route give the same chain bit for bit, whatever the run-ahead
    depth and tier-2 cadence (a 6-draw run is the start of the 20-draw
    fused run: a lane's draws do not depend on the block's length)."""
    a = _port_run(start, 6, runahead=B_, tier2_every=K)
    b = _port_run(start, 6, runahead=B_, tier2_every=K, pallas_pass=True)
    for x, y in ((a[1], b[1]), (a[2], b[2]), (a[1], fused[1][:6]),
                 (a[2], fused[2][:6])):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    np.testing.assert_array_equal(a[0].key.numpy(), b[0].key.numpy())
    np.testing.assert_array_equal(a[0].n_grads.numpy(), b[0].n_grads.numpy())
    for f, g in zip(a[0].fails, b[0].fails):
        np.testing.assert_array_equal(f.numpy(), g.numpy())


def test_fused_pass_refuses_warmup():
    lg = make_logp_grad(funnel(5)[0])
    with pytest.raises(ValueError, match="adapt_full"):
        batched.make_batched_sample_block(lg, 10, 5, adapt_full=True,
                                          pallas_pass=True)


def test_fused_pass_refuses_bad_operands():
    s, p = fp.synthetic_pass_inputs(C, 5, 3, 4, seed=1)
    st = convert.lane_state_from_fields(s)
    t = lambda x: torch.from_numpy(np.array(x))
    args = (t(p["step"]), t(p["inv_mass"]), t(p["min_micro"]), 3, 4, 3)
    out = lambda: (torch.zeros((4, C, 5), dtype=torch.float64),
                   torch.zeros((4, C), dtype=torch.float64),
                   torch.zeros((4, C), dtype=torch.int32))
    with pytest.raises(ValueError, match="depth"):
        fp.fused_pass(st._replace(depth=st.depth.long()), *args, out())
    with pytest.raises(ValueError, match="ms_rho"):
        fp.fused_pass(st._replace(ms_rho=st.ms_rho.float()), *args, out())
    with pytest.raises(ValueError, match="not contiguous"):
        fp.fused_pass(st._replace(run_sel=st.run_sel.t().contiguous().t()),
                      *args, out())
    with pytest.raises(ValueError, match="share memory"):
        fp.fused_pass(st._replace(acc_th_fw=st.acc_th_bk), *args, out())
    with pytest.raises(ValueError, match="share memory"):  # read-only alias
        fp.fused_pass(st._replace(fwd_th=st.cur_th), *args, out())
    with pytest.raises(ValueError, match="pass_tile"):
        fp.fused_pass(st, *args, out(), pass_tile=64)
    # a fresh block state shares one tensor among many fields: the
    # unfused factory's is refused, the fused factory's owns its storage
    lg = make_logp_grad(funnel(5)[0])
    theta = torch.randn((C, 5), dtype=torch.float64)
    key = convert.key_data_torch(s["key"])
    step, im, mm = args[0], args[1], args[2]
    zero = torch.zeros(C, dtype=torch.int32)
    fails = batched.FailStats(zero, zero.clone(), zero.clone())
    for pallas, ok in ((False, False), (True, True)):
        start_blk, _ = batched.make_batched_sample_block(
            lg, 3, 5, pallas_pass=pallas)
        st0 = start_blk(key, theta, zero, fails, step, im, mm)
        if ok:
            fp.fused_pass(st0, step, im, mm, 3, 4, 3, out())
        else:
            with pytest.raises(ValueError, match="share memory"):
                fp.fused_pass(st0, step, im, mm, 3, 4, 3, out())
