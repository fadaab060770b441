"""A run with the timed path broken underneath comes out not correct, and
so does the control.

Each test skips the look for a card and drives the rest of a run
(``harness.main.run_cell``) on the CPU at a small size, with one fault
planted in the program: a step that returns its state unchanged, half of
a model evaluation's batch left out and filled with the mean of the rest,
or every draw altered where it is produced. The cell's own limits judge
the result. The control (the reference in the precision below the
configuration's, in the program's place) is judged the same way. These
cells run on one card, so no exchange between cards can be left out.
A traced run times and counts its window as an untraced run does.
"""

import dataclasses
import json
import time

import pytest
import torch

from portbench.harness import main, spec


def _small(name: str) -> spec.Cell:
    cell = spec.load_cell(name)
    cfg, tr = dict(cell.config), json.loads(json.dumps(cell.traffic))
    cfg["num_rows"] = 2000
    tr.update(chains=64)
    tr["sampling"].update(block=20, max_iter=40)
    tr["check"].update(draws=256, proposals=8192)
    return dataclasses.replace(cell, config=cfg, traffic=tr)


def _run(cell, variants=(), trace=False):
    torch.manual_seed(0)
    # seconds 0: the sampling stops at its first block boundary
    return main.run_cell(cell, 2**31 + 21, 0.0, trace, "cpu", time.perf_counter(),
                         log=lambda s: None, variants=variants)


def _plant_stuck(mp):
    """Every block returns the state it was given: its draws are the
    block's starting points, with their log densities."""
    from walnuts_tpu_torch.parallel import runtime

    make_s, make_w = runtime.make_batched_sample_block, runtime.make_batched_warmup_block

    def sample_factory(logp_grad, *a, **k):
        start_blk, sample_blk = make_s(logp_grad, *a, **k)
        held = {}

        def start(key, theta, *rest):
            held["theta"] = theta.clone()
            return start_blk(key, theta, *rest)

        def sample(st, *rest, out=None):
            res = sample_blk(st, *rest, out=out)
            res.draws[:] = held["theta"]
            res.logps[:] = logp_grad(held["theta"])[0]
            return res

        return start, sample

    def warmup_factory(logp_grad, *a, **k):
        block = make_w(logp_grad, *a, **k)

        def warm(ws, n, out=None):
            new, res = block(ws, n, out)
            res.draws[:] = ws.theta
            res.logps[:] = logp_grad(ws.theta)[0]
            return new._replace(theta=ws.theta.clone()), res

        return warm

    mp.setattr(runtime, "make_batched_sample_block", sample_factory)
    mp.setattr(runtime, "make_batched_warmup_block", warmup_factory)


def _halve(lp, g):
    h = lp.shape[0] // 2
    lp, g = lp.clone(), g.clone()
    lp[h:] = lp[:h].mean()
    g[h:] = g[:h].mean(dim=0)
    return lp, g


def _plant_half(mp):
    """Half of every model evaluation's chains left out, given the mean of
    the rest."""
    from walnuts_tpu_torch.ops import logreg_fused, math as wmath

    value_grad, make = logreg_fused.logreg_value_grad, wmath.make_logp_grad
    mp.setattr(logreg_fused, "logreg_value_grad", lambda t, x, y: _halve(*value_grad(t, x, y)))
    mp.setattr(wmath, "make_logp_grad", lambda fn: (lambda t: _halve(*make(fn)(t))))


def _plant_altered(mp):
    """Every draw moved by 0.25 where the block produces it; its log
    density is the one the sampler computed."""
    from walnuts_tpu_torch.parallel import runtime

    make_s, make_w = runtime.make_batched_sample_block, runtime.make_batched_warmup_block

    def sample_factory(*a, **k):
        start_blk, sample_blk = make_s(*a, **k)

        def sample(st, *rest, out=None):
            res = sample_blk(st, *rest, out=out)
            res.draws.add_(0.25)
            return res

        return start_blk, sample

    def warmup_factory(*a, **k):
        block = make_w(*a, **k)

        def warm(ws, n, out=None):
            new, res = block(ws, n, out)
            res.draws.add_(0.25)
            return new, res

        return warm

    mp.setattr(runtime, "make_batched_sample_block", sample_factory)
    mp.setattr(runtime, "make_batched_warmup_block", warmup_factory)


FAULTS = {"stuck": _plant_stuck, "half": _plant_half, "altered": _plant_altered}
CELLS = ["logreg-higgs.job"]
#: the numbers each fault must move past its limit, by model
CATCH = {"logreg": {"stuck": ("mean_gap", "sd_gap"), "half": ("lp_gap", "grad_gap"),
                    "altered": ("lp_gap",)}}


@pytest.fixture(scope="module")
def sound():
    return {name: _run(_small(name), variants=("control",)) for name in CELLS}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_holds_the_model_numbers(sound, name):
    cell = _small(name)
    got = sound[name]["readings"]
    for key in ("lp_gap", "grad_gap"):
        assert got[key] <= cell.limits[key], (key, got[key])
    assert sound[name]["nonfinite_draws"] == 0
    assert 0 <= sound[name]["failed"] <= sound[name]["attempted"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(sound, name):
    cell = _small(name)
    correct, checks = main.judge(sound[name]["variants"]["control"], cell.limits)
    assert not correct, checks


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, sound, name, fault):
    cell = _small(name)
    FAULTS[fault](monkeypatch)
    got = _run(cell)["readings"]
    correct, checks = main.judge(got, cell.limits)
    assert not correct, checks
    for key in CATCH[cell.config["model"]][fault]:
        assert got[key] > cell.limits[key], (key, got[key])
        assert got[key] > sound[name]["readings"][key], (key, got[key])


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_times_its_window_as_an_untraced_run(sound, name):
    """The profiled slice runs after the window: the traced run's counters
    are the untraced run's, and the slice found device activity."""
    traced = _run(_small(name), trace=True)
    rec, plain = traced["record"], sound[name]["record"]
    assert rec["counters"] == plain["counters"]
    assert rec["trace"]["busy_s"] > 0 and rec["trace"]["window_s"] > 0
    assert traced["readings"] == sound[name]["readings"]
