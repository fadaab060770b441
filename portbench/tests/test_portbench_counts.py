"""Operations, bytes, rooflines and mfu counted from shapes."""

import math

import pytest

from portbench.harness import peaks, spec

LOGREG = spec.load_module(spec.BENCH_DIR / "models" / "logreg.py", "t_logreg")


def _record(**kw):
    rec = {"config": {"num_rows": 65536, "dim": 29}, "chains": 4096, "window_s": 50.0,
           "setup_s": 10.0, "warmup_s": 30.0,
           "counters": {"grads": 3_000_000, "trips": 10_000, "passes": 1_000, "syncs": 12_000,
                        "sampling_iters": 25},
           "ess": {"median": 50_000.0, "min": 30_000.0, "draws": 245_760},
           "flops_per_grad": LOGREG.flops_per_grad({"num_rows": 65536, "dim": 29}),
           "trace": None}
    rec.update(kw)
    return rec


def test_logreg_flops_per_grad():
    assert LOGREG.flops_per_grad({"num_rows": 65536, "dim": 29}) == (
        4 * 65536 * 29 + 12 * 65536 + 3 * 29)


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_mfu_from_shapes():
    rec = _record()
    want = 100 * rec["flops_per_grad"] * 3_000_000 / (50.0 * 67e12)
    assert spec.metric_reader("mfu")(rec) == pytest.approx(want)


def test_logreg_roofline_from_a_trace():
    # 10 launches of 2.7 ms each over 4096 chains, 65536 rows, 29 features
    rec = _record(trace={"kernels": {"void logreg_kernel<4>(...)": [10, 0.027]},
                         "busy_s": 0.5, "window_s": 1.0})
    flops = 4 * 4096 * 65536 * 29
    want = 100 * (flops / 67e12) / 0.0027
    assert spec.metric_reader("logreg_vg_roofline")(rec) == pytest.approx(want)
    assert spec.metric_reader("device_idle")(rec) == pytest.approx(50.0)


def test_replay_roofline_from_a_trace():
    rec = _record(trace={"kernels": {"replay_kernel": [4, 8e-6]}, "busy_s": 1.0,
                         "window_s": 1.0})
    want = 100 * (40 * 4096 / 3.35e12) / 2e-6
    assert spec.metric_reader("replay_roofline")(rec) == pytest.approx(want)


def test_readers_find_nothing_without_a_trace():
    rec = _record()
    for name in ("logreg_vg_roofline", "replay_roofline", "device_idle"):
        assert spec.metric_reader(name)(rec) is None


def test_counter_ratios():
    rec = _record()
    r = {n: spec.metric_reader(n)(rec) for n in (
        "syncs_per_trip", "lane_occupancy", "ms_per_trip", "passes_per_trip",
        "grads_per_s", "warmup_s", "setup_s")}
    assert r["syncs_per_trip"] == pytest.approx(1.2)
    assert r["lane_occupancy"] == pytest.approx(100 * 3e6 / (1e4 * 4096))
    assert r["ms_per_trip"] == pytest.approx(5.0)
    assert r["passes_per_trip"] == pytest.approx(0.1)
    assert r["grads_per_s"] == pytest.approx(60_000)
    assert r["warmup_s"] == 30.0 and r["setup_s"] == 10.0
    warm_only = _record(ess=None)
    warm_only["counters"] = dict(warm_only["counters"], sampling_iters=0)
    assert spec.metric_reader("warmup_s")(warm_only) is None


def test_trace_reduction_unions_overlaps():
    from portbench.harness.trace import reduce_intervals

    ev = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 22, 25), ("e", 40, 41)]
    busy, kernels, gaps = reduce_intervals(ev)
    assert busy == pytest.approx(26e-9)
    assert kernels["a"] == [1, pytest.approx(10e-9)]
    assert [name for _, name in gaps] == ["e", "c"]
    assert math.isclose(gaps[0][0], 10e-9)
