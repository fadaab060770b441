"""The benchmark's files: every cell, configuration, traffic mix, limit
file and metric is found by its name, and ``BENCHMARK.json`` keeps the
shape the harness reads."""

import json
import re

import pytest

from portbench.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.traffic["chains"] > 0
    mod = spec.model_module(c)
    for attr in ("LIBRARIES", "build", "collect", "compare", "flops_per_grad"):
        assert hasattr(mod, attr)
    assert c.limits, "every cell has limits"
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads_by_name(metric):
    assert callable(spec.metric_reader(metric))


def test_names_units_and_keys():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_and_reduced_keys(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("portbench/")
    data = json.loads((spec.ROOT / conf["file"]).read_text())
    published = data.get("published", {})
    for key in conf["reduced"]:
        assert NAME.match(key)
        assert not key.endswith(("_dim", "_rank"))
        assert key in data and published.get(key) not in (None, data[key])
    assert sorted(published) == sorted(set(published) & set(data))
    for key, value in published.items():
        assert key in conf["reduced"] or data[key] == value
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


def test_every_file_name_uses_name_characters():
    for path in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
