"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout names every cell
(``workloads``), its configuration and its traffic mix, and the metrics of
each kind. Each piece is a file of its own under ``portbench/``:

- ``configs/<config>.json``: the configuration as it is run; its ``model``
  names the module ``models/<model>.py`` that builds the program's model
  and its inputs and holds the correctness comparison.
- ``traffic/<traffic>.json``: the job: chains, phases, block sizes, the
  traced slice, the sample the comparison draws.
- ``limits/<cell>.json``: the limit of each number the comparison reads.
- ``metrics/<metric>.py``: a ``read(record)`` that returns the metric's
  value, or None where the record holds nothing to read.

Adding a cell or a metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The module of the Python file ``path``, imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    files read."""
    if bench is None:
        bench = _load_json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    # a per-layer metric belongs to the cell if it lists the cell, or,
    # listing none, if the cell reports the end-to-end metric it moves
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=_load_json(ROOT / conf["file"]),
        traffic=_load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per,
    )


def model_module(cell: Cell) -> ModuleType:
    """``models/<model>.py`` of the cell's configuration."""
    model = cell.config["model"]
    return load_module(BENCH_DIR / "models" / f"{model}.py", f"portbench_model_{model}")


def metric_reader(name: str):
    """The ``read`` of ``metrics/<name>.py``."""
    mod = load_module(BENCH_DIR / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read
