"""What the benchmark loads: no JAX and not the package the program was
ported from (top-level names compared whole: the program's own name,
``walnuts_tpu_torch``, begins with ``walnuts_tpu``), and a reference that
loads nothing of the program."""

import subprocess
import sys

from portbench.harness import main, spec

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
sys.argv = ["run.py"]
import runpy
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level(body: str) -> set:
    code = PROBE.format(root=str(spec.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(spec.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_run_and_every_cell_module_load_no_jax():
    body = """
runpy.run_path("portbench/run.py", run_name="portbench_probe")
from portbench.harness import spec, window, trace, compare
import walnuts_tpu_torch.parallel.runtime, walnuts_tpu_torch.core.batched
import walnuts_tpu_torch.ops.logreg_fused, walnuts_tpu_torch.models.targets
for w in __import__("json").load(open("BENCHMARK.json"))["workloads"]:
    cell = spec.load_cell(w["name"])
    spec.model_module(cell)
    for m in cell.end_to_end + cell.per_layer:
        spec.metric_reader(m["name"])
"""
    names = _top_level(body)
    assert "walnuts_tpu_torch" in names and "portbench" in names
    assert not names & set(main.FORBIDDEN), names & set(main.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _top_level("import portbench.reference.logreg, portbench.reference.ess")
    assert not names & {"walnuts_tpu_torch", "walnuts_tpu", "jax", "jaxlib"}


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "walnuts_tpu_torch_extra", sys)
    assert "walnuts_tpu" not in main.forbidden_modules()
    monkeypatch.setitem(sys.modules, "walnuts_tpu.api", sys)
    assert "walnuts_tpu" in main.forbidden_modules()
