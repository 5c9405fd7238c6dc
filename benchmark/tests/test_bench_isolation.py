"""Neither JAX nor the JAX package is loaded by the harness, its drivers,
its metrics or the program they drive; and a run refuses to give a result
without a card."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

PROBE = r"""
import json, sys, time
sys.path.insert(0, BENCH_ROOT)
import torch
from benchmark import calibrate, harness, reference, roofline, run, trace
bench = harness.load_benchmark()
small = {"jacobi7_512": [12, 10, 14], "poisson_511": [15, 15, 15]}
for w in bench["workloads"]:
    cell = harness.find_cell(w["name"], bench=bench)
    cell = cell.with_config(interior=small[cell.config_name])
    for m in (*cell.end_to_end, *cell.per_layer):
        harness.load_metric(harness.ROOT, m["name"])
    ctx = harness.Context(cell=cell, seed=3, seconds=0.05, trace=False,
                          device=torch.device("cpu"),
                          t_origin=time.perf_counter())
    harness.load_driver(cell).run(ctx)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.replace("BENCH_ROOT", repr(str(harness.ROOT)))],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "stencil_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES), \
        tops & set(harness.FORBIDDEN_MODULES)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "stencil_tpu_torch_fake", object())
    for name in harness.FORBIDDEN_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "stencil_tpu.ops", object())
    assert harness.forbidden_modules() == ["stencil_tpu"]


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        return  # this machine has a card: the refusal cannot show here
    out = subprocess.run(
        [sys.executable, str(harness.ROOT / "benchmark/run.py"),
         "--workload", "jacobi7_512.long", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


EMIT = r"""
import sys, time
sys.path[:0] = [COPY]
sys.path.append(REPO)
import torch
from benchmark import harness, run
cell = harness.find_cell("jacobi7_512.long").with_config(interior=[12, 10, 14])
ctx = harness.Context(cell=cell, seed=2 ** 31 + 9, seconds=0.05, trace=False,
                      device=torch.device("cpu"), t_origin=time.perf_counter())
record = harness.load_driver(cell).run(ctx)
sys.exit(run.emit(cell, record, False, {"platform": "cpu"}))
"""


@pytest.mark.parametrize("loads", ["jax", "stencil_tpu", None])
def test_a_metric_reader_that_loads_jax_gives_no_result(tmp_path, loads):
    """A reader added as a new file loads after the window; a forbidden
    module it brings in still keeps the run from printing a result."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    fake = tmp_path / "fake_modules"
    for name in ("jax", "stencil_tpu"):
        (fake / name).mkdir(parents=True)
        (fake / name / "__init__.py").write_text("")   # stand-ins
    body = "def read(record):\n    return 1.0\n"
    if loads:
        body = (f"import sys\nsys.path.insert(0, {str(fake)!r})\n"
                f"import {loads}  # noqa: F401\n\n" + body)
    (tmp_path / "benchmark/metrics/added.py").write_text(body)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "added", "unit": "1", "bound": 0.05,
                                "better": "higher", "source": "host_clock",
                                "workloads": ["jacobi7_512.long"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = EMIT.replace("COPY", repr(str(tmp_path))) \
        .replace("REPO", repr(str(harness.ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    if loads:
        assert out.returncode == 1, out.stderr[-2000:]
        assert out.stdout.strip() == ""
        assert f"['{loads}']" in out.stderr
    else:
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["metrics"]["added"]["value"] == 1.0
        assert result["correct"]
