"""The catalogue: BENCHMARK.json's cells, configurations, traffic mixes
and metrics are all found by name, and a new cell, configuration, traffic
mix and metric are found as new files and new entries, with no existing
file edited."""

import hashlib
import json
import re
import shutil
import time

import torch

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_is_found():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"], bench=bench)
        assert harness.load_driver(cell).run
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in (*cell.end_to_end, *cell.per_layer):
            assert harness.load_metric(harness.ROOT, m["name"]).read
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        assert json.loads((harness.ROOT / c["file"]).read_text())["name"] \
            == c["name"]


def test_names_and_units_keep_to_the_contract():
    bench = harness.load_benchmark()
    entries = [*bench["configs"], *bench["workloads"],
               *bench["end_to_end"], *bench["per_layer"]]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in (*bench["end_to_end"], *bench["per_layer"]):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def _tree(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_as_new_files_is_found(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = tmp_path / "benchmark"
    before = _tree(bench_dir)

    # a configuration, a traffic mix, a cell and a per-layer metric, each a
    # new file; BENCHMARK.json gains entries
    config = json.loads((bench_dir / "configs/jacobi7_512.json").read_text())
    config.update(name="jacobi7_small", interior=[10, 12, 8])
    (bench_dir / "configs/jacobi7_small.json").write_text(json.dumps(config))
    traffic = json.loads((bench_dir / "traffic/long.json").read_text())
    traffic.update(k=4, steps_per_call=8)
    (bench_dir / "traffic/short.json").write_text(json.dumps(traffic))
    (bench_dir / "cells/jacobi7_small.short.json").write_text(json.dumps({
        "config": "benchmark/configs/jacobi7_small.json",
        "traffic": "benchmark/traffic/short.json",
        "limits": {"relax_err": 1e-5}}))
    (bench_dir / "metrics/calls_per_s.short.py").write_text(
        "def read(record):\n"
        "    w = record['window']\n"
        "    return w['calls'] / w['s']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "jacobi7_small", "source": "a test",
                             "file": "benchmark/configs/jacobi7_small.json",
                             "reduced": ["interior"], "why": "a test"})
    bench["workloads"].append({"name": "jacobi7_small.short",
                               "config": "jacobi7_small", "traffic": "short",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "calls_per_s.short", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["jacobi7_small.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _tree(bench_dir)
    assert {k: after[k] for k in before} == before   # nothing edited
    cell = harness.find_cell("jacobi7_small.short", root=tmp_path)
    assert cell.config["interior"] == [10, 12, 8]
    assert cell.traffic["k"] == 4
    ctx = harness.Context(cell=cell, seed=5, seconds=0.2, trace=False,
                          device=torch.device("cpu"),
                          t_origin=time.perf_counter())
    record = harness.load_driver(cell).run(ctx)
    result = harness.result_line(cell, record, False, {"platform": "cpu"})
    assert result["correct"], result["checks"]
    # glups lists its cells; the new cell reads setup_s and its own metric
    assert set(result["metrics"]) == {"setup_s", "calls_per_s.short"}
    # the cells already there are found as before
    assert harness.find_cell("poisson_511.pcg", root=tmp_path).config \
        == harness.find_cell("poisson_511.pcg").config


def test_a_cell_file_that_disagrees_with_its_entry_is_refused(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell_file = tmp_path / "benchmark/cells/jacobi7_512.long.json"
    cell = json.loads(cell_file.read_text())
    cell["traffic"] = "benchmark/traffic/step.json"
    cell_file.write_text(json.dumps(cell))
    try:
        harness.find_cell("jacobi7_512.long", root=tmp_path)
    except harness.BenchmarkError as e:
        assert "traffic" in str(e)
    else:
        raise AssertionError("a cell file naming another traffic was taken")
