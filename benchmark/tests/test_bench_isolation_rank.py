"""A run of every cell of ``BENCHMARK.json``, each shrunk by the rank of its
interior (not by its configuration's name, so a cell added later is covered
too), loads neither JAX nor the JAX package."""

import json
import subprocess
import sys

from benchmark import harness

PROBE = r"""
import dataclasses, json, sys, time
sys.path.insert(0, BENCH_ROOT)
import torch
from benchmark import harness
bench = harness.load_benchmark()
small = {2: [40, 56], 3: [15, 15, 15]}
ran = []
for w in bench["workloads"]:
    cell = harness.find_cell(w["name"], bench=bench)
    cell = cell.with_config(interior=small[len(cell.config["interior"])])
    if "steps_per_call" in cell.traffic:
        steps = min(int(cell.traffic["steps_per_call"]), 8)
        cell = dataclasses.replace(
            cell, traffic={**cell.traffic, "steps_per_call": steps})
    for m in (*cell.end_to_end, *cell.per_layer):
        harness.load_metric(harness.ROOT, m["name"])
    ctx = harness.Context(cell=cell, seed=3, seconds=0.05, trace=False,
                          device=torch.device("cpu"),
                          t_origin=time.perf_counter())
    harness.load_driver(cell).run(ctx)
    ran.append(w["name"])
print(json.dumps([ran, sorted({m.split(".")[0] for m in sys.modules})]))
"""


def test_every_cell_sized_by_rank_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.replace("BENCH_ROOT", repr(str(harness.ROOT)))],
        capture_output=True, text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    ran, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert ran == [w["name"] for w in harness.load_benchmark()["workloads"]]
    assert "stencil_tpu_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN_MODULES), \
        set(tops) & set(harness.FORBIDDEN_MODULES)
