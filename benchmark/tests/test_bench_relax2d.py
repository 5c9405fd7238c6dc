"""The 2D cell ``jacobi9_4096.long2d`` on the CPU, shrunk: a sound run reads
correct and runs the 2D path, planted faults read not correct, the frozen
count of its launch is the hand count, its check gives a number in fp32
and a larger one in bf16, and neither its reference nor a run of it loads
JAX or the JAX package (the reference loads nothing of the program)."""

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import calibrate, harness, roofline

CELL = "jacobi9_4096.long2d"
SMALL = [40, 56]
STEPS = 16      # 4 launches of k=4 a call
SEED = 2 ** 31 + 77


def small_cell():
    cell = harness.find_cell(CELL).with_config(interior=SMALL)
    return dataclasses.replace(
        cell, traffic={**cell.traffic, "steps_per_call": STEPS})


def context(cell, seed=SEED, seconds=0.3):
    return harness.Context(cell=cell, seed=seed, seconds=seconds,
                           trace=False, device=torch.device("cpu"),
                           t_origin=time.perf_counter())


def run_small():
    cell = small_cell()
    record = harness.load_driver(cell).run(context(cell))
    return harness.result_line(cell, record, False, {"platform": "cpu"})


def test_sound_run_is_correct():
    result = run_small()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert set(result["checks"]) == {"relax_err.first", "relax_err.drawn",
                                     "relax_err.last"}
    assert set(result["metrics"]) == {"glups", "setup_s"}


def test_the_cell_runs_the_2d_path():
    cell = small_cell()
    driver = harness.load_driver(cell)
    state = driver.prepare(context(cell))
    assert state.runner.granularity == cell.config["k"] == 4
    assert state.runner.plan_info["kernel"] == "slab"
    assert state.runner.plan_info["tiles"][0] == min(
        cell.config["block"], SMALL[0])


def _pad_d0_wins():
    """The runner's padded input with d0's walls in the corners."""
    from stencil_tpu_torch.ops.layout import PaddedLayout

    sound = PaddedLayout.pad

    def pad(self, interior, bc):
        padded = sound(self, interior, bc)
        h = self.halo
        lo, hi = bc.values[0]
        padded[:h] = lo
        padded[-h:] = hi
        return padded

    return PaddedLayout, pad


def _iterate(kind):
    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.ops.sweep_kernel import KernelStencil

    sound = KernelStencil.iterate

    def iterate(self, grid, iterations):
        if kind == "unchanged":
            return HaloGrid(data=grid.data.clone(), halo=grid.halo,
                            bc=grid.bc)
        out = sound(self, grid, iterations)
        c = tuple(n // 2 for n in out.interior_shape)
        out.interior()[c] += 1e-3 * (1 + abs(float(out.interior()[c])))
        return out

    return KernelStencil, iterate


@pytest.mark.parametrize("kind", ["unchanged", "corners_d0", "altered"])
def test_fault_is_not_correct(kind, monkeypatch):
    owner, broken = _pad_d0_wins() if kind == "corners_d0" \
        else _iterate(kind)
    monkeypatch.setattr(owner, broken.__name__, broken)
    result = run_small()
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_launch_count_is_the_hand_count():
    cfg = harness.find_cell(CELL).config
    one = roofline.Launch(shape=tuple(cfg["interior"]),
                          radius=cfg["radius"], sweeps=cfg["k"],
                          flops_per_point=cfg["flops_per_point"])
    assert one.nbytes == 4 * (4098 ** 2 + 4096 ** 2) == 134_283_280
    assert one.ops == 4096 ** 2 * 4 * 8
    assert one.bound_s == pytest.approx(134_283_280 / 3.35e12)
    assert round(one.bound_s * 1e3, 4) == 0.0401   # PERF.md's B2-cfg2
    driver = harness.load_driver(harness.find_cell(CELL))
    counts = dict.fromkeys(["launches", *driver.OTHER_MODES], 0)
    counts["launches"] = 768
    ctx = context(harness.find_cell(CELL))
    assert driver.launch_work(ctx, counts) == [
        {"mode": "homogeneous", "count": 768, "bytes": one.nbytes,
         "ops": one.ops, "bound_s": one.bound_s}]
    counts["source_launches"] = 1
    assert driver.launch_work(ctx, counts) is None


def test_reading_and_control():
    cell = small_cell()
    driver = harness.load_driver(cell)
    sound = driver.reading(context(cell))
    control = driver.reading(context(cell), cell.config["control_dtype"])
    assert 0 < sound < control
    rows = calibrate.readings(cell, [SEED], None, torch.device("cpu"))
    rows += calibrate.readings(cell, [SEED], cell.config["control_dtype"],
                               torch.device("cpu"))
    assert [r["dtype"] for r in rows] == ["float32", "bfloat16"]
    assert rows[0]["value"] == sound and rows[1]["value"] == control


PROBE = r"""
import json, sys, time, dataclasses
sys.path.insert(0, BENCH_ROOT)
from benchmark import reference2d
ref_only = sorted({m.split(".")[0] for m in sys.modules})
import torch
from benchmark import harness
cell = harness.find_cell(CELL).with_config(interior=SMALL)
cell = dataclasses.replace(cell, traffic={**cell.traffic,
                                          "steps_per_call": 8})
for m in (*cell.end_to_end, *cell.per_layer):
    harness.load_metric(harness.ROOT, m["name"])
ctx = harness.Context(cell=cell, seed=3, seconds=0.05, trace=False,
                      device=torch.device("cpu"),
                      t_origin=time.perf_counter())
harness.load_driver(cell).run(ctx)
print(json.dumps([ref_only, sorted({m.split(".")[0] for m in sys.modules})]))
"""


def test_reference_and_run_load_no_jax_and_reference_no_program():
    code = (PROBE.replace("BENCH_ROOT", repr(str(harness.ROOT)))
            .replace("CELL", repr(CELL)).replace("SMALL", repr(SMALL)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    ref_only, run = map(set, json.loads(out.stdout.strip().splitlines()[-1]))
    assert "benchmark" in ref_only
    assert not ref_only & {"stencil_tpu_torch", *harness.FORBIDDEN_MODULES}
    assert "stencil_tpu_torch" in run
    assert not run & set(harness.FORBIDDEN_MODULES)
