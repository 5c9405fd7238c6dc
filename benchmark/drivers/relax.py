"""Driver "relax": a stencil relaxation through the port's method registry,
calls back to back in a closed loop, one caller.

Each call runs ``steps_per_call`` sweeps of the configuration's stencil on
the grid the previous call returned (the first call on the grid the harness
made from the seed), through ``registry.get_runner(method, ...)`` and
``Runner.iterate``, and ends in a synchronize. The traffic file gives the
method, the sweeps per launch ``k``, the steps per call, the calls of the
traced slice and how far into the window the drawn check may fall.

Checked once the window has closed: the first call, from the harness's own
interior, and a call drawn from the seed and the last call, each from the
grid the program handed it (the reference follows the program call by call
from the program's own state). Each output is held to ``steps_per_call``
reference sweeps (``reference.jacobi_steps``, float64) by
``max |out - ref| / max |ref|``.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import harness, reference, roofline
from benchmark.trace import trace_slice


@dataclasses.dataclass
class State:
    runner: object
    grid0: object                 # the program's HaloGrid of the input
    interior0: torch.Tensor       # the harness's interior (fp32)
    walls: tuple                  # ((lo, hi),) * 3 as float32 values
    steps: int
    weight: float                 # the spec's weight, as float32 holds it


def prepare(ctx: harness.Context, dtype: Optional[str] = None) -> State:
    """The seeded input and the runner. ``dtype`` (default the
    configuration's) lets the control run the program's lower-precision
    path on the same input."""
    from stencil_tpu_torch.config import RunConfig
    from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, torch_dtype
    from stencil_tpu_torch.core.spec import NAMED_SPECS
    from stencil_tpu_torch.registry import get_runner

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    shape = tuple(int(n) for n in cfg["interior"])
    dtype = dtype or cfg["dtype"]
    if cfg["walls"] != "dirichlet":
        raise harness.BenchmarkError("relax runs Dirichlet walls")
    steps, k = int(tr["steps_per_call"]), int(tr["k"])
    if steps % k:
        raise harness.BenchmarkError(
            f"steps_per_call {steps} is no multiple of k={k}: a remainder "
            "launch would enter every call")
    gen = ctx.generator()
    interior = torch.rand(shape, generator=gen, device=ctx.device,
                          dtype=torch.float32)
    w = torch.rand(6, generator=gen, device=ctx.device,
                   dtype=torch.float32).tolist()
    walls = ((w[0], w[1]), (w[2], w[3]), (w[4], w[5]))
    spec = NAMED_SPECS[cfg["spec"]]()
    grid = HaloGrid.from_interior(interior.to(torch_dtype(dtype)),
                                  halo=int(cfg["radius"]),
                                  bc=DirichletBC(values=walls),
                                  device=ctx.device)
    config = RunConfig(size=shape, spec=cfg["spec"], dtype=dtype,
                       methods=(tr["method"],), temporal=k,
                       device=str(ctx.device), autotune=False)
    runner = get_runner(tr["method"], config, spec, grid)
    if runner.granularity != k:
        raise harness.BenchmarkError(
            f"method {tr['method']} runs k={runner.granularity}, the "
            f"traffic asks for k={k}")
    return State(runner=runner, grid0=grid, interior0=interior, walls=walls,
                 steps=steps, weight=float(np.float32(cfg["weight"])))


def advance(state: State, grid):
    """One call of the timed path."""
    return state.runner.iterate(grid, state.steps)


def error(state: State, interior_in: torch.Tensor, out) -> float:
    """The output of one call against the reference's sweeps from the same
    input."""
    want = reference.jacobi_steps(interior_in, state.walls, state.steps,
                                  state.weight)
    return reference.max_rel_error(out.interior(), want)


def reading(ctx: harness.Context, dtype: Optional[str] = None,
            calls: int = 1) -> float:
    """The check's number for the last of ``calls`` calls of the timed
    path from the seeded input (each on the grid the one before returned),
    in ``dtype`` (the control's lower precision) or the configuration's."""
    state = prepare(ctx, dtype)
    grid_in, out = None, state.grid0
    for _ in range(calls):
        grid_in, out = out, advance(state, out)
    harness.synchronize(ctx.device)
    interior_in = state.interior0 if calls == 1 else grid_in.interior()
    return error(state, interior_in, out)


def launch_work(ctx: harness.Context, launches: Dict[str, int]):
    """The frozen count of the slice's launches, or None where the program
    launched a mode this traffic does not run."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    others = sum(launches[m] for m in ("source_launches", "cheby_launches",
                                       "dual_launches", "two_level_launches",
                                       "coeff_launches"))
    if others:
        print(f"# {others} launches of another mode than the homogeneous "
              "one: the count does not cover them", file=sys.stderr)
        return None
    one = roofline.Launch(shape=tuple(cfg["interior"]),
                          radius=int(cfg["radius"]), sweeps=int(tr["k"]),
                          flops_per_point=int(cfg["flops_per_point"]),
                          dtype=cfg["dtype"])
    return [{"mode": one.mode, "count": launches["launches"],
             "bytes": one.nbytes, "ops": one.ops, "bound_s": one.bound_s}]


def run(ctx: harness.Context) -> dict:
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

    state = prepare(ctx)
    tr = ctx.cell.traffic
    # every shape the window uses, and the library's build or load
    warm = state.grid0
    for _ in range(int(tr.get("warmup_calls", 2))):
        warm = advance(state, warm)
    harness.synchronize(ctx.device)
    del warm

    drawn = int(ctx.rng(1).integers(1, int(tr["check_within"])))
    kept: Dict[str, tuple] = {}
    cur = {"grid": state.grid0}

    def call(i):
        return advance(state, cur["grid"])

    def done(i, out):
        if i == 0:
            kept["first"] = (state.interior0, out)
        elif i == drawn:
            kept["drawn"] = (cur["grid"], out)
        kept["last"] = (cur["grid"], out)
        cur["grid"] = out

    win = harness.run_window(call, ctx.seconds, ctx.device, done)
    points = int(np.prod(ctx.cell.config["interior"]))
    record = {
        "setup_s": win.t_start - ctx.t_origin,
        "window": {"s": win.seconds, "calls": win.calls,
                   "point_updates": points * state.steps * win.calls,
                   "call_ms": win.call_ms, "host_s": win.host_s},
        "attempted": win.calls,
        "trace": None,
    }
    if ctx.trace:
        slice_grid = {"grid": cur["grid"]}

        def traced(i):
            return advance(state, slice_grid["grid"])

        def traced_done(i, out):
            slice_grid["grid"] = out

        sl = trace_slice(traced, int(tr["trace_calls"]), "iterate",
                         ctx.device, lambda: harness.launch_counts(
                             tiled_sweep),
                         harness.kernel_names(tiled_sweep),
                         f"{tiled_sweep.march.name}_kernel", traced_done,
                         int(tr["trace_label_calls"]))
        record["trace"] = {**sl.as_record(),
                           "launch_work": launch_work(ctx, sl.launches)}
        del slice_grid
    record["memory_peak_bytes"] = harness.memory_peak_bytes(ctx.device)

    # the program's state goes; the checked inputs and outputs stay
    state.runner = None
    state.grid0 = None
    cur.clear()
    harness.release(ctx.device)
    limit = float(ctx.cell.limits["relax_err"])
    checks = {}
    for label in ("first", "drawn", "last"):
        if label not in kept:
            continue
        grid_in, out = kept[label]
        interior_in = grid_in if isinstance(grid_in, torch.Tensor) \
            else grid_in.interior()
        name, c = harness.check(f"relax_err.{label}",
                                error(state, interior_in, out), limit)
        checks[name] = c
    record["checks"] = checks
    record["failed"] = sum(c["value"] > c["limit"] for c in checks.values())
    return record
