"""Driver "relax2d": a 2D stencil relaxation through the port's method
registry, calls back to back in a closed loop, one caller.

Each call runs ``steps_per_call`` sweeps of the configuration's 2D stencil
on the grid the previous call returned (the first call on the grid the
harness made from the seed), through ``registry.get_runner(method, ...)``
and ``Runner.iterate``, and ends in a synchronize. The configuration gives
the sweeps per launch ``k`` and the rows per chunk ``block`` (the
deployment's temporal depth and ``-b``); the traffic file gives the
method, the steps per call, the calls of the traced slice and how far into
the window the drawn check may fall. The traced slice is held to the 2D
kernel's counters (``slab_sweep``, its march twin ``slab_march``). The
state and the timed call are ``relax.py``'s.

Checked once the window has closed: the first call, from the harness's own
interior, and a call drawn from the seed and the last call, each from the
grid the program handed it. Each output is held to ``steps_per_call``
reference sweeps (``reference2d.box9_steps``, float64, d1's walls in the
corners) by ``max |out - ref| / max |ref|``.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from benchmark import harness, reference, reference2d, roofline
from benchmark.drivers.relax import State, advance
from benchmark.trace import trace_slice

OTHER_MODES = ("source_launches", "cheby_launches", "dual_launches",
               "two_level_launches", "coeff_launches")


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
    if len(shape) != 2 or cfg["walls"] != "dirichlet":
        raise harness.BenchmarkError("relax2d runs a 2D grid with "
                                     "Dirichlet walls")
    steps, k = int(tr["steps_per_call"]), int(cfg["k"])
    if steps % k:
        raise harness.BenchmarkError(
            f"steps_per_call {steps} is no multiple of k={k}: a remainder "
            "launch would enter every call")
    gen = ctx.generator()
    interior = torch.rand(shape, generator=gen, device=ctx.device,
                          dtype=torch.float32)
    w = torch.rand(4, generator=gen, device=ctx.device,
                   dtype=torch.float32).tolist()
    walls = ((w[0], w[1]), (w[2], w[3]))
    spec = NAMED_SPECS[cfg["spec"]]()
    grid = HaloGrid.from_interior(interior.to(torch_dtype(dtype)),
                                  halo=int(cfg["radius"]),
                                  bc=DirichletBC(values=walls),
                                  device=ctx.device)
    config = RunConfig(size=shape, spec=cfg["spec"], dtype=dtype,
                       methods=(tr["method"],), temporal=k,
                       block=cfg["block"], device=str(ctx.device),
                       autotune=bool(cfg["autotune"]))
    runner = get_runner(tr["method"], config, spec, grid)
    if runner.granularity != k:
        raise harness.BenchmarkError(
            f"method {tr['method']} runs k={runner.granularity}, the "
            f"configuration asks for k={k}")
    return State(runner=runner, grid0=grid, interior0=interior, walls=walls,
                 steps=steps, weight=float(np.float32(cfg["weight"])))


def error(state: State, interior_in: torch.Tensor, out) -> float:
    """The output of one call against the reference's sweeps from the same
    input."""
    want = reference2d.box9_steps(interior_in, state.walls, state.steps,
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
    cfg = ctx.cell.config
    others = sum(launches[m] for m in OTHER_MODES)
    if others:
        print(f"# {others} launches of another mode than the homogeneous "
              "one: the count does not cover them", file=sys.stderr)
        return None
    one = roofline.Launch(shape=tuple(cfg["interior"]),
                          radius=int(cfg["radius"]), sweeps=int(cfg["k"]),
                          flops_per_point=int(cfg["flops_per_point"]),
                          dtype=cfg["dtype"])
    return [{"mode": one.mode, "count": launches["launches"],
             "bytes": one.nbytes, "ops": one.ops, "bound_s": one.bound_s}]


def run(ctx: harness.Context) -> dict:
    from stencil_tpu_torch.ops.slab_kernel import slab_sweep
    from stencil_tpu_torch.utils import tracing

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

        before = dict(tracing.counters())
        sl = trace_slice(traced, int(tr["trace_calls"]), "iterate",
                         ctx.device, lambda: harness.launch_counts(
                             slab_sweep),
                         harness.kernel_names(slab_sweep),
                         f"{slab_sweep.march.name}_kernel", traced_done,
                         int(tr["trace_label_calls"]))
        # over every call trace_slice makes: the profiler's first, the
        # counted slice and the naming slice
        delta = {n: v - before.get(n, 0)
                 for n, v in tracing.counters().items()}
        print(f"# counters over the traced calls {json.dumps(delta)}",
              file=sys.stderr)
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
