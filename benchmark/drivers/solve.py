"""Driver "solve": steady Poisson solves through the port's Krylov solver,
back to back in a closed loop, one caller.

Set-up makes the configuration's problem, its preconditioner and its
solver once, and a pool of right-hand sides ``f ~ normal(0, 1)`` on the
device from the seed (``pool`` of them, one call). Each solve takes the
pool entry the seed's stream draws next and runs
``solver.solve(f, tolerance, max_iterations)``, which ends in its one fetch
of the result's numbers; a synchronize follows.

Checked once the window has closed: the first solve, a solve drawn from the
seed and the last solve. Each returned ``u`` is held to its ``f`` by the
float64 residual ``||f - L u||_2 / ||f||_2`` (``reference``), on the grid
spacing the configuration's domain gives, against the tolerance the
configuration states. A solve that reports no convergence
counts as failed.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import harness, reference, roofline
from benchmark.trace import trace_slice


@dataclasses.dataclass
class State:
    solver: object
    pool: torch.Tensor
    order: np.random.Generator
    h: float
    tolerance: float
    max_iterations: int


def prepare(ctx: harness.Context, dtype: Optional[str] = None,
            pool: Optional[int] = None) -> State:
    """The problem, its solver and the seeded pool. ``dtype`` (default the
    configuration's) runs the program's lower-precision path on the same
    right-hand sides; ``pool`` overrides the traffic's pool size."""
    from stencil_tpu_torch.krylov import ConjugateGradient
    from stencil_tpu_torch.models.poisson import PoissonProblem
    from stencil_tpu_torch.multigrid import Multigrid

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    shape = tuple(int(n) for n in cfg["interior"])
    if cfg["walls"] != "dirichlet zero" or cfg["solver"] != "pcg":
        raise harness.BenchmarkError(
            "solve runs PCG on zero Dirichlet walls")
    if len(set(shape)) != 1:
        raise harness.BenchmarkError("solve runs a cube: one grid spacing")
    pc = cfg["preconditioner"]
    if pc["nu1"] != pc["nu2"]:
        raise harness.BenchmarkError("PCG needs nu1 == nu2")
    prob = PoissonProblem(shape=shape, dtype=dtype or cfg["dtype"],
                          device=str(ctx.device))
    mg = Multigrid(prob, nu1=int(pc["nu1"]), nu2=int(pc["nu2"]),
                   smoother=pc["smoother"],
                   cheby_ratio=float(pc["cheby_ratio"]),
                   coarse_sweeps=int(pc["coarse_sweeps"]),
                   fine_method=pc["fine_method"])
    n = int(tr["pool"] if pool is None else pool)
    f = torch.randn((n, *shape), generator=ctx.generator(),
                    device=ctx.device, dtype=torch.float32)
    return State(solver=ConjugateGradient(prob, preconditioner=mg), pool=f,
                 order=ctx.rng(2), h=spacing(cfg),
                 tolerance=float(cfg["tolerance"]),
                 max_iterations=int(cfg["max_iterations"]))


def spacing(cfg: dict) -> float:
    """The grid spacing the configuration states: its domain's length over
    the interior points plus one (the reference's ``h``; the program's own
    is not taken)."""
    return float(cfg["domain_length"]) / (int(cfg["interior"][0]) + 1)


def solve(state: State, index: int):
    """One call of the timed path: a solve of pool entry ``index``."""
    return state.solver.solve(state.pool[index], tolerance=state.tolerance,
                              max_iterations=state.max_iterations)


def residual(state: State, index: int, result) -> float:
    return reference.poisson_residual_rel(result.grid.interior(),
                                          state.pool[index], state.h)


def reading(ctx: harness.Context, dtype: Optional[str] = None,
            calls: int = 1) -> float:
    """The check's number for one solve of the timed path on a seeded
    right-hand side, in ``dtype`` (the control's lower precision) or the
    configuration's. Solves are independent: ``calls`` changes nothing."""
    state = prepare(ctx, dtype, pool=1)
    result = solve(state, 0)
    harness.synchronize(ctx.device)
    return residual(state, 0, result)


def launch_work(ctx: harness.Context, launches: Dict[str, int]):
    """The frozen count of the slice's fine-level launches: the fused
    smooth+residual (dual, nu1 + 1 sweeps) and the Chebyshev smoother (nu2
    sweeps); None where the program launched another mode."""
    cfg = ctx.cell.config
    pc = cfg["preconditioner"]
    others = launches["launches"] - launches["dual_launches"] \
        - launches["cheby_launches"]
    if others:
        print(f"# {others} fine-level launches of a mode the count does "
              "not cover", file=sys.stderr)
        return None
    work = []
    for mode, key, sweeps in (("dual", "dual_launches", int(pc["nu1"]) + 1),
                              ("cheby", "cheby_launches", int(pc["nu2"]))):
        one = roofline.Launch(shape=tuple(cfg["interior"]),
                              radius=int(cfg["radius"]), sweeps=sweeps,
                              flops_per_point=int(cfg["fine_flops_per_point"]),
                              mode=mode, dtype=cfg["dtype"])
        work.append({"mode": mode, "count": launches[key],
                     "bytes": one.nbytes, "ops": one.ops,
                     "bound_s": one.bound_s})
    return work


def run(ctx: harness.Context) -> dict:
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

    state = prepare(ctx)
    tr = ctx.cell.traffic
    n_pool = state.pool.shape[0]
    for i in range(int(tr.get("warmup_solves", 2))):
        solve(state, i % n_pool)
    harness.synchronize(ctx.device)

    drawn = int(ctx.rng(1).integers(1, int(tr["check_within"])))
    kept: Dict[str, tuple] = {}
    iterations: List[int] = []
    unconverged = [0]
    picks: List[int] = []

    def call(i):
        picks.append(int(state.order.integers(n_pool)))
        return solve(state, picks[-1])

    def done(i, result):
        iterations.append(result.iterations)
        unconverged[0] += not result.converged
        if i == 0:
            kept["first"] = (picks[-1], result)
        elif i == drawn:
            kept["drawn"] = (picks[-1], result)
        kept["last"] = (picks[-1], result)

    win = harness.run_window(call, ctx.seconds, ctx.device, done)
    record = {
        "setup_s": win.t_start - ctx.t_origin,
        "window": {"s": win.seconds, "calls": win.calls,
                   "solves": win.calls, "iterations": iterations,
                   "call_ms": win.call_ms, "host_s": win.host_s},
        "attempted": win.calls,
        "trace": None,
    }
    if ctx.trace:
        traced_iterations: List[int] = []

        def traced(i):
            return solve(state, int(state.order.integers(n_pool)))

        def traced_done(i, result):
            if i >= 0:
                traced_iterations.append(result.iterations)

        sl = trace_slice(traced, int(tr["trace_solves"]), "solve",
                         ctx.device, lambda: harness.launch_counts(
                             tiled_sweep),
                         harness.kernel_names(tiled_sweep),
                         f"{tiled_sweep.march.name}_kernel", traced_done,
                         int(tr["trace_label_calls"]))
        record["trace"] = {**sl.as_record(),
                           "launch_work": launch_work(ctx, sl.launches),
                           "cg_iterations": traced_iterations}
    record["memory_peak_bytes"] = harness.memory_peak_bytes(ctx.device)

    # the solver's state goes; the pool and the checked answers stay
    state.solver = None
    harness.release(ctx.device)
    limit = float(ctx.cell.config["tolerance"])
    checks = {}
    for label in ("first", "drawn", "last"):
        if label not in kept:
            continue
        index, result = kept[label]
        name, c = harness.check(f"residual_rel.{label}",
                                residual(state, index, result), limit)
        checks[name] = c
    record["checks"] = checks
    record["failed"] = unconverged[0] + sum(
        c["value"] > c["limit"] for c in checks.values())
    return record
