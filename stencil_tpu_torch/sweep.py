"""Experiment sweep harness.

Counterpart of ``stencil_tpu/sweep.py``, the analog of the reference's
``run_expr.py``, which shells out to batch jobs and scrapes "average time"
lines into a CSV. Here the sweep builds ``RunConfig`` objects directly (the
dataclass the CLI parses into) and runs them in-process through
``cli.run_all``, which hands ``--solve`` configurations to
``solve_cli.run_solve``: the configuration surface cannot drift from the
CLI's, and the results are structured (CSV and JSON lines).

  python -m stencil_tpu_torch.sweep --sizes 512 1024 --iterations 100 \\
      --methods eager pallas pallas_temporal --check
  python -m stencil_tpu_torch.sweep --solve poisson --sizes 63 --ndim 3 \\
      --solvers pcg bicgstab gmres --check
"""

from __future__ import annotations

import csv
import itertools
import json
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

from stencil_tpu_torch.cli import run_all
from stencil_tpu_torch.config import RunConfig

# the reference sweep space (run_expr.py:6-15) scaled to card-sized problems
DEFAULT_SIZES: Sequence[int] = (512, 1024, 2048, 4096)
DEFAULT_ITERATIONS: Sequence[int] = (100, 1000)
DEFAULT_METHODS: Sequence[str] = ("xla", "pallas", "pallas_temporal")


def sweep_configs(
    sizes: Iterable[int] = DEFAULT_SIZES,
    iterations: Iterable[int] = DEFAULT_ITERATIONS,
    methods: Sequence[str] = DEFAULT_METHODS,
    ndim: int = 2,
    spec: Optional[str] = None,
    temporal: int = 8,
    check: bool = False,
    dtypes: Sequence[str] = ("float32",),
    mesh: Sequence[int] = (),
    periodic: Sequence[object] = (),
    neumann: Sequence[object] = (),
    device: str = "cuda",
) -> List[RunConfig]:
    """One iterate ``RunConfig`` per (size, iteration count, dtype), each
    running every method of ``methods`` on ``device``."""
    spec = spec or ("jacobi5" if ndim == 2 else "jacobi7")
    return [RunConfig(size=(size,) * ndim, iterations=iters, spec=spec,
                      methods=tuple(methods), temporal=temporal,
                      check=check, dtype=dt, mesh=tuple(mesh),
                      periodic=tuple(periodic), neumann=tuple(neumann),
                      device=device)
            for size, iters, dt in itertools.product(sizes, iterations,
                                                     dtypes)]


def solver_sweep_configs(
    families: Sequence[str] = ("poisson",),
    solvers: Sequence[str] = ("pcg", "bicgstab", "gmres"),
    sizes: Iterable[int] = (63, 127),
    tolerances: Iterable[float] = (1e-5,),
    ndim: int = 3,
    iterations: int = 2000,
    check: bool = True,
    preconds: Sequence[Optional[str]] = (None,),
    smoothers: Sequence[str] = ("wjacobi",),
    restarts: Sequence[int] = (16,),
    mesh: Sequence[int] = (),
    dtypes: Sequence[str] = ("float32",),
    device: str = "cuda",
) -> List[RunConfig]:
    """The cross product of (family, solver, size, tolerance,
    preconditioner, smoother, restart, dtype) as solve-mode
    ``RunConfig``\\ s: the restart varies only the ``gmres`` rows and the
    smoother only the multigrid-cycle rows (``mg``, ``fmg``, ``pcg``)."""
    out = []
    for (fam, sol, size, tol, pre, smo, m, dt) in itertools.product(
            families, solvers, sizes, tolerances, preconds, smoothers,
            restarts, dtypes):
        if sol != "gmres" and m != restarts[0]:
            continue  # restart only varies gmres rows
        if smo != smoothers[0] and sol not in ("mg", "fmg", "pcg"):
            continue  # smoother only varies MG-cycle rows
        out.append(RunConfig(size=(size,) * ndim, iterations=iterations,
                             solve=fam, solver=sol, tolerance=tol,
                             precond=pre, smoother=smo, restart=m,
                             check=check, dtype=dt, mesh=tuple(mesh),
                             device=device))
    return out


def run_sweep(
    configs: Sequence[RunConfig],
    csv_path: str | Path = "sweep.csv",
    json_path: Optional[str | Path] = "sweep.jsonl",
    progress=print,
) -> List[dict]:
    """Run every configuration through ``cli.run_all``; write one CSV row
    per record (every scalar field, ``method``, ``spec``, ``iterations``
    and ``dtype`` first, the size last as ``AxBxC``) and one JSON line per
    record. Returns the records."""
    rows: List[dict] = []
    for i, cfg in enumerate(configs):
        what = (f"solve={cfg.solve} solver={cfg.solver} "
                f"tol={cfg.tolerance}" if cfg.solve
                else f"iters={cfg.iterations} methods={cfg.methods}")
        progress(f"[{i + 1}/{len(configs)}] size={cfg.size} {what}")
        rows.extend(run_all(cfg))
    if rows:
        first = ["method", "spec", "iterations", "dtype"]
        keys = sorted({k for r in rows for k in r
                       if not isinstance(r.get(k), (dict, list))})
        keys = first + [k for k in keys if k not in first]
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(keys + ["size"])
            for r in rows:
                w.writerow([r.get(k, "") for k in keys]
                           + ["x".join(map(str, r.get("size", [])))])
    if json_path:
        with open(json_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="stencil-tpu-torch-sweep")
    p.add_argument("--sizes", type=int, nargs="+", default=list(DEFAULT_SIZES))
    p.add_argument("--iterations", type=int, nargs="+",
                   default=list(DEFAULT_ITERATIONS))
    p.add_argument("--methods", type=str, nargs="+",
                   default=list(DEFAULT_METHODS))
    p.add_argument("--ndim", type=int, default=2, choices=[2, 3])
    p.add_argument("--spec", type=str, default=None)
    p.add_argument("--temporal", type=int, default=8)
    p.add_argument("--check", action="store_true")
    p.add_argument("--dtypes", type=str, nargs="+", default=["float32"])
    p.add_argument("--periodic", type=str, nargs="*", default=[],
                   help="dims with periodic boundaries for every config "
                        "(e.g. --periodic 0 or --periodic all)")
    p.add_argument("--neumann", type=str, nargs="*", default=[],
                   help="dims with Neumann (zero-flux mirror) boundaries "
                        "for every config")
    p.add_argument("--mesh", type=int, nargs="*", default=[],
                   help="mesh axis sizes for sharded methods")
    p.add_argument("--solve", type=str, nargs="+", default=[],
                   choices=["poisson", "hetero", "advdiff"],
                   help="sweep the SOLVER stack over these problem "
                        "families instead of iterate kernels")
    p.add_argument("--solvers", type=str, nargs="+",
                   default=["pcg", "bicgstab", "gmres"],
                   help="solvers to cross with --solve families")
    p.add_argument("--tols", type=float, nargs="+", default=[1e-5],
                   help="solver tolerances to sweep")
    p.add_argument("--restarts", type=int, nargs="+", default=[16],
                   help="GMRES restart lengths to sweep")
    p.add_argument("--smoothers", type=str, nargs="+",
                   default=["wjacobi"],
                   help="MG smoothers to sweep (wjacobi/chebyshev)")
    p.add_argument("--csv", type=str, default="sweep.csv")
    p.add_argument("--json", type=str, default="sweep.jsonl")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda); 'cpu' runs the plain "
                        "PyTorch versions of the kernels")
    ns = p.parse_args(argv)
    if ns.solve:
        cfgs = solver_sweep_configs(
            ns.solve, ns.solvers, ns.sizes, ns.tols, ns.ndim,
            iterations=ns.iterations[0], check=ns.check,
            smoothers=ns.smoothers, restarts=ns.restarts,
            mesh=ns.mesh, dtypes=ns.dtypes, device=ns.device)
    else:
        cfgs = sweep_configs(ns.sizes, ns.iterations, ns.methods,
                             ns.ndim, ns.spec, ns.temporal, ns.check,
                             ns.dtypes, ns.mesh, ns.periodic,
                             ns.neumann, device=ns.device)
    run_sweep(cfgs, ns.csv, ns.json)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
