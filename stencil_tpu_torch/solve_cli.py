"""Solve mode of the CLI: name -> solver dispatch for the steady-state stack.

Counterpart of ``stencil_tpu/solve_cli.py`` (``build_problem``,
``build_rhs``, ``build_solver``, ``_warm_start``, ``_solve_once``,
``run_solve``, ``_solve_checkpointed``) for the ``poisson``, ``hetero`` and
``advdiff`` families. ``--solve`` picks the family, ``--solver`` the
method (``auto`` = ``pcg`` for poisson and ``bicgstab`` otherwise,
``relax``, ``mg``, ``fmg``, ``cg``, ``pcg``, ``bicgstab`` and ``gmres``
with ``--precond opmg``, the rediscretized operator cycle, and
``--restart``); ``hetero`` takes ``--contrast`` and ``--op-kernel``
(``pallas``: the tiled kernel's coefficient mode as the matvec at every
level), ``advdiff`` ``--velocity`` (default 1 per dim), ``--nu`` and
``--scheme``; the output is human lines plus one JSON record per solve
with the JAX record's keys (iterations, the solver's certified residual,
``plan``, ``-c``'s float64 re-certification and error against the exact
solution, ``-R``'s wall-clock repeats). ``--checkpoint-dir`` chunks the
solve at ``--checkpoint-every`` iterations and resumes from the newest
checkpoint (FMG, one pass, skips it); ``--dump-image`` writes the
solution's heat map (a volume's middle plane).

The fine level of the multigrid cycles follows the JAX rule
(``_resolve_fine_method``), with "on a TPU" read as "the problem lives on a
CUDA device": weighted Jacobi at nu < 4 keeps the eager fine level, the
Chebyshev smoother or nu >= 4 take the tiled kernel.

``--mesh`` (1D or 2D, over the leading grid dims) distributes the solve on
the single-controller mesh (``parallel/mesh.py``), several ranks per card
where there are fewer cards: ``relax`` on ``PoissonProblem.sharded_runner``,
``mg`` on ``Multigrid.sharded_runner``, the Krylov solvers with ``mesh=``;
the fine level is then the eager one, a hetero ``--op-kernel auto`` the
eager matvec, and ``fmg`` is refused (JAX's message); ``--warm-start fmg``
runs its FMG pass on one device. A contradictory configuration gives an
error record.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np
import torch

from stencil_tpu_torch.config import RunConfig

FAMILIES = ("poisson", "hetero", "advdiff")
SOLVERS = ("auto", "relax", "mg", "fmg", "cg", "pcg", "bicgstab",
           "gmres")


def _on_cuda(config: RunConfig) -> bool:
    return torch.device(config.device).type == "cuda"


def _solve_bc(config: RunConfig):
    """Zero Dirichlet walls (the steady-problem convention), with
    --periodic/--neumann dims applied; the Poisson solvers refuse dynamic
    walls themselves."""
    from stencil_tpu_torch.core.grid import DirichletBC

    bc = DirichletBC.zero(len(config.size))
    if config.periodic:
        bc = bc.with_periodic(config.periodic_dims())
    if config.neumann:
        bc = bc.with_neumann(config.neumann_dims())
    return bc


def build_problem(config: RunConfig):
    """The ``--solve`` family -> problem object."""
    family = config.solve
    shape = tuple(config.size)
    if family == "poisson":
        from stencil_tpu_torch.models.poisson import PoissonProblem

        return PoissonProblem(shape=shape, bc=_solve_bc(config),
                              dtype=config.dtype, device=config.device)
    if family == "hetero":
        from stencil_tpu_torch.models.diffusion import (
            HeterogeneousPoissonProblem, two_material,
        )

        if config.contrast < 1.0:
            raise ValueError(
                f"--contrast must be >= 1 (got {config.contrast})")
        a = two_material(shape, lo=1.0 / config.contrast, hi=1.0, seed=0)
        kernel = config.op_kernel
        if kernel == "auto" and config.mesh:
            # a distributed solve applies the operator per block; the
            # kernel's coefficient matvec runs on the whole grid
            # (krylov._check_mesh_operator)
            kernel = "xla"
        return HeterogeneousPoissonProblem(
            shape=shape, a=a, bc=_solve_bc(config), dtype=config.dtype,
            kernel=kernel, device=config.device)
    if family == "advdiff":
        from stencil_tpu_torch.models.advection_diffusion import (
            AdvectionDiffusionProblem,
        )

        vel = (tuple(config.velocity) if config.velocity
               else (1.0,) * len(shape))
        return AdvectionDiffusionProblem(
            shape=shape, velocity=vel, nu=config.nu, bc=_solve_bc(config),
            dtype=config.dtype, scheme=config.scheme, device=config.device)
    raise ValueError(
        f"unknown --solve family {family!r} (choose from {FAMILIES})")


def build_rhs(config: RunConfig, problem):
    """(f, u_exact_or_None) as float arrays. ``auto`` = the manufactured
    sine for poisson (so the run can report the error against the exact
    solution), seeded random otherwise."""
    from stencil_tpu_torch.models.poisson import manufactured_sine

    mode = config.rhs
    if mode == "auto":
        mode = "sine" if config.solve == "poisson" else "random"
    shape = tuple(config.size)
    # numpy has no bfloat16: a bfloat16 problem casts its float32 f
    dtype = "float32" if config.dtype == "bfloat16" else config.dtype
    if mode == "sine":
        f, u_exact = manufactured_sine(shape, h=float(problem.h))
        return (f.astype(dtype),
                u_exact if config.solve == "poisson" else None)
    if mode == "random":
        rng = np.random.default_rng(0)
        return rng.normal(size=shape).astype(dtype), None
    if mode == "ones":
        return np.ones(shape, dtype), None
    raise ValueError(f"unknown --rhs {mode!r}")


def _resolve_solver(config: RunConfig) -> str:
    if config.solver != "auto":
        return config.solver
    return "pcg" if config.solve == "poisson" else "bicgstab"


def _resolve_fine_method(config: RunConfig, mesh) -> str:
    fm = config.fine_method
    if fm != "auto":
        return fm
    # the JAX rule, unchanged: the Chebyshev tiled fine level at every nu,
    # the weighted-Jacobi one at nu >= 4 (the fused smooth+residual has to
    # amortize the per-launch cost)
    nu_min = 1 if config.smoother == "chebyshev" else 4
    if (mesh is None and len(config.size) == 3
            and config.dtype == "float32" and min(config.size) >= 32
            and min(int(v) for v in config.nu_smooth) >= nu_min
            and _on_cuda(config)):
        return "pallas_tiled"
    return "xla"


def _make_mesh(config: RunConfig):
    """``--mesh``: a 1D or 2D mesh (axes ``x``, ``y``) over the leading
    grid dims, on ``--device``."""
    if not config.mesh:
        return None
    from stencil_tpu_torch.parallel.mesh import make_mesh

    if len(config.mesh) > 2:
        raise ValueError(
            "--mesh must be 1D or 2D over the leading grid dims")
    axes = ("x", "y")[: len(config.mesh)]
    return make_mesh(tuple(config.mesh), axes, device=config.device)


def build_solver(config: RunConfig, problem):
    """(solver_object, kind, plan_info). ``kind`` selects the solve
    loop: 'krylov' (CGResult protocol), 'mg' (cycle iteration), 'fmg'
    (one pass), 'relax' (runner + solver.solve)."""
    name = _resolve_solver(config)
    family = config.solve
    nu1, nu2 = (int(v) for v in config.nu_smooth)
    mesh = _make_mesh(config)
    plan: dict = {"solver": name, "family": family,
                  "tolerance": config.tolerance}
    if mesh is not None:
        plan["mesh"] = list(config.mesh)

    def poisson_only(what):
        if family != "poisson":
            raise ValueError(
                f"--solver {what} runs the hardcoded Poisson stack; "
                f"family {family!r} needs bicgstab/gmres (rediscretized"
                " operator preconditioning) or relax")

    def make_mg():
        from stencil_tpu_torch.multigrid import Multigrid

        fm = _resolve_fine_method(config, mesh)
        plan.update(smoother=config.smoother, gamma=config.gamma,
                    nu_smooth=[nu1, nu2], fine_method=fm)
        return Multigrid(problem, nu1=nu1, nu2=nu2,
                         smoother=config.smoother, gamma=config.gamma,
                         fine_method=fm)

    precond = config.precond
    if name == "relax":
        poisson_only("relax (Jacobi splitting)")
        plan["method"] = "jacobi relaxation"
        return problem, "relax", plan
    if name in ("mg", "fmg"):
        poisson_only(name)
        if precond not in (None, "none"):
            raise ValueError(f"--solver {name} takes no --precond")
        if name == "fmg" and mesh is not None:
            raise ValueError(
                "FMG is the single-device initializer; distributed "
                "solves use --solver mg/pcg (per-level sharding "
                "ladder) or a Krylov method")
        return make_mg(), name, plan
    if name in ("cg", "pcg"):
        poisson_only(name)
        from stencil_tpu_torch.krylov import ConjugateGradient

        if precond is None:
            precond = "none" if name == "cg" else "mg"
        if precond == "opmg":
            raise ValueError(
                "cg/pcg precondition with the SPD Poisson cycle "
                "(--precond mg); opmg is the bicgstab/gmres "
                "rediscretized cycle")
        pre = make_mg() if precond == "mg" else None
        if pre is None and config.precond_dtype is not None:
            raise ValueError("--precond-dtype needs a preconditioner")
        plan["precond"] = precond
        if config.precond_dtype:
            plan["precond_dtype"] = config.precond_dtype
        return (ConjugateGradient(problem, preconditioner=pre,
                                  precond_dtype=config.precond_dtype),
                "krylov", plan)
    if name in ("bicgstab", "gmres"):
        if precond is None:
            precond = "opmg"
        if precond == "mg":
            raise ValueError(
                "bicgstab/gmres precondition with the rediscretized "
                "operator cycle (--precond opmg); mg is the cg/pcg "
                "Poisson cycle")
        if config.precond_dtype is not None:
            raise ValueError(
                "--precond-dtype is a pcg option (the opmg cycle runs "
                "in the problem dtype)")
        from stencil_tpu_torch.krylov import GMRES, BiCGStab
        from stencil_tpu_torch.multigrid import OperatorMultigrid

        pre = None
        if precond == "opmg":
            plan.update(precond="opmg", gamma=config.gamma,
                        nu_smooth=[nu1, nu2])
            pre = OperatorMultigrid(problem, nu1=nu1, nu2=nu2,
                                    gamma=config.gamma)
        plan["precond"] = precond
        if getattr(problem, "kernel", None) == "pallas":
            from stencil_tpu_torch.registry import schedule_info

            # the schedule the coefficient-mode matvec runs on
            plan.update(schedule_info(problem._kernel_plan()))
        if mesh is not None:
            # refused here, so that it is an error record
            from stencil_tpu_torch.krylov import _check_mesh_operator

            _check_mesh_operator(problem, pre)
        if name == "gmres":
            plan["restart"] = config.restart
            return (GMRES(problem, preconditioner=pre,
                          restart=config.restart), "krylov", plan)
        return BiCGStab(problem, preconditioner=pre), "krylov", plan
    raise ValueError(
        f"unknown --solver {name!r} (choose from {SOLVERS})")


def _warm_start(config: RunConfig, problem, f):
    """--warm-start fmg: one full-multigrid pass as the Krylov initial
    iterate (poisson)."""
    if config.warm_start is None:
        return None
    if config.warm_start != "fmg":
        raise ValueError(f"unknown --warm-start {config.warm_start!r}")
    if config.solve != "poisson":
        raise ValueError(
            "--warm-start fmg runs the Poisson FMG stack; other "
            "families start from zero")
    from stencil_tpu_torch.multigrid import Multigrid

    nu1, nu2 = (int(v) for v in config.nu_smooth)
    return Multigrid(problem, nu1=nu1, nu2=nu2).fmg(f)


def _fnorm(f) -> float:
    return float(np.max(np.abs(np.asarray(f, np.float64))))


def _solve_once(config: RunConfig, solver, kind, problem, f,
                initial=None, budget=None, tolerance=None, mesh=None):
    """One solve (or one checkpointed chunk of ``budget`` iterations) ->
    (grid, iterations, residual, residual_rel, converged); ``mesh`` (None:
    one device) distributes it."""
    from stencil_tpu_torch import solver as solver_mod

    budget = int(budget if budget is not None else config.iterations)
    tol = float(tolerance if tolerance is not None else config.tolerance)
    if kind == "krylov":
        kw = {} if mesh is None else {"mesh": mesh}
        res = solver.solve(f, tolerance=tol, max_iterations=budget,
                           initial=initial, **kw)
        return (res.grid, res.iterations, res.residual,
                res.residual_rel, res.converged)
    if kind == "fmg":
        grid = solver.fmg(f)
        r = solver.residual_norm(grid, f)
        fnorm = _fnorm(f)
        # FMG is a one-pass initializer: 'converged' means it reached its
        # contract (discretization-level error), certified by -c's f64
        # recheck; the algebraic tolerance does not apply
        return grid, 1, r, r / fnorm if fnorm else r, True
    if kind == "mg":
        g0 = (initial if initial is not None
              else solver.problem.initial_grid())
        runner = (solver.runner(f) if mesh is None
                  else solver.sharded_runner(f, mesh))
        res = solver_mod.solve(runner, g0, tolerance=tol,
                               max_iterations=budget, check_every=1)
        r = solver.residual_norm(res.grid, f)
        fnorm = _fnorm(f)
        return (res.grid, res.iterations, r,
                r / fnorm if fnorm else r, res.converged)
    if kind == "relax":
        g0 = initial if initial is not None else solver.initial_grid()
        # a 2D mesh shards d0 and d1, one mesh axis each
        runner = (solver.runner(f) if mesh is None
                  else solver.sharded_runner(f, mesh,
                                             axis_names=mesh.axis_names))
        res = solver_mod.solve(runner, g0, tolerance=tol,
                               max_iterations=budget,
                               check_every=max(1, min(200, budget)))
        return (res.grid, res.iterations, res.residual, res.residual,
                res.converged)
    raise AssertionError(kind)


def run_solve(config: RunConfig, out) -> List[dict]:
    """Solve mode: build, solve (with optional timed repeats),
    certify, report. Returns JSON-able records."""
    from stencil_tpu_torch.utils.timing import measure_wall

    try:
        problem = build_problem(config)
        f, u_exact = build_rhs(config, problem)
        solver, kind, plan = build_solver(config, problem)
        mesh = _make_mesh(config)
    except (ValueError, KeyError) as e:
        # contradictions are records, not tracebacks
        name = _resolve_solver(config)
        print(f"[{name}] unavailable: {e}", file=out)
        rec = {"solve": config.solve, "solver": name, "error": str(e)}
        if config.json_out:
            with open(config.json_out, "w") as fh:
                fh.write(json.dumps(rec) + "\n")
        return [rec]
    name = plan["solver"]
    rec: dict = {"solve": config.solve, "solver": name,
                 "size": list(config.size), "dtype": config.dtype,
                 "tolerance": config.tolerance, "plan": plan}

    initial = _warm_start(config, problem, f)
    tol_eff = None
    bnorm2 = None
    if initial is not None:
        plan["warm_start"] = "fmg"
        if kind == "krylov":
            # Krylov tolerances are r0-relative; re-anchor to ||b|| (=
            # ||f||_2: solve-mode walls are zero) so --tol keeps meaning
            # "relative to the right-hand side"
            r0 = np.asarray(f, np.float64) - problem.apply_f64(
                initial.interior().double().cpu().numpy())
            rw = float(np.linalg.norm(r0.ravel()))
            bnorm2 = float(np.linalg.norm(
                np.asarray(f, np.float64).ravel()))
            if rw > 0.0:
                tol_eff = config.tolerance * bnorm2 / rw

    ckpt_dir = config.checkpoint_dir
    if ckpt_dir and kind == "fmg":
        print(f"[{name}] checkpointing skipped: FMG is one pass", file=out)
        ckpt_dir = None

    if ckpt_dir:
        grid, iters, r, rrel, conv = _solve_checkpointed(
            config, solver, kind, problem, f, mesh, initial, ckpt_dir, name,
            out)
        rec["checkpointed"] = True
    else:
        grid, iters, r, rrel, conv = _solve_once(
            config, solver, kind, problem, f, initial=initial,
            tolerance=tol_eff, mesh=mesh)
        if bnorm2:
            rrel = r / bnorm2  # report relative to ||b||, not r0
            conv = bool(rrel <= config.tolerance * (1 + 1e-9))
    rec.update(iterations=iters, residual=r, residual_rel=rrel,
               converged=bool(conv))
    tag = "converged" if conv else "NOT converged"
    print(f"[{name}] {tag}: {iters} iterations, residual {r:.3e} "
          f"(rel {rrel:.3e})", file=out)

    if config.check:
        # float64 re-certification outside the solve: the golden twin of
        # the device operator applied to the returned solution
        r64 = problem.residual_f64(grid, f)
        fnorm = _fnorm(f)
        r64_rel = r64 / fnorm if fnorm else r64
        rec["check"] = {"residual_f64": r64, "residual_f64_rel": r64_rel}
        print(f"[{name}] certificate (float64): max |f - A u| = "
              f"{r64:.3e} (rel {r64_rel:.3e})", file=out)
        if u_exact is not None:
            err = float(np.max(np.abs(
                grid.interior().double().cpu().numpy() - u_exact)))
            rec["check"]["error_vs_exact"] = err
            h2 = float(problem.h) ** 2
            print(f"[{name}] error vs exact solution: {err:.3e} "
                  f"(O(h^2) bar ~ {h2:.1e})", file=out)

    # timed repeats (the reference's -R protocol): the full solve; a
    # checkpointed run would resume at once, so only fresh solves are timed
    if config.repeat > 1 and not ckpt_dir:
        wall = measure_wall(
            lambda: _solve_once(config, solver, kind, problem, f,
                                initial=initial, mesh=mesh)[0].data,
            torch.device(config.device), repeats=config.repeat)
        rec["wall_seconds"] = [float(t) for t in wall]
        for j, t in enumerate(wall, 1):
            print(f"[{name}] run {j}: {t * 1e3:.3f} ms", file=out)
        print(f"[{name}] average: "
              f"{sum(wall) / len(wall) * 1e3:.3f} ms", file=out)

    if config.dump_image:
        from stencil_tpu_torch.utils.image import dump_heatmap

        # a volume's middle d0 plane
        dump_heatmap(config.dump_image, grid.interior())
        print(f"[{name}] heat map -> {config.dump_image}", file=out)

    if config.json_out:
        with open(config.json_out, "w") as fh:
            fh.write(json.dumps(rec) + "\n")
    return [rec]


def _solve_checkpointed(config: RunConfig, solver, kind, problem, f, mesh,
                        initial, ckpt_dir, name, out):
    """The solve in chunks of ``--checkpoint-every`` iterations, each a
    warm start from the last and each followed by a checkpoint; an
    existing checkpoint resumes. A Krylov chunk's tolerance is relative to
    its starting residual, so each is rescaled by that residual (measured
    on the host in float64 on resume) to keep the criterion anchored to
    the original ``||b||`` (= ``||f||_2``: solve-mode walls are zero)."""
    from pathlib import Path

    from stencil_tpu_torch.utils import checkpoint as ckpt

    every = max(1, int(config.checkpoint_every))
    budget = int(config.iterations)
    done = 0
    grid = initial
    spec_tag = f"solve:{config.solve}:{name}"
    resume = ckpt.latest(ckpt_dir)
    if resume is not None:
        state = ckpt.load(resume)
        if state.spec_name != spec_tag:
            raise ValueError(
                f"checkpoint {resume} is from {state.spec_name!r}, "
                f"not this solve ({spec_tag!r}); refusing to resume")
        grid = state.to_grid(dtype=problem.dtype, device=problem.device)
        done = state.iteration
        print(f"[{name}] resumed at iteration {done} from {resume}",
              file=out)
    # mg and relax watch update norms, which chunking leaves alone
    rescale = kind == "krylov"
    f64 = np.asarray(f, np.float64)
    bnorm = float(np.linalg.norm(f64.ravel()))
    r = bnorm
    if rescale and grid is not None:
        r = float(np.linalg.norm((f64 - problem.apply_f64(
            grid.interior().double().cpu().numpy())).ravel()))
    rrel = r / bnorm if bnorm else r
    conv = rescale and rrel <= config.tolerance * (1 + 1e-9)
    while not conv and done < budget:
        chunk = min(every, budget - done)
        tol = config.tolerance
        if rescale and r > 0.0:
            # tol * r_chunk_start == config.tolerance * ||b||
            tol = config.tolerance * bnorm / r
        grid, k, r, rrel_chunk, conv = _solve_once(
            config, solver, kind, problem, f, initial=grid,
            budget=chunk, tolerance=tol, mesh=mesh)
        done += max(1, k)
        if rescale:
            rrel = r / bnorm if bnorm else rrel_chunk
            conv = conv and rrel <= config.tolerance * (1 + 1e-9)
        else:
            rrel = rrel_chunk
        path = ckpt.save(Path(ckpt_dir) / f"step_{done:08d}.npz", grid,
                         done, spec_name=spec_tag)
        print(f"[{name}] checkpoint at {done} -> {path} "
              f"(residual {r:.3e})", file=out)
        if k == 0:
            break
    return grid, done, r, rrel, conv
