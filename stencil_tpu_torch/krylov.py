"""Matrix-free conjugate gradients for the SPD Poisson operator, optionally
multigrid-preconditioned.

Counterpart of ``stencil_tpu/krylov.py`` (``CGResult``, ``_initial_or``,
``ConjugateGradient``) on one device. The discrete operator ``A = -L``
(``L u ~ (nb_sum(u) - 2 ndim u)/h^2``) is SPD on the zero-Dirichlet
interior. Nonzero walls go through the correction form: ``u = u0 + e``
with ``u0`` the wall-pinned starting grid, ``A e = -(f - L u0)`` solved
with the zero-wall operator, ``e`` seated back into ``u0``. The
preconditioner is one ``Multigrid`` cycle on the zero-walled correction
problem per iteration; a tiled fine level runs on a zero-wall clone of the
problem, because its kernels hold the problem's walls in their ghosts.

Where the JAX solve is one ``while_loop`` with one fetch, this loop stays on
the host but keeps every scalar (alpha, beta, rho, the iteration count, a
converged flag) as a 0-dim device tensor. It reads the flag on the host
only every ``check_every`` iterations; the iterations run after
convergence and before that check are masked (alpha = 0 and the count
frozen, through ``torch.where`` on the flag), so the returned grid,
``iterations`` and ``residual`` equal those of a check after every
iteration. ``mesh=`` (the distributed solve) and the ``BiCGStab`` and
``GMRES`` solvers are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, torch_dtype
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.multigrid import (
    Multigrid, _interior, _nb_sum, _residual,
)


@dataclasses.dataclass(frozen=True)
class CGResult:
    grid: HaloGrid
    iterations: int
    residual: float          # final ||f - L u||_2 (absolute)
    residual_rel: float      # relative to ||b||_2
    converged: bool

    def summary(self) -> str:
        return (f"{'converged' if self.converged else 'NOT converged'} "
                f"in {self.iterations} iterations, "
                f"|r|_2 = {self.residual:.3e} "
                f"(rel {self.residual_rel:.3e})")


def _initial_or(problem, initial: Optional[HaloGrid]) -> HaloGrid:
    """The warm-start iterate, validated, or the problem's zero-interior
    wall-pinned grid."""
    if initial is None:
        return problem.initial_grid()
    if initial.halo != 1:
        raise ValueError("warm-start grids must have halo=1")
    if initial.interior_shape != tuple(problem.shape):
        raise ValueError(
            f"warm-start interior {initial.interior_shape} != "
            f"{tuple(problem.shape)}")
    if initial.bc != problem.bc:
        raise ValueError(
            "warm-start grid carries different boundary conditions "
            "than the problem")
    return initial


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


@dataclasses.dataclass(frozen=True)
class ConjugateGradient:
    """CG / MG-preconditioned CG for a ``PoissonProblem`` (Dirichlet walls
    only). ``preconditioner=None`` gives plain CG; a ``Multigrid`` built on
    the same problem (``nu1 == nu2``, so the cycle is symmetric) gives
    PCG. ``precond_dtype`` runs the eager preconditioning cycle's arrays in
    that dtype (e.g. 'bfloat16'); the Krylov recurrence stays in the
    problem dtype."""

    problem: PoissonProblem
    preconditioner: Optional[Multigrid] = None
    precond_dtype: Optional[str] = None

    def __post_init__(self):
        if self.problem.bc.any_dynamic:
            raise ValueError(
                "CG needs the SPD Dirichlet operator (the pure "
                "periodic/Neumann Poisson problem is singular)")
        if self.precond_dtype is not None:
            if self.preconditioner is None:
                raise ValueError(
                    "precond_dtype needs a preconditioner")
            if self.preconditioner.tiled_fine:
                raise ValueError(
                    "precond_dtype runs the all-XLA cycle; the tiled "
                    "fine kernels are plan-typed in the problem dtype")
        mg = self.preconditioner
        if mg is not None:
            if tuple(mg.problem.shape) != tuple(self.problem.shape) or \
                    float(mg.problem.h) != float(self.problem.h):
                raise ValueError(
                    "preconditioner built on a different problem "
                    f"({mg.problem.shape}, h={mg.problem.h}) than "
                    f"({self.problem.shape}, h={self.problem.h})")
            if mg.nu1 != mg.nu2:
                raise ValueError(
                    "PCG needs a symmetric preconditioner: build the "
                    f"Multigrid with nu1 == nu2 (got {mg.nu1}, {mg.nu2})")

    def _precond(self):
        """``precond(r) -> z ~ A^-1 r``: one MG cycle on the zero-walled
        correction problem ``L e ~ r`` (so ``z = -e``); ``r`` itself
        without a preconditioner."""
        mg = self.preconditioner
        h = float(self.problem.h)
        if mg is None:
            def precond(r):
                return r
        elif mg.tiled_fine:
            mg0 = mg
            if any(v != (0.0, 0.0) for v in mg.problem.bc.values):
                mg0 = dataclasses.replace(mg, problem=dataclasses.replace(
                    mg.problem, bc=DirichletBC.zero(self.problem.ndim)))
            vcycle = mg0._vcycle_fn(mg0._fine_ops())

            def precond(r):
                e_pad = vcycle(r.new_zeros(tuple(s + 2 for s in r.shape)),
                               r)
                return -e_pad[_interior(e_pad.shape)]
        else:
            cycle = mg._make_cycle()
            pdt = (torch_dtype(self.precond_dtype)
                   if self.precond_dtype is not None else None)

            def precond(r):
                rc = r.to(pdt) if pdt is not None else r
                e_pad = cycle(rc.new_zeros(tuple(s + 2 for s in r.shape)),
                              (h * h) * rc, rc, 0)
                if pdt is not None:
                    e_pad = e_pad.to(r.dtype)
                return -e_pad[_interior(e_pad.shape)]
        return precond

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 1000, mesh=None, dim: int = 0,
              replicate_below: Optional[int] = None,
              initial: Optional[HaloGrid] = None,
              check_every: int = 8) -> CGResult:
        """Solve to ``||r||_2 <= tolerance * ||b||_2`` (relative 2-norm;
        fp32 floors near ~1e-6). ``initial`` warm-starts from an existing
        iterate; ``b`` is then the residual of that iterate, so
        ``tolerance`` contracts the initial residual. The converged flag
        is read on the host every ``check_every`` iterations (see the
        module docstring): the result does not depend on it."""
        if mesh is not None:
            raise NotImplementedError(
                "the distributed CG/PCG solve (mesh=) is not ported yet to "
                "stencil_tpu_torch (replaces stencil_tpu/krylov.py:"
                "ConjugateGradient._solve_fn's mesh path)")
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        prob = self.problem
        f_t = torch.as_tensor(f).to(device=prob.device,
                                    dtype=torch_dtype(prob.dtype))
        if tuple(f_t.shape) != tuple(prob.shape):
            raise ValueError(f"source shape {tuple(f_t.shape)} != interior "
                             f"{tuple(prob.shape)}")
        g0 = _initial_or(prob, initial)
        ndim = prob.ndim
        h = float(prob.h)
        inv_h2 = 1.0 / (h * h)
        two_d = float(2 * ndim)
        tol2 = float(tolerance) ** 2
        precond = self._precond()

        def A(e):  # zero-wall SPD operator on interior-shaped tensors
            return (two_d * e - _nb_sum(F.pad(e, (1, 1) * ndim))) * inv_h2

        # b = -(f - L u0): the zero-wall correction right-hand side
        b = -_residual(g0.data, f_t, inv_h2, two_d)
        bb = _dot(b, b)
        x = torch.zeros_like(b)
        r = b
        z = precond(r)
        p = z
        rz = _dot(r, z)
        k = torch.zeros((), dtype=torch.int32, device=b.device)

        def finished(r, k):
            return ~(_dot(r, r) > tol2 * bb) | (k >= max_iterations)

        done = finished(r, k)
        for it in range(max_iterations):
            if it % check_every == 0 and bool(done):
                break
            q = A(p)
            # a finished solve keeps x and r exactly (alpha = 0) and its
            # count, whatever the masked iteration computes
            alpha = torch.where(done, torch.zeros_like(rz),
                                rz / _dot(p, q))
            x = x + alpha * p
            r = r - alpha * q
            z = precond(r)
            rz_new = _dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            k = k + (~done).to(k.dtype)
            done = done | finished(r, k)
        padded = g0.data.clone()
        padded[_interior(padded.shape)].add_(x)
        rr = _dot(r, r)
        # one stats vector, one device-to-host copy
        stats = torch.stack([k.to(torch.float32),
                             torch.sqrt(rr).to(torch.float32),
                             torch.sqrt(rr / bb).to(torch.float32)]).cpu()
        stats = stats.numpy().astype(np.float64)
        rrel = float(stats[2])
        return CGResult(
            grid=HaloGrid(data=padded, halo=1, bc=g0.bc),
            iterations=int(stats[0]),
            residual=float(stats[1]),
            residual_rel=rrel,
            converged=bool(rrel <= tolerance),
        )


class BiCGStab:
    """Stabilized bi-conjugate gradients: not ported yet (it serves the
    advection-diffusion family, a later slice)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "BiCGStab is not ported yet to stencil_tpu_torch (replaces "
            "stencil_tpu/krylov.py:BiCGStab)")


class GMRES:
    """Restarted GMRES: not ported yet (a later slice)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GMRES is not ported yet to stencil_tpu_torch (replaces "
            "stencil_tpu/krylov.py:GMRES)")
