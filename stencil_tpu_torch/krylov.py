"""Matrix-free Krylov solvers: conjugate gradients for the SPD Poisson
operator, optionally multigrid-preconditioned, and BiCGStab and restarted
GMRES for any operator of the generic protocol, optionally preconditioned
by ``OperatorMultigrid``.

Counterpart of ``stencil_tpu/krylov.py`` (``CGResult``, ``_initial_or``,
``ConjugateGradient``, ``BiCGStab``, ``GMRES``) on one device. The discrete
operator ``A = -L`` (``L u ~ (nb_sum(u) - 2 ndim u)/h^2``) is SPD on the
zero-Dirichlet interior. Nonzero walls go through the correction form:
``u = u0 + e`` with ``u0`` the wall-pinned starting grid, ``A e = -(f - L
u0)`` solved with the zero-wall operator, ``e`` seated back into ``u0``.
CG's preconditioner is one ``Multigrid`` cycle on the zero-walled
correction problem per iteration; a tiled fine level runs on a zero-wall
clone of the problem, because its kernels hold the problem's walls in
their ghosts.

Where the JAX solve is one ``while_loop`` with one fetch, this loop stays on
the host but keeps every scalar (alpha, beta, rho, the iteration count, a
converged flag) as a 0-dim device tensor. It reads the flag on the host
only every ``check_every`` iterations; the iterations run after
convergence and before that check are masked (alpha = 0 and the count
frozen, through ``torch.where`` on the flag), so the returned grid,
``iterations`` and ``residual`` equal those of a check after every
iteration. ``BiCGStab`` reads its convergence test on the host after
every iteration instead (its cycles are host-bound, so the sync costs
little), and returns the JAX solve's iteration count and certificate;
``GMRES`` reads its residual estimate after every Arnoldi step (see its
docstring).

``mesh=`` distributes a solve over the single-controller mesh
(``parallel/mesh.py``), as JAX's GSPMD solve does: the Krylov vectors are
fields of ``parallel/sharded_field.py`` cut like the fine level (mesh axis
``a`` shards grid dim ``dim + a``), a preconditioning cycle runs on its
per-level ladder (``Multigrid._level_shardings``, replicated coarse tail),
the operator applies per block after a one-deep halo exchange, and each
dot product sums the ranks' partial sums in rank order (the all-reduce).
Each solver's loop is written once, over ``A``, ``dot``, the
preconditioner and these vectors; the host syncs per iteration are the
one-device solve's. The result is the one-device solve's to the rounding
of the dot products.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, dtype_name, torch_dtype,
)
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.multigrid import (
    Multigrid, _DenseLevels, _MeshLevels, _nb_sum, _residual,
)
from stencil_tpu_torch.parallel import sharded_field as sf
from stencil_tpu_torch.parallel.sharded_field import dot as _dot
from stencil_tpu_torch.utils.tracing import count, span


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


def _check_mesh_operator(problem, preconditioner) -> None:
    """A distributed solve applies the operator per block; the tiled
    kernel's coefficient matvec (``kernel='pallas'``) runs on the whole
    grid: refused with JAX's message (``stencil_tpu/krylov.py:66-79``)."""
    probs = [problem]
    if preconditioner is not None:
        probs += list(getattr(preconditioner, "_probs", ()))
    for p in probs:
        if getattr(p, "_use_kernel", False):
            raise ValueError(
                "distributed solves need the GSPMD XLA operator: "
                "construct the problem with kernel='xla' (the pallas "
                "coeff matvec is single-device)")


def _fine_sharding(mesh, dim: int, ndim: int, shape):
    """The unpreconditioned solvers' layout of the Krylov vectors: mesh
    axis ``a`` shards grid dim ``dim + a`` in balanced blocks (1D or 2D
    meshes; JAX's checks and messages, ``stencil_tpu/krylov.py:82-102``).
    Preconditioned solves take the cycle's fine layout instead."""
    naxes = len(mesh.axis_names)
    if naxes not in (1, 2):
        raise ValueError(
            f"distributed Krylov wants a 1D or 2D mesh, got axes "
            f"{mesh.axis_names}")
    if not 0 <= dim <= ndim - naxes:
        raise ValueError(
            f"mesh axes {mesh.axis_names} shard grid dims "
            f"{dim}..{dim + naxes - 1}, out of range for {ndim}D")
    return sf.fine_layout(mesh, shape, dim)


def _mesh_plan(problem, preconditioner, mesh, dim, replicate_below):
    """``(layout, levels)`` of a solve: (None, None) on one device; on a
    mesh the Krylov vectors' layout and, with a preconditioner, the level
    hooks of its cycle's ladder."""
    if mesh is None:
        return None, None
    if preconditioner is None:
        shape = tuple(problem.shape)
        return _fine_sharding(mesh, dim, len(shape), shape), None
    layouts, _, _ = preconditioner._level_shardings(mesh, dim,
                                                    replicate_below)
    return layouts[0], _MeshLevels(layouts)


def _operators(problem, preconditioner, mesh, dim, replicate_below):
    """``(layout, A, A_padded, K)`` of a BiCGStab or GMRES solve, built
    once per solve: the vectors' layout (None on one device); ``A(e)``
    the zero-wall operator of an interior-shaped vector; ``A_padded(p)``
    the operator of a global padded grid with its true walls (cut into
    blocks on a mesh); ``K(r)`` one ``OperatorMultigrid`` cycle from a
    zero guess (linear in ``r``) on the cycle's ladder, or the
    identity."""
    layout, levels = _mesh_plan(problem, preconditioner, mesh, dim,
                                replicate_below)
    apply_op = problem.operator_apply
    op_data = sf.distribute(problem.operator_data(), layout, lead=1)

    def A(e):
        return sf.per_block(apply_op, sf.pad1(e), op_data)

    def A_padded(padded):
        return sf.per_block(apply_op, sf.distribute(padded, layout, halo=1),
                            op_data)

    if preconditioner is None:
        return layout, A, A_padded, lambda r: r
    kdatas = preconditioner._level_datas(
        None if levels is None else levels.layouts)
    cycle = preconditioner._make_cycle(levels)
    return layout, A, A_padded, lambda r: cycle(sf.zeros_like(r), r, 0,
                                                kdatas)


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

    def _precond(self, levels=None):
        """``precond(r) -> z ~ A^-1 r``: one MG cycle on the zero-walled
        correction problem ``L e ~ r`` (so ``z = -e``); ``r`` itself
        without a preconditioner. ``levels`` (``_MeshLevels``) runs the
        cycle on sharded fields."""
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
                return -sf.interior(e_pad)
        else:
            lv = _DenseLevels if levels is None else levels
            cycle = mg._make_cycle(levels)
            pdt = (torch_dtype(self.precond_dtype)
                   if self.precond_dtype is not None else None)

            def precond(r):
                rc = r.to(pdt) if pdt is not None else r
                e_pad = cycle(lv.zeros_padded(rc, 0), (h * h) * rc, rc, 0)
                if pdt is not None:
                    e_pad = e_pad.to(r.dtype)
                return -sf.interior(e_pad)
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
        module docstring): the result does not depend on it. ``mesh`` (a
        1D or 2D ``parallel/mesh.py`` mesh) distributes the solve (see the
        module docstring): the vectors shard along grid dims ``dim..``, the
        preconditioning cycle runs its ladder (``replicate_below``)."""
        if mesh is not None and self.preconditioner is not None \
                and self.preconditioner.tiled_fine:
            raise ValueError(
                "distributed PCG runs the all-XLA GSPMD cycle; "
                "build the Multigrid with fine_method='xla' "
                "(the tiled fine kernel is single-device)")
        if check_every < 1:
            raise ValueError("check_every must be >= 1")
        with span("cg.solve"):
            return self._solve(f, tolerance, max_iterations, mesh, dim,
                               replicate_below, initial, check_every)

    def _solve(self, f, tolerance, max_iterations, mesh, dim,
               replicate_below, initial, check_every) -> CGResult:
        prob = self.problem
        with span("cg.setup"):
            f_t = torch.as_tensor(f).to(device=prob.device,
                                        dtype=torch_dtype(prob.dtype))
            if tuple(f_t.shape) != tuple(prob.shape):
                raise ValueError(f"source shape {tuple(f_t.shape)} != "
                                 f"interior {tuple(prob.shape)}")
            g0 = _initial_or(prob, initial)
            ndim = prob.ndim
            h = float(prob.h)
            inv_h2 = 1.0 / (h * h)
            two_d = float(2 * ndim)
            tol2 = float(tolerance) ** 2
            layout, levels = _mesh_plan(prob, self.preconditioner, mesh, dim,
                                        replicate_below)
            precond = self._precond(levels)

            def lap(e_pad, e):
                return (two_d * e - _nb_sum(e_pad)) * inv_h2

            def A(e):  # zero-wall SPD operator on interior-shaped tensors
                return sf.per_block(lap, sf.pad1(e), e)

            # b = -(f - L u0): the zero-wall correction right-hand side
            b = -_residual(sf.distribute(g0.data, layout, halo=1),
                           sf.distribute(f_t, layout), inv_h2, two_d)
            bb = _dot(b, b)
            x = sf.zeros_like(b)
            r = b
            z = precond(r)
            p = z
            rz = _dot(r, z)
            k = torch.zeros((), dtype=torch.int32, device=b.device)

            def finished(r, k):
                return ~(_dot(r, r) > tol2 * bb) | (k >= max_iterations)

            done = finished(r, k)
        for it in range(max_iterations):
            with span("cg.iteration"):
                if it % check_every == 0:
                    count("host_syncs")
                    with span("cg.check"):
                        stop = bool(done)
                    if stop:
                        break
                with span("cg.matvec"):
                    q = A(p)
                with span("cg.update"):
                    # a finished solve keeps x and r exactly (alpha = 0)
                    # and its count, whatever the masked iteration
                    # computes
                    alpha = torch.where(done, torch.zeros_like(rz),
                                        rz / _dot(p, q))
                    x = x + alpha * p
                    r = r - alpha * q
                with span("cg.precond"):
                    z = precond(r)
                with span("cg.update"):
                    rz_new = _dot(r, z)
                    p = z + (rz_new / rz) * p
                    rz = rz_new
                    k = k + (~done).to(k.dtype)
                    done = done | finished(r, k)
        with span("cg.stats"):
            padded = sf.seat(g0.data, x)
            rr = _dot(r, r)
            # one stats vector, one device-to-host copy
            count("host_syncs")
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


@dataclasses.dataclass(frozen=True)
class BiCGStab:
    """Stabilized bi-conjugate gradients for any stencil operator.

    ``problem`` exposes ``shape``/``dtype``/``bc``/``h``/``device``,
    ``initial_grid()`` and the operator protocol (``operator_data``,
    ``operator_apply`` on a halo-1 padded tensor): the heterogeneous
    Poisson problem, and ``PoissonProblem`` too (on the symmetric case
    BiCGStab lands on CG's solution). ``preconditioner`` is an
    ``multigrid.OperatorMultigrid`` on the same problem: one cycle right-
    preconditions each of the two operator applications per iteration.

    Nonzero Dirichlet walls ride the correction form (``u = u0 + e``, the
    zero-wall operator on ``e``). The recurrence divides by ``<rhat, r>``,
    ``<rhat, v>`` and ``<t, t>``; an exact zero is replaced by the dtype's
    tiny. The half-step exit (``|s|`` below the tolerance) skips the
    stabilization step. The loop watches the recurrence residual at half
    the tolerance; the certificate is the true residual of the returned
    solution. When it misses the tolerance, the solve restarts from the
    current solution (the recurrence's drift reset), the tolerance still
    relative to the original ``||b||``, within one iteration budget."""

    problem: object
    preconditioner: Optional[object] = None

    def __post_init__(self):
        if self.problem.bc.any_dynamic:
            raise ValueError(
                "BiCGStab solves Dirichlet-wall problems (the "
                "periodic/Neumann steady operator annihilates "
                "constants and is singular)")
        mg = self.preconditioner
        if mg is not None:
            if tuple(mg.problem.shape) != tuple(self.problem.shape) \
                    or float(mg.problem.h) != float(self.problem.h):
                raise ValueError(
                    "preconditioner built on a different problem "
                    f"({tuple(mg.problem.shape)}, h={mg.problem.h}) "
                    f"than ({tuple(self.problem.shape)}, "
                    f"h={self.problem.h})")

    def _attempt(self, padded0: torch.Tensor, f, budget: int,
                 bb_ref: float, tol2: float, A, A_padded, K):
        """One (re)start: at most ``budget`` iterations from the global
        padded ``padded0`` (``f`` on the layout of ``_operators``' ``A``,
        ``A_padded`` and ``K``); returns (padded, iterations, |r|,
        |r|/|b|, |b|^2), the residual that of the solution. ``bb_ref > 0``
        carries the original ``|b|^2`` into a restart."""

        def safe(d):
            return torch.where(d == 0, torch.finfo(d.dtype).tiny, d)

        # b = f - A u0 with the true walls (u0's ghost ring); a restart's
        # b is the current residual, its tolerance still |b_original|'s
        b = f - A_padded(padded0)
        bb = _dot(b, b) if bb_ref <= 0 else torch.tensor(
            bb_ref, dtype=b.dtype, device=b.device)
        x = sf.zeros_like(b)
        r, p, v = b, sf.zeros_like(b), sf.zeros_like(b)
        rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
        zero = torch.zeros_like(rho)
        k = 0
        while k < budget and bool(_dot(r, r) > tol2 * bb):
            rho_new = _dot(b, r)  # rhat = r0 = b
            beta = (rho_new / safe(rho)) * (alpha / safe(omega))
            p = r + beta * (p - omega * v)
            y = K(p)
            v = A(y)
            alpha = rho_new / safe(_dot(b, v))
            s = r - alpha * v
            ss = _dot(s, s)
            z = K(s)
            t = A(z)
            # half-step exit: omega = 0 leaves x += alpha y, r = s
            omega = torch.where(ss <= tol2 * bb, zero,
                                _dot(t, s) / safe(_dot(t, t)))
            x = x + alpha * y + omega * z
            r = s - omega * t
            rho = rho_new
            k += 1
        padded = sf.seat(padded0, x)
        # the certificate from the solution, not the recurrence
        r_true = f - A_padded(padded)
        rr = _dot(r_true, r_true)
        stats = torch.stack([torch.sqrt(rr), torch.sqrt(rr / bb), bb]) \
            .to(torch.float32).cpu().numpy().astype(np.float64)
        return padded, k, float(stats[0]), float(stats[1]), float(stats[2])

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 2000, mesh=None,
              dim: int = 0, restarts: int = 8,
              initial: Optional[HaloGrid] = None,
              replicate_below: Optional[int] = None) -> CGResult:
        """Solve ``A u = f`` to ``||f - A u||_2 <= tolerance * ||b||_2``
        (the certificate is the true residual of the returned solution).
        ``restarts`` bounds the drift-recovery restarts; ``max_iterations``
        is the total budget across them. ``initial`` warm-starts; the
        tolerance is then relative to its residual. ``mesh`` distributes
        the solve (the module docstring), the preconditioning cycle on its
        ladder (``replicate_below``)."""
        if mesh is not None:
            _check_mesh_operator(self.problem, self.preconditioner)
        prob = self.problem
        f_t = torch.as_tensor(f).to(device=prob.device,
                                    dtype=torch_dtype(prob.dtype))
        if tuple(f_t.shape) != tuple(prob.shape):
            raise ValueError(f"source shape {tuple(f_t.shape)} != interior "
                             f"{tuple(prob.shape)}")
        g0 = _initial_or(prob, initial)
        # the loop watches the recurrence residual, the certificate is the
        # solution's: exit 2x tighter so the certificate lands under
        tol2 = (0.5 * float(tolerance)) ** 2
        layout, *ops = _operators(prob, self.preconditioner, mesh, dim,
                                  replicate_below)
        f_v = sf.distribute(f_t, layout)
        padded = g0.data
        total, remaining, bb0 = 0, int(max_iterations), 0.0
        for _ in range(max(0, int(restarts)) + 1):
            padded, k, rnorm, rrel, bb0 = self._attempt(
                padded, f_v, remaining, bb0, tol2, *ops)
            total += k
            remaining -= k
            if rrel <= tolerance or remaining <= 0 or k == 0:
                break
        return CGResult(
            grid=HaloGrid(data=padded, halo=1, bc=g0.bc),
            iterations=total,
            residual=rnorm,
            residual_rel=rrel,
            converged=bool(rrel <= tolerance),
        )


@dataclasses.dataclass(frozen=True)
class GMRES:
    """Restarted GMRES(m) for nonsymmetric stencil operators, with the
    operator protocol and right preconditioning of ``BiCGStab``:
    constant-tap operators (``AdvectionDiffusionProblem``,
    ``PoissonProblem``) and field operators
    (``HeterogeneousPoissonProblem``) alike, and ``OperatorMultigrid`` as
    ``preconditioner`` (one cycle per Arnoldi step; right preconditioning
    keeps the minimized residual the true one).

    Each restart cycle runs up to ``restart`` Arnoldi steps over a basis
    held on the device as one ``(m+1,) + shape`` tensor. A step
    orthogonalizes ``A K v_j`` by classical Gram-Schmidt run twice (CGS2:
    each pass one product of the stacked basis ``V[:j+1]`` with the vector
    and one back, torch matrix products, as JAX's ``tensordot``s are no
    Pallas kernel), then updates the least-squares problem by Givens
    rotations. The cycle ends with the back substitution and one
    recombination of the basis, and certifies the true residual of the
    solution, anchored to the original ``||b||``; a cycle that misses the
    tolerance restarts from its solution, within one step budget, unless
    it failed to contract the certificate below ``stall_ratio`` times the
    previous one.

    Where the JAX cycle is one ``while_loop`` with one fetch, this loop
    stays on the host: after every Arnoldi step it fetches the step's
    Hessenberg column (j + 2 scalars), applies the rotations and reads the
    residual estimate ``|g[j]|`` against half the tolerance on the host,
    in the problem's dtype (float32 for a bfloat16 problem), as BiCGStab
    reads its test after every iteration. The step count and the
    certificate are JAX's.

    Counterpart of ``stencil_tpu/krylov.py:GMRES`` (:609-952). On a mesh
    the basis is one ``(m+1, block points)`` tensor per block, its
    products per block and their sums one all-reduce per pass."""

    problem: object
    preconditioner: Optional[object] = None
    restart: int = 16

    def __post_init__(self):
        if self.restart < 1:
            raise ValueError(f"restart must be >= 1, got {self.restart}")
        if self.problem.bc.any_dynamic:
            raise ValueError(
                "GMRES solves Dirichlet-wall problems (the "
                "periodic/Neumann steady operator annihilates "
                "constants and is singular)")
        mg = self.preconditioner
        if mg is not None:
            if tuple(mg.problem.shape) != tuple(self.problem.shape) \
                    or float(mg.problem.h) != float(self.problem.h):
                raise ValueError(
                    "preconditioner built on a different problem "
                    f"({tuple(mg.problem.shape)}, h={mg.problem.h}) "
                    f"than ({tuple(self.problem.shape)}, "
                    f"h={self.problem.h})")

    def _check_basis_budget(self, f: torch.Tensor, mesh=None) -> None:
        """Refuse an ``(m+1) x grid`` basis above half of the device's
        memory (``device_model.hbm_bytes``) before it is allocated, with
        JAX's message. A mesh divides the basis over its distinct devices
        (ranks that share a card share its memory)."""
        from stencil_tpu_torch import device_model

        shape = tuple(f.shape)
        dtype = dtype_name(f.dtype)
        n_dev = 1 if mesh is None else len(set(mesh.devices))
        per_vec = math.prod(shape) * f.element_size() // n_dev
        basis = (self.restart + 1) * per_vec
        hbm = device_model.hbm_bytes(self.problem.device)
        budget = hbm // 2
        if basis > budget:
            fit = max(1, budget // per_vec - 1)
            raise ValueError(
                f"GMRES basis (restart+1) x grid = {self.restart + 1} "
                f"x {shape} {dtype} = {basis / 2**30:.2f} "
                f"GiB per device exceeds half of device memory "
                f"({budget / 2**30:.2f} GiB of "
                f"{hbm / 2**30:.0f} GiB). Reduce "
                f"restart to <= {fit}, shard the solve over a mesh, or "
                f"use BiCGStab (O(1) vectors)")

    def _cycle(self, padded0: torch.Tensor, f, budget: int,
               bb_ref: float, tol2: float, A, A_padded, K):
        """One restart cycle: at most ``min(restart, budget)`` Arnoldi
        steps from the global padded ``padded0`` (``f``, ``A``,
        ``A_padded`` and ``K`` as in ``BiCGStab._attempt``); returns
        (padded, steps, |r|, |r|/|b|, |b|^2), the residual that of the
        solution."""
        m = int(self.restart)
        # the host scalars' dtype: the problem's (numpy has no bfloat16)
        hdt = np.float64 if f.dtype == torch.float64 else np.float32
        tiny = np.finfo(hdt).tiny

        def safe(d):
            return d if d != 0 else hdt(tiny)

        b = f - A_padded(padded0)
        bb_dev = _dot(b, b)
        V = sf.basis(m + 1, b)
        head = torch.stack([bb_dev, torch.sqrt(bb_dev)]).cpu().numpy() \
            .astype(hdt)
        bb = hdt(bb_ref) if bb_ref > 0 else head[0]
        beta = head[1]
        sf.basis_put(V, 0, b / safe(beta))
        H = np.zeros((m + 1, m), hdt)
        cs = np.ones(m, hdt)
        sn = np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = beta
        j = 0
        while g[j] * g[j] > tol2 * bb and j < m and j < budget:
            w = A(K(sf.basis_row(V, j, b)))
            h1 = sf.basis_dots(V, j + 1, w)
            w = w - sf.basis_combine(V, j + 1, h1, b)
            h2 = sf.basis_dots(V, j + 1, w)
            w = w - sf.basis_combine(V, j + 1, h2, b)
            hnorm = torch.sqrt(_dot(w, w))
            col = torch.cat([h1 + h2, hnorm.reshape(1)]).cpu().numpy() \
                .astype(hdt)
            sf.basis_put(V, j + 1, w / safe(col[-1]))
            hcol = np.zeros(m + 1, hdt)
            hcol[:j + 2] = col
            # the earlier rotations, then a new one zeroing the
            # subdiagonal; |g| tracks the least-squares residual
            for i in range(j):
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hi1 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i], hcol[i + 1] = hi, hi1
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = hcol[j] / safe(denom)
            s = hcol[j + 1] / safe(denom)
            hcol[j] = denom
            hcol[j + 1] = 0.0
            gj = g[j]
            g[j + 1] = -s * gj
            g[j] = c * gj
            H[:, j] = hcol
            cs[j] = c
            sn[j] = s
            j += 1
        # back substitution on the rotated H over the j live columns; a
        # breakdown row has H[i, i] == 0 and g[i] == 0, so y_i = 0
        y = np.zeros(m, hdt)
        for i in range(m - 1, -1, -1):
            if i < j:
                y[i] = (g[i] - np.dot(H[i, :], y)) / safe(H[i, i])
        padded = padded0.clone()
        if j:
            yt = torch.from_numpy(y[:j]).to(device=b.device, dtype=b.dtype)
            padded = sf.seat(padded0, K(sf.basis_combine(V, j, yt, b)))
        r_true = f - A_padded(padded)
        rr = _dot(r_true, r_true)
        bb_t = torch.tensor(float(bb), dtype=b.dtype, device=b.device)
        stats = torch.stack([torch.sqrt(rr), torch.sqrt(rr / bb_t), bb_t]) \
            .to(torch.float32).cpu().numpy().astype(np.float64)
        return padded, j, float(stats[0]), float(stats[1]), float(stats[2])

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 2000, mesh=None, dim: int = 0,
              initial: Optional[HaloGrid] = None,
              replicate_below: Optional[int] = None,
              stall_ratio: Optional[float] = 0.9) -> CGResult:
        """Solve ``A u = f`` to ``||f - A u||_2 <= tolerance * ||b||_2``
        (the true residual's certificate). ``max_iterations`` is the
        total Arnoldi-step budget across restart cycles; at ``<= 0`` one
        cycle of no step still certifies the initial iterate (a warm start
        already within tolerance is converged). ``initial`` warm-starts,
        the tolerance then relative to its residual. ``stall_ratio`` stops
        restarting when a cycle fails to contract the certificate below
        that ratio of the previous one (the fp32 floor); None spends the
        whole budget. ``mesh`` distributes the solve as for BiCGStab."""
        prob = self.problem
        f_t = torch.as_tensor(f).to(device=prob.device,
                                    dtype=torch_dtype(prob.dtype))
        if tuple(f_t.shape) != tuple(prob.shape):
            raise ValueError(
                f"source shape {tuple(f_t.shape)} != interior "
                f"{tuple(prob.shape)}")
        self._check_basis_budget(f_t, mesh)
        if mesh is not None:
            _check_mesh_operator(prob, self.preconditioner)
        g0 = _initial_or(prob, initial)
        # the loop watches the recurrence estimate, the certificate is the
        # solution's: exit 2x tighter so the certificate lands under
        tol2 = (0.5 * float(tolerance)) ** 2
        layout, *ops = _operators(prob, self.preconditioner, mesh, dim,
                                  replicate_below)
        f_v = sf.distribute(f_t, layout)
        padded = g0.data
        total = 0
        remaining = int(max_iterations)
        bb0 = 0.0
        rnorm = rrel = prev_rrel = float("inf")
        while True:
            padded, k, rnorm, rrel, bb0 = self._cycle(
                padded, f_v, max(0, remaining), bb0, tol2, *ops)
            total += k
            remaining -= k
            if rrel <= tolerance or k == 0 or remaining <= 0:
                break
            # the certificate floors at fp32 rounding whatever the
            # recurrence reports: a cycle that does not contract it past
            # stall_ratio would re-solve rounding noise
            if stall_ratio is not None and rrel > stall_ratio * prev_rrel:
                break
            prev_rrel = rrel
        return CGResult(
            grid=HaloGrid(data=padded, halo=1, bc=g0.bc),
            iterations=total,
            residual=rnorm,
            residual_rel=rrel,
            converged=bool(rrel <= tolerance),
        )
