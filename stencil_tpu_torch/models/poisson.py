"""Poisson equation model family: solve ``laplacian(u) = f`` by Jacobi
relaxation with a fused source term.

Counterpart of ``stencil_tpu/models/poisson.py`` (``PoissonProblem``,
``manufactured_sine``). The 2nd-order discretization of
``laplacian(u) = f`` on an h-spaced grid turns each Jacobi sweep into the
affine update

    u' = S(u) - h^2 / (2*ndim) * f

where ``S`` is the reference's radius-1 star average. ``runner`` runs it
through one of three paths: the eager torch sweep (``xla``/``eager``), the
3D tiled kernel with its source mode (``pallas_tiled``/``tiled``) or the
2D slab kernel with its source mode (``pallas_slab``/``slab``); ``auto``
picks the kernel of the problem's rank, as the JAX package does.

The scaling rule differs per path, as in the JAX package: the eager
runner scales a host ``f`` in its own precision (float64 for a float64
array) and then casts, the kernel runners scale in the problem dtype
(``ops/layout.py:pad_source``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, torch_dtype
from stencil_tpu_torch.core.spec import StencilSpec, star, weighted
from stencil_tpu_torch.registry import Runner, schedule_info


@dataclasses.dataclass(frozen=True)
class PoissonProblem:
    """``laplacian(u) = f`` on a unit-spacing-``h`` grid with Dirichlet
    (default 0), periodic or Neumann walls (``bc``), on ``device``.

    ``shape`` is the interior point count per dim; with the default
    ``h = 1 / (shape[0] + 1)`` the interior samples the open unit cube at
    ``x_i = (i + 1) * h`` (Dirichlet walls sit on the domain boundary).
    """

    shape: Tuple[int, ...]
    h: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"
    device: str = "cuda"

    def __post_init__(self):
        if self.h is None:
            object.__setattr__(self, "h", 1.0 / (self.shape[0] + 1))
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.zero(len(self.shape)))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spec(self) -> StencilSpec:
        """The Jacobi iteration matrix: the reference's radius-1 star
        average (uniform weight ``1/(2*ndim)``)."""
        return star(self.ndim, 1)

    @property
    def operator_spec(self) -> StencilSpec:
        """The equation's left-hand side as taps: the discrete
        ``laplacian`` (center ``-2 ndim / h^2``, faces ``+1/h^2``)."""
        nd, h = self.ndim, float(self.h)
        inv_h2 = 1.0 / (h * h)
        taps = [((0,) * nd, -2.0 * nd * inv_h2)]
        for d in range(nd):
            for sign in (-1, 1):
                off = [0] * nd
                off[d] = sign
                taps.append((tuple(off), inv_h2))
        return weighted(nd, taps, name=f"laplace{nd}d")

    def with_discretization(self, shape, h) -> "PoissonProblem":
        """The same continuous problem on another grid (zero walls)."""
        return dataclasses.replace(
            self, shape=tuple(shape), h=float(h),
            bc=DirichletBC.zero(self.ndim))

    # -- matrix-free operator protocol --

    def operator_data(self):
        return None

    def operator_apply(self, padded: torch.Tensor, data=None) -> torch.Tensor:
        from stencil_tpu_torch.ops.eager import apply_spec

        return apply_spec(padded, self.operator_spec, halo=1)

    def operator_inv_diagonal(self, data=None) -> float:
        # laplacian center tap: -2 ndim / h^2
        return -float(self.h) ** 2 / (2 * self.ndim)

    @property
    def source_scale(self) -> float:
        """``u' = S(u) + source_scale * f``: the per-sweep factor
        ``-h^2 / (2*ndim)`` of the 2nd-order Jacobi splitting."""
        return -(self.h ** 2) / (2 * self.ndim)

    def initial_grid(self, interior=None) -> HaloGrid:
        if interior is None:
            return HaloGrid.create(self.shape, halo=1, bc=self.bc,
                                   dtype=self.dtype, device=self.device)
        return HaloGrid.from_interior(
            torch.as_tensor(interior).to(torch_dtype(self.dtype)), halo=1,
            bc=self.bc, device=self.device)

    def apply_f64(self, interior) -> np.ndarray:
        """``laplacian(u)`` in float64 with the true wall values in the
        ghost ring: the golden twin of the device operator."""
        from stencil_tpu_torch.ops.golden import apply_spec_f64

        return apply_spec_f64(interior, self.operator_spec, self.bc)

    def residual_f64(self, grid: HaloGrid, f) -> float:
        """``max |f - laplacian(u)|`` in float64: the certificate."""
        u = grid.interior().double().cpu().numpy()
        f64 = torch.as_tensor(f).double().cpu().numpy()
        return float(np.max(np.abs(f64 - self.apply_f64(u))))

    def _scaled_source(self, f) -> torch.Tensor:
        """The eager runner's source: a device tensor scaled on the device
        in the problem dtype, a host array scaled in its own precision
        and then cast (the JAX ``xla`` runner's rule)."""
        from stencil_tpu_torch.ops.eager import round_to

        dt = torch_dtype(self.dtype)
        if isinstance(f, torch.Tensor):
            scaled = f.to(device=self.device, dtype=dt) \
                * round_to(self.source_scale, dt)
        else:
            scaled = torch.as_tensor(np.asarray(f) * self.source_scale) \
                .to(device=self.device, dtype=dt)
        if tuple(scaled.shape) != tuple(self.shape):
            raise ValueError(f"source shape {tuple(scaled.shape)} != "
                             f"interior {tuple(self.shape)}")
        return scaled

    def runner(self, f, method: str = "xla", sweeps_per_call: int = 8,
               autotune=False, **plan_kw) -> Runner:
        """A registry-compatible Runner whose every sweep applies the
        fused source: it plugs straight into ``solver.solve``.

        ``method``: ``xla``/``eager`` (any rank), ``pallas_tiled``/
        ``tiled`` (3D, the tiled kernel's source mode), ``pallas_slab``/
        ``slab`` (2D, the slab kernel's source mode), or ``auto`` (the
        kernel of the problem's rank). ``plan_kw`` goes to the kernel's
        plan (``tiles``, ``t0_fixed``, ``schedule``). ``autotune`` (True,
        "on" or "force") runs the tiled kernel on the cached or measured
        winner of the source plan's search on the card (``autotune.py``,
        its ``|src`` key; ``poisson.py:186-197``) unless ``plan_kw`` pins
        the tile; on the CPU, and on the slab kernel, the chooser's plan
        applies."""
        if method == "auto":
            method = "pallas_tiled" if self.ndim == 3 else "pallas_slab"
        if method in ("xla", "eager"):
            from stencil_tpu_torch.ops import eager

            scaled = self._scaled_source(f)
            return Runner(
                name=f"poisson_eager({self.ndim}d)",
                iterate=lambda g, n: eager.iterate(
                    g, self.spec, n, scaled),
                description="Jacobi relaxation of laplacian(u)=f "
                            "(eager torch sweep plus the source add)",
                plan_info={"kernel": "eager", "has_source": True},
            )
        won = None
        if method in ("pallas_tiled", "tiled"):
            if self.ndim != 3:
                raise ValueError(
                    "the tiled source kernel is 3D-only; use "
                    "method='xla' for 2D Poisson problems")
            from stencil_tpu_torch.ops.tiled import TiledStencil as Stencil
            kernel = "tiled"
            from stencil_tpu_torch import autotune as at

            if autotune and "tiles" not in plan_kw \
                    and "t0_fixed" not in plan_kw \
                    and at.tunes_on(self.device):
                won = at.autotune(self.spec, self.shape, self.dtype,
                                  sweeps_per_call,
                                  force=(autotune == "force"),
                                  has_source=True, device=self.device)
                if won:
                    plan_kw = {**plan_kw, "tiles": tuple(won["tiles"]),
                               "schedule": won["schedule"]}
        elif method in ("pallas_slab", "slab"):
            if self.ndim != 2:
                raise ValueError(
                    "the slab source kernel is 2D-only; use "
                    "method='pallas_tiled' for 3D Poisson problems")
            from stencil_tpu_torch.ops.slab import SlabStencil as Stencil
            kernel = "slab"
        else:
            raise ValueError(f"unknown Poisson method {method!r} (xla | "
                             "eager | pallas_tiled | tiled | pallas_slab | "
                             "slab | auto)")
        m = Stencil(self.spec, self.shape, dtype=self.dtype,
                    sweeps_per_call=sweeps_per_call, device=self.device,
                    source=f, source_scale=self.source_scale, **plan_kw)
        info = {"kernel": kernel, "k": sweeps_per_call,
                "tiles": list(m.plan.tiles), **schedule_info(m.plan),
                "smem_bytes": m.plan.smem_bytes, "has_source": True}
        if won:
            info.update(source="autotune", autotune_glups=won.get("glups"))
        return Runner(
            name=f"poisson_{kernel}(k={sweeps_per_call})",
            iterate=m.iterate,
            granularity=sweeps_per_call,
            description=f"Jacobi relaxation of laplacian(u)=f on the "
                        f"{kernel} kernel (source added in the kernel)",
            plan_info=info,
        )

    def sharded_runner(self, f, mesh, sweeps_per_call: int = 8,
                       axis_names=("x",), **kw) -> Runner:
        """Distributed Poisson relaxation: the tiled kernel's source mode
        per rank + a k*r-deep halo exchange over ``mesh``
        (``parallel/mesh.py``; its axes ``axis_names`` shard d0, or d0 and
        d1), 3D only. The static source is exchanged once per iterate
        call (``parallel/sharded_kernel.py``); ``kw`` goes to
        ``ShardedKernelStencil`` (``overlap``, ``t0_fixed``).

        Counterpart of ``stencil_tpu/models/poisson.py:sharded_runner``
        (:242-267)."""
        if self.ndim != 3:
            raise ValueError("sharded Poisson is 3D-only")
        from stencil_tpu_torch.parallel.sharded_kernel import (
            ShardedKernelStencil,
        )

        m = ShardedKernelStencil(
            self.spec, self.shape, dtype=self.dtype,
            sweeps_per_call=sweeps_per_call, axis_names=tuple(axis_names),
            has_source=True, **kw)
        plan = m.local_plan(m.mesh_shape(mesh))
        return Runner(
            name=f"poisson_sharded(k={sweeps_per_call})",
            iterate=lambda g, n: m.iterate(
                g, n, mesh, source=f, source_scale=self.source_scale),
            granularity=sweeps_per_call,
            description="distributed Jacobi relaxation of laplacian(u)=f "
                        "(the tiled source kernel per rank + halo "
                        "exchange)",
            plan_info={"kernel": "tiled", "k": sweeps_per_call,
                       "mesh": list(m.mesh_shape(mesh)),
                       "tiles": list(plan.tiles), **schedule_info(plan),
                       "smem_bytes": plan.smem_bytes, "has_source": True},
        )

    def solve(self, f, tolerance: float = 1e-6,
              max_iterations: int = 200_000, check_every: int = 200,
              progress=None, method: str = "xla", **runner_kw):
        """Relax to the discrete solution of ``laplacian(u) = f``;
        returns ``solver.SolveResult``."""
        from stencil_tpu_torch import solver

        return solver.solve(self.runner(f, method=method, **runner_kw),
                            self.initial_grid(),
                            tolerance=tolerance,
                            max_iterations=max_iterations,
                            check_every=check_every, progress=progress)


def manufactured_sine(shape: Tuple[int, ...], h: Optional[float] = None):
    """Manufactured Dirichlet-0 test problem: ``u*(x) = prod_d
    sin(pi x_d / L_d)`` on the box with per-dim extent
    ``L_d = (shape[d] + 1) * h``, so u* vanishes on every wall and
    ``laplacian(u*) = -pi^2 (sum_d 1/L_d^2) u*``. Returns ``(f, u_exact)``
    as float64 arrays on the interior points ``x_i = (i + 1) * h``; the
    discrete solve converges to ``u_exact`` up to the O(h^2)
    discretization error."""
    if h is None:
        h = 1.0 / (shape[0] + 1)
    extents = [(n + 1) * h for n in shape]
    axes = [np.sin(np.pi * (np.arange(1, n + 1) * h) / L)
            for n, L in zip(shape, extents)]
    u = axes[0]
    for a in axes[1:]:
        u = np.multiply.outer(u, a)
    f = -np.pi ** 2 * sum(1.0 / (L * L) for L in extents) * u
    return f, u
