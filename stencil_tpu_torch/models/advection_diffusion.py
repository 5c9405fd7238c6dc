"""Steady advection-diffusion: solve ``-nu laplacian(u) + v . grad(u) = f``
on Dirichlet walls.

Counterpart of ``stencil_tpu/models/advection_diffusion.py``
(``AdvectionDiffusionProblem``, :42-213), on ``device``. The operator is
nonsymmetric, so it pairs with ``krylov.BiCGStab`` and ``krylov.GMRES``,
preconditioned by ``multigrid.OperatorMultigrid``.

Discretization per dim ``d`` (spacing ``h``, velocity ``v_d``):

- diffusion, the central star ``-nu (u_{i-1} - 2 u_i + u_{i+1})/h^2``;
- ``scheme='upwind'`` advection (1st order), the difference on the
  upstream side, ``v_d (u_i - u_{i-1})/h`` for ``v_d > 0``: an M-matrix at
  every Peclet number;
- ``scheme='central'`` advection (2nd order), ``v_d (u_{i+1} -
  u_{i-1})/(2 h)``: monotone only while the mesh Peclet number ``|v_d| h
  / (2 nu)`` is at most 1, and refused above.

``operator_spec`` holds the taps in JAX's order, weight for weight, and
``operator_apply`` applies them with the eager sweep
(``ops/eager.apply_spec``); ``apply_f64`` is the float64 twin
(``ops/golden.apply_spec_f64``) behind the certificate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, torch_dtype
from stencil_tpu_torch.core.spec import StencilSpec, weighted


@dataclasses.dataclass(frozen=True)
class AdvectionDiffusionProblem:
    """``-nu laplacian(u) + v . grad(u) = f`` on an h-spaced interior with
    Dirichlet walls, on ``device`` (periodic or Neumann walls make the
    operator singular and are refused). The default ``h = 1 / (shape[0] +
    1)`` matches ``PoissonProblem``."""

    shape: Tuple[int, ...]
    velocity: Tuple[float, ...]
    nu: float = 1.0
    h: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"
    scheme: str = "upwind"
    device: str = "cuda"

    def __post_init__(self):
        if len(self.velocity) != len(self.shape):
            raise ValueError(
                f"velocity rank {len(self.velocity)} != grid rank "
                f"{len(self.shape)}")
        if not self.nu > 0.0:
            raise ValueError(
                f"nu must be positive (got {self.nu}); the pure-advection "
                "steady operator is hyperbolic, outside this family")
        if self.scheme not in ("upwind", "central"):
            raise ValueError(
                f"unknown scheme {self.scheme!r} (upwind | central)")
        if self.h is None:
            object.__setattr__(self, "h", 1.0 / (self.shape[0] + 1))
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.zero(len(self.shape)))
        if self.bc.any_dynamic:
            raise ValueError(
                "steady advection-diffusion needs Dirichlet walls (the "
                "periodic/Neumann operator annihilates constants and "
                "is singular)")
        if self.scheme == "central":
            pe = self.mesh_peclet
            if pe > 1.0 + 1e-12:
                raise ValueError(
                    f"mesh Peclet number {pe:.3f} > 1: the central "
                    "advection discretization is non-monotone here "
                    "(wiggles); use scheme='upwind', refine h, or "
                    "raise nu")
        object.__setattr__(self, "_spec_cache", None)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def mesh_peclet(self) -> float:
        """``max_d |v_d| h / (2 nu)``: the monotonicity number of the
        central scheme (the upwind scheme is monotone at any value)."""
        return max(abs(v) for v in self.velocity) * self.h / (2 * self.nu)

    @property
    def operator_spec(self) -> StencilSpec:
        """The discrete operator ``A`` as taps: ``(A u)_p = sum_t w_t
        u_{p + off_t}``, built in JAX's order (center, then per dim the low
        and high faces), zero weights dropped."""
        if self._spec_cache is not None:
            return self._spec_cache
        nd = self.ndim
        h = float(self.h)
        inv_h2 = float(self.nu) / (h * h)
        taps = {(0,) * nd: 2.0 * nd * inv_h2}
        for d, v in enumerate(self.velocity):
            lo = tuple(-1 if e == d else 0 for e in range(nd))
            hi = tuple(+1 if e == d else 0 for e in range(nd))
            taps[lo] = taps.get(lo, 0.0) - inv_h2
            taps[hi] = taps.get(hi, 0.0) - inv_h2
            if v == 0.0:
                continue
            if self.scheme == "upwind":
                taps[(0,) * nd] += abs(v) / h
                up = lo if v > 0 else hi
                taps[up] -= abs(v) / h
            else:
                taps[hi] += v / (2.0 * h)
                taps[lo] -= v / (2.0 * h)
        tap_list = [(off, w) for off, w in taps.items() if w != 0.0]
        spec = weighted(nd, tap_list, name=f"advdiff{nd}d_{self.scheme}")
        object.__setattr__(self, "_spec_cache", spec)
        return spec

    @property
    def is_symmetric(self) -> bool:
        return all(v == 0.0 for v in self.velocity)

    # -- matrix-free operator protocol (the Krylov solvers and
    # OperatorMultigrid): constant taps carry no operator data

    def operator_data(self):
        return None

    def operator_apply(self, padded: torch.Tensor, data=None) -> torch.Tensor:
        """``A u`` of the halo-1 padded ``padded`` (its ghost ring is the
        walls), interior-shaped."""
        from stencil_tpu_torch.ops.eager import apply_spec

        return apply_spec(padded, self.operator_spec, halo=1)

    def operator_inv_diagonal(self, data=None) -> float:
        """1 / the center tap: the point-Jacobi smoothing scale."""
        spec = self.operator_spec
        center = (0,) * self.ndim
        if center not in spec.offsets:
            raise ValueError("operator has no center tap")
        d = float(spec.weights[spec.offsets.index(center)])
        if d == 0.0:
            raise ValueError("operator diagonal is 0")
        return 1.0 / d

    def with_discretization(self, shape,
                            h) -> "AdvectionDiffusionProblem":
        """The same continuous problem on another grid, with zero walls
        (the coarse levels of ``OperatorMultigrid`` solve correction
        equations). A central problem falls back to upwind on a level
        whose coarser h puts the mesh Peclet number above 1."""
        scheme = self.scheme
        if scheme == "central":
            pe = max(abs(v) for v in self.velocity) * float(h) \
                / (2 * self.nu)
            if pe > 1.0:
                scheme = "upwind"
        return dataclasses.replace(
            self, shape=tuple(shape), h=float(h), scheme=scheme,
            bc=DirichletBC.zero(self.ndim))

    def initial_grid(self, interior=None) -> HaloGrid:
        if interior is None:
            return HaloGrid.create(self.shape, halo=1, bc=self.bc,
                                   dtype=self.dtype, device=self.device)
        return HaloGrid.from_interior(
            torch.as_tensor(interior).to(torch_dtype(self.dtype)), halo=1,
            bc=self.bc, device=self.device)

    def apply_f64(self, interior) -> np.ndarray:
        """``A u`` in float64 with the true wall values in the ghost ring:
        the golden twin of :meth:`operator_apply`."""
        from stencil_tpu_torch.ops.golden import apply_spec_f64

        u = np.asarray(interior, np.float64)
        if u.shape != tuple(self.shape):
            raise ValueError(f"interior shape {u.shape} != {self.shape}")
        return apply_spec_f64(u, self.operator_spec, self.bc)

    def residual_f64(self, grid: HaloGrid, f) -> float:
        """``max |f - A u|`` in float64: the certificate."""
        u = grid.interior().double().cpu().numpy()
        f64 = torch.as_tensor(f).double().cpu().numpy()
        return float(np.max(np.abs(f64 - self.apply_f64(u))))

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 2000, mesh=None, dim: int = 0):
        """Solve with ``krylov.BiCGStab``; returns its ``CGResult``.
        ``mesh`` distributes the solve (``krylov.py``)."""
        from stencil_tpu_torch.krylov import BiCGStab

        return BiCGStab(self).solve(f, tolerance=tolerance,
                                    max_iterations=max_iterations,
                                    mesh=mesh, dim=dim)
