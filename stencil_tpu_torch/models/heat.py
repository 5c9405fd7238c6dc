"""Physical problem setups ("model families") built on the stencil core.

Counterpart of ``stencil_tpu/models/heat.py`` (``LaplaceRelaxation``,
``HeatDiffusion``): spec and grid setup, torch only. The reference
hardcodes one physics, Jacobi relaxation of the Laplace equation with
Dirichlet walls (steady-state heat conduction); ``HeatDiffusion``
generalises it to explicit transient heat diffusion (FTCS) with a
physical diffusivity and a stability-checked time step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
from stencil_tpu_torch.core.spec import StencilSpec, star, weighted


@dataclasses.dataclass(frozen=True)
class LaplaceRelaxation:
    """Reference semantics: Jacobi relaxation toward the harmonic function
    with hot side walls."""

    shape: Tuple[int, ...]
    radius: int = 1
    dtype: str = "float32"
    device: str = "cuda"

    @property
    def spec(self) -> StencilSpec:
        return star(len(self.shape), self.radius)

    def initial_grid(self) -> HaloGrid:
        return HaloGrid.create(self.shape, halo=self.radius,
                               dtype=self.dtype, device=self.device)


@dataclasses.dataclass(frozen=True)
class HeatDiffusion:
    """Explicit FTCS heat equation: u += alpha*dt/h^2 * laplacian(u).

    As a stencil: center weight ``1 - 2*ndim*fo``, neighbor weights ``fo``
    where ``fo = alpha*dt/h^2`` is the Fourier number. Stability requires
    ``fo <= 1/(2*ndim)``; at exactly ``1/(2*ndim)`` the center weight
    vanishes and the update is the reference's neighbor average.
    """

    shape: Tuple[int, ...]
    alpha: float = 1.0          # diffusivity
    h: float = 1.0              # grid spacing
    dt: Optional[float] = None  # None -> largest stable step
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"
    device: str = "cuda"

    @property
    def fourier(self) -> float:
        ndim = len(self.shape)
        if self.dt is None:
            return 1.0 / (2 * ndim)
        fo = self.alpha * self.dt / (self.h ** 2)
        if fo > 1.0 / (2 * ndim) + 1e-12:
            raise ValueError(
                f"unstable: fo={fo:.4f} > 1/{2 * ndim} "
                f"(reduce dt below {self.h ** 2 / (2 * ndim * self.alpha):g})"
            )
        return fo

    @property
    def spec(self) -> StencilSpec:
        ndim = len(self.shape)
        fo = self.fourier
        taps = []
        center_w = 1.0 - 2 * ndim * fo
        if abs(center_w) > 1e-12:
            taps.append(((0,) * ndim, center_w))
        for d in range(ndim):
            for sign in (-1, 1):
                off = [0] * ndim
                off[d] = sign
                taps.append((tuple(off), fo))
        return weighted(ndim, taps, name=f"heat{ndim}d")

    def initial_grid(self, interior=None) -> HaloGrid:
        if interior is None:
            return HaloGrid.create(self.shape, halo=1, bc=self.bc,
                                   dtype=self.dtype, device=self.device)
        return HaloGrid.from_interior(torch.as_tensor(interior), halo=1,
                                      bc=self.bc, device=self.device)
