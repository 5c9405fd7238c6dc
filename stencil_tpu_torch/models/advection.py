"""Linear advection model family: ``du/dt + v . grad(u) = 0``.

Counterpart of ``stencil_tpu/models/advection.py`` (``Advection``). Its
taps are one-sided (asymmetric), the one structural class the other
families lack: a Neumann face at temporal depth k>1 refuses them (the
kernels' mirror-symmetry gate, ``StencilSpec.symmetric_in``), while a
periodic wrap or a Dirichlet face takes them at any depth.

Two dimensionally split explicit schemes over a constant velocity ``v``,
with ``c_d = v_d dt / h`` the per-dim CFL number:

- ``upwind`` (donor cell, 1st order): per dim, the tap one cell on the
  upstream side with weight ``|c_d|``, center ``1 - sum |c_d|``; convex for
  ``sum |c_d| <= 1`` and exact for integer ``c_d``;
- ``lax_wendroff`` (2nd order per dim): taps ``c_d/2 + c_d^2/2``
  (upstream) and ``-c_d/2 + c_d^2/2`` (downstream), center ``1 - sum
  c_d^2``.

Both are plain ``StencilSpec``s, so every method runs them (the eager
sweep, both kernels) and the float64 golden checks them like any spec.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, torch_dtype
from stencil_tpu_torch.core.spec import StencilSpec, weighted


@dataclasses.dataclass(frozen=True)
class Advection:
    """Constant-velocity linear transport on a periodic (default) box, on
    ``device``.

    ``velocity`` has one component per dim; ``dt=None`` picks the largest
    stable step (CFL sum = 1 for upwind, max |c_d| = 1 for Lax-Wendroff,
    scaled by ``cfl_safety``).
    """

    shape: Tuple[int, ...]
    velocity: Tuple[float, ...]
    h: float = 1.0
    dt: Optional[float] = None
    scheme: str = "upwind"
    cfl_safety: float = 1.0
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"
    device: str = "cuda"

    def __post_init__(self):
        if len(self.velocity) != len(self.shape):
            raise ValueError(
                f"velocity rank {len(self.velocity)} != grid rank "
                f"{len(self.shape)}")
        if self.scheme not in ("upwind", "lax_wendroff"):
            raise ValueError(
                f"unknown scheme {self.scheme!r} (upwind | lax_wendroff)")
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.periodic_all(len(self.shape)))
        if self.dt is None:
            vsum = sum(abs(v) for v in self.velocity)
            vmax = max(abs(v) for v in self.velocity)
            if self.scheme == "upwind":
                base = self.h / vsum if vsum else 1.0
            else:
                base = self.h / vmax if vmax else 1.0
            object.__setattr__(self, "dt", self.cfl_safety * base)
        self.courant  # validate stability at construction

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def courant(self) -> Tuple[float, ...]:
        """Per-dim CFL numbers ``c_d = v_d dt / h``; raises if unstable."""
        c = tuple(v * self.dt / self.h for v in self.velocity)
        if self.scheme == "upwind":
            if sum(abs(x) for x in c) > 1.0 + 1e-12:
                raise ValueError(
                    f"unstable upwind step: sum |c_d| = "
                    f"{sum(abs(x) for x in c):.4f} > 1 (reduce dt)")
        else:
            if max(abs(x) for x in c) > 1.0 + 1e-12:
                raise ValueError(
                    f"unstable Lax-Wendroff step: max |c_d| = "
                    f"{max(abs(x) for x in c):.4f} > 1 (reduce dt)")
        return c

    @property
    def spec(self) -> StencilSpec:
        c = self.courant
        taps = []
        center = 1.0
        for d, cd in enumerate(c):
            if cd == 0.0:
                continue
            lo = [0] * self.ndim
            hi = [0] * self.ndim
            lo[d], hi[d] = -1, 1
            if self.scheme == "upwind":
                center -= abs(cd)
                up = tuple(lo) if cd > 0 else tuple(hi)
                taps.append((up, abs(cd)))
            else:
                center -= cd * cd
                taps.append((tuple(lo), 0.5 * cd + 0.5 * cd * cd))
                taps.append((tuple(hi), -0.5 * cd + 0.5 * cd * cd))
        taps = [(off, w) for off, w in taps if w != 0.0]
        if center != 0.0 or not taps:  # integer-CFL upwind drops the center
            taps = [((0,) * self.ndim, center)] + taps
        return weighted(self.ndim, taps,
                        name=f"advect_{self.scheme}{self.ndim}d")

    def initial_grid(self, interior) -> HaloGrid:
        """``interior`` cast to the problem dtype in a halo-1 grid with the
        problem's walls, on ``device``."""
        return HaloGrid.from_interior(
            torch.as_tensor(interior).to(torch_dtype(self.dtype)), halo=1,
            bc=self.bc, device=self.device)

    def exact_translate(self, interior0: np.ndarray,
                        steps: int) -> np.ndarray:
        """Exact solution on a fully periodic box: the initial field
        translated by ``v * steps * dt`` (a cell roll, valid when the total
        displacement per dim is a whole number of cells)."""
        out = np.asarray(interior0)
        for d, v in enumerate(self.velocity):
            disp = v * steps * self.dt / self.h
            r = int(round(disp))
            if abs(disp - r) > 1e-9:
                raise ValueError(
                    f"displacement {disp} along dim {d} is not a whole "
                    "number of cells; exact_translate does not apply")
            out = np.roll(out, r, axis=d)
        return out
