"""Wave equation model family: explicit leapfrog time stepping.

Counterpart of ``stencil_tpu/models/wave.py`` (``WaveEquation``,
``golden_wave``). ``u_tt = c^2 laplacian(u)`` is second order in time; the
standard leapfrog update reads two time levels,

    u_{n+1} = S(u_n) - u_{n-1}

where ``S`` is a radius-1 star with center: center weight
``2 - 2*ndim*s^2``, neighbour weights ``s^2``, with the Courant number
``s = c*dt/h`` (stable iff ``ndim * s^2 <= 1``).

``simulate`` runs it through one of two paths: ``eager``/``xla``, the
eager torch leapfrog (any rank, any walls), and ``tiled``/``pallas_tiled``
(3D; Dirichlet, periodic or Neumann d0 and d1), the tiled kernel's
two-level mode, k steps per launch with both levels in the kernel's padded
layout (``ops/tiled.py:wave_iterate``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, fill_halo_np, refresh_dynamic,
    refresh_dynamic_np, torch_dtype,
)
from stencil_tpu_torch.core.spec import StencilSpec, weighted
from stencil_tpu_torch.ops.golden import golden_sweep


@dataclasses.dataclass(frozen=True)
class WaveEquation:
    """``u_tt = c^2 laplacian(u)`` with fixed (Dirichlet-0, default),
    periodic, or reflecting (Neumann) walls, on ``device``.

    ``dt=None`` picks the largest stable step ``h / (c * sqrt(ndim))``
    (the CFL limit, at which the scheme is exact along grid diagonals).
    """

    shape: Tuple[int, ...]
    c: float = 1.0
    h: float = 1.0
    dt: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"
    device: str = "cuda"

    def __post_init__(self):
        if self.bc is None:
            object.__setattr__(self, "bc",
                               DirichletBC.zero(len(self.shape)))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def courant(self) -> float:
        """``s = c*dt/h``; stability requires ``ndim * s^2 <= 1``."""
        ndim = self.ndim
        if self.dt is None:
            return 1.0 / np.sqrt(ndim)
        s = self.c * self.dt / self.h
        if ndim * s * s > 1.0 + 1e-12:
            raise ValueError(
                f"unstable: ndim*s^2 = {ndim * s * s:.4f} > 1 (reduce dt "
                f"below {self.h / (self.c * np.sqrt(ndim)):g})")
        return s

    @property
    def spec(self) -> StencilSpec:
        """The one-level part ``S`` of the leapfrog update: center
        ``2 - 2*ndim*s^2``, radius-1 star neighbours ``s^2``."""
        ndim = self.ndim
        s2 = self.courant ** 2
        taps = [((0,) * ndim, 2.0 - 2 * ndim * s2)]
        for d in range(ndim):
            for sign in (-1, 1):
                off = [0] * ndim
                off[d] = sign
                taps.append((tuple(off), s2))
        return weighted(ndim, taps, name=f"wave{ndim}d")

    # -- initialization --

    def initial_pair(self, u0, v0=None) -> Tuple[HaloGrid, HaloGrid]:
        """The ``(prev, cur) = (u_0, u_1)`` pair from displacement ``u0``
        and velocity ``v0`` (default 0) at t=0, via the 2nd-order Taylor
        start ``u_1 = u_0 + dt*v0 + (1/2) * (S(u_0) - 2 u_0)`` in float64
        (the ``S - 2I`` term is ``(c*dt)^2 laplacian`` discretely), then
        cast to the problem dtype on ``device``."""
        u0 = np.asarray(u0, np.float64)
        if u0.shape != tuple(self.shape):
            raise ValueError(f"u0 shape {u0.shape} != {self.shape}")
        dt = (self.dt if self.dt is not None
              else self.courant * self.h / self.c)
        padded = fill_halo_np(np.pad(u0, 1), 1, self.bc)
        u1 = u0 + 0.5 * (golden_sweep(padded, self.spec) - 2.0 * u0)
        if v0 is not None:
            u1 = u1 + dt * np.asarray(v0, np.float64)
        dt_ = torch_dtype(self.dtype)
        prev = HaloGrid.from_interior(torch.from_numpy(u0).to(dt_), halo=1,
                                      bc=self.bc, device=self.device)
        cur = HaloGrid.from_interior(torch.from_numpy(u1).to(dt_), halo=1,
                                     bc=self.bc, device=self.device)
        return prev, cur

    # -- time stepping --

    def simulate(self, prev: HaloGrid, cur: HaloGrid, steps: int,
                 method: str = "xla", **kw) -> Tuple[HaloGrid, HaloGrid]:
        """Advance ``steps`` leapfrog steps; returns the new
        ``(prev, cur)`` pair (``cur`` is ``u_{n+steps}``).

        ``method``: ``xla``/``eager``, the eager torch leapfrog (any rank
        and walls); ``pallas_tiled``/``tiled`` (3D, a Dirichlet, periodic
        or Neumann d0 and d1, a Dirichlet d2), the tiled kernel's
        two-level mode, ``sweeps_per_call`` steps per launch (``kw``:
        ``sweeps_per_call``, ``tiles``, ``t0_fixed``; the JAX package's
        ``interpret`` is accepted and ignored)."""
        if method in ("xla", "eager"):
            return _simulate_eager(prev, cur, self.spec, int(steps))
        if method in ("pallas_tiled", "tiled"):
            return self._simulate_tiled(prev, cur, steps, **kw)
        raise ValueError(f"unknown wave method {method!r} "
                         "(xla | eager | pallas_tiled | tiled)")

    def _simulate_tiled(self, prev: HaloGrid, cur: HaloGrid, steps: int,
                        sweeps_per_call: int = 8, interpret=None,
                        **plan_kw) -> Tuple[HaloGrid, HaloGrid]:
        from stencil_tpu_torch.ops.tiled import make_tiled_plan, wave_iterate

        if self.ndim != 3:
            raise ValueError("the two-level tiled kernel is 3D-only; "
                             "use method='xla' for 2D waves")
        bc = cur.bc
        if bc.dynamic_mask(3)[2]:
            raise ValueError(
                "a periodic/Neumann lane (last) dim is unsupported on "
                "the two-level tiled kernel (use method='xla')")
        k = int(sweeps_per_call)
        n_outer, rem = divmod(int(steps), k)
        plan = make_tiled_plan(self.spec, self.shape, self.dtype, k,
                               two_level=True, **plan_kw)
        c_d, p_d = wave_iterate(plan, cur.data, prev.data, bc, n_outer,
                                grid_halo=cur.halo, rem=rem)
        return (HaloGrid(data=p_d, halo=cur.halo, bc=bc),
                HaloGrid(data=c_d, halo=cur.halo, bc=bc))

    def simulate_interior(self, u0, steps: int, v0=None,
                          method: str = "xla", **kw) -> np.ndarray:
        """Convenience: from initial conditions to the interior after
        ``steps`` steps (counting u_1 as step 1), as a numpy array."""
        prev, cur = self.initial_pair(u0, v0)
        if steps <= 1:
            out = prev if steps == 0 else cur
        else:
            _, out = self.simulate(prev, cur, steps - 1, method=method, **kw)
        return out.interior().cpu().numpy()


def _simulate_eager(prev: HaloGrid, cur: HaloGrid, spec: StencilSpec,
                    steps: int) -> Tuple[HaloGrid, HaloGrid]:
    """The eager leapfrog: each step's new level is written over the
    interior of the oldest one (the taps as ``apply_spec`` sums them, then
    one subtraction), dynamic ghosts refreshed after every step."""
    from stencil_tpu_torch.ops.eager import apply_spec

    h = cur.halo
    p = prev.data.clone()
    c = cur.data.clone()
    idx = tuple(slice(h, s - h) for s in c.shape)
    for _ in range(steps):
        new = apply_spec(c, spec, halo=h)
        p[idx] = new.sub_(p[idx])
        if cur.bc.any_dynamic:
            refresh_dynamic(p, h, cur.bc)
        p, c = c, p
    return (HaloGrid(data=p, halo=h, bc=cur.bc),
            HaloGrid(data=c, halo=h, bc=cur.bc))


def golden_wave(u0: np.ndarray, spec: StencilSpec, steps: int,
                bc: DirichletBC, v0=None, dt: float = 1.0) -> np.ndarray:
    """Independent float64 two-level reference loop (the differential twin
    of ``WaveEquation.simulate``). Returns the interior after ``steps``
    steps."""
    u0 = np.asarray(u0, np.float64)
    padded = fill_halo_np(np.pad(u0, 1), 1, bc)
    idx = tuple(slice(1, s - 1) for s in padded.shape)
    u1 = u0 + 0.5 * (golden_sweep(padded, spec) - 2.0 * u0)
    if v0 is not None:
        u1 = u1 + dt * np.asarray(v0, np.float64)
    if steps == 0:
        return u0
    prev = padded
    cur = fill_halo_np(np.pad(u1, 1), 1, bc)
    for _ in range(steps - 1):
        new = golden_sweep(cur, spec) - prev[idx]
        prev, cur = cur, prev
        cur[idx] = new
        if bc.any_dynamic:
            refresh_dynamic_np(cur, 1, bc)
    return cur[idx]
