"""State carried across from the JAX package.

The JAX package's state, given as numpy arrays and plain tuples, becomes the
port's: a test hands the same stencil and the same grid to both packages
and compares what they compute. Nothing here imports JAX.

  spec_from_arrays(spec.name, spec.offsets, spec.weights, spec.radius)
  grid_from_arrays(np.asarray(grid.data), grid.halo, grid.bc.values,
                   grid.bc.periodic, grid.bc.neumann, device="cpu")
  poisson_from_arrays(prob.shape, prob.h, prob.bc.values, prob.bc.periodic,
                      prob.bc.neumann, prob.dtype, device="cpu")
  diffusion_from_arrays(het.shape, het.a, het.h, het.dt, het.bc.values,
                        het.bc.periodic, het.bc.neumann, het.dtype,
                        device="cpu")
  hetero_from_arrays(prob.shape, prob.a, prob.h, prob.bc.values,
                     prob.dtype, prob.kernel, device="cpu")
  advdiff_from_arrays(prob.shape, prob.velocity, prob.nu, prob.h,
                      prob.bc.values, prob.dtype, prob.scheme, device="cpu")
  wave_from_arrays(w.shape, w.c, w.h, w.dt, w.bc.values, w.bc.periodic,
                   w.bc.neumann, w.dtype, device="cpu")

A source ``f``, a coefficient field ``a`` and a leapfrog pair's interiors
go across as the numpy arrays they are; :func:`tensor_from_array` carries
one bit for bit, a bfloat16 array (``ml_dtypes.bfloat16``, which numpy
holds for a JAX bfloat16 array) included, without importing ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, check_device
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.models.advection_diffusion import (
    AdvectionDiffusionProblem,
)
from stencil_tpu_torch.models.diffusion import (
    HeterogeneousDiffusion, HeterogeneousPoissonProblem,
)
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.models.wave import WaveEquation


def spec_from_arrays(name: str, offsets, weights,
                     radius: Optional[int] = None) -> StencilSpec:
    """A ``StencilSpec`` with exactly these taps, in this order. ``radius``
    defaults to the largest offset (at least 1)."""
    offs = tuple(tuple(int(o) for o in off) for off in np.asarray(offsets))
    ws = tuple(float(w) for w in np.asarray(weights, dtype=np.float64))
    if radius is None:
        radius = max(1, max(abs(o) for off in offs for o in off))
    return StencilSpec(ndim=len(offs[0]), radius=int(radius), offsets=offs,
                       weights=ws, name=name)


def tensor_from_array(data, device="cuda") -> torch.Tensor:
    """A copy of the array ``data`` as a tensor on ``device``, bit for bit.
    A bfloat16 array (recognised by its dtype's name and 2-byte items;
    torch cannot read numpy's bfloat16 directly) goes across as its
    uint16 bits, viewed as ``torch.bfloat16``."""
    arr = np.asarray(data)
    dev = check_device(device)
    if arr.dtype.name == "bfloat16" and arr.dtype.itemsize == 2:
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                .copy())
        return bits.view(torch.bfloat16).to(dev)
    return torch.tensor(arr, device=dev)


def grid_from_arrays(data, halo: int, bc_values,
                     periodic: Sequence[bool] = (),
                     neumann: Sequence[bool] = (),
                     device="cuda") -> HaloGrid:
    """A ``HaloGrid`` holding a copy of the padded array ``data`` (halo
    ring included, as the JAX grid holds it; float32, float64 or bfloat16)
    on ``device``."""
    bc = bc_from_arrays(bc_values, periodic, neumann)
    return HaloGrid(data=tensor_from_array(data, device), halo=int(halo),
                    bc=bc)


def bc_from_arrays(values, periodic: Sequence[bool] = (),
                   neumann: Sequence[bool] = ()) -> DirichletBC:
    """A ``DirichletBC`` with these face values and dynamic dims."""
    return DirichletBC(
        values=tuple((float(lo), float(hi)) for lo, hi in values),
        periodic=tuple(bool(p) for p in periodic),
        neumann=tuple(bool(n) for n in neumann),
    )


def poisson_from_arrays(shape, h, bc_values, periodic: Sequence[bool] = (),
                        neumann: Sequence[bool] = (), dtype="float32",
                        device="cuda") -> PoissonProblem:
    """The ``PoissonProblem`` of this shape, spacing and walls, on
    ``device``."""
    return PoissonProblem(shape=tuple(int(n) for n in shape), h=float(h),
                          bc=bc_from_arrays(bc_values, periodic, neumann),
                          dtype=str(dtype), device=str(device))


def diffusion_from_arrays(shape, a, h, dt, bc_values,
                          periodic: Sequence[bool] = (),
                          neumann: Sequence[bool] = (), dtype="float32",
                          device="cuda") -> HeterogeneousDiffusion:
    """The ``HeterogeneousDiffusion`` of this coefficient field ``a``
    (numpy), spacing, step (None: the stable limit) and walls."""
    return HeterogeneousDiffusion(
        shape=tuple(int(n) for n in shape), a=np.asarray(a), h=float(h),
        dt=None if dt is None else float(dt),
        bc=bc_from_arrays(bc_values, periodic, neumann), dtype=str(dtype),
        device=str(device))


def hetero_from_arrays(shape, a, h, bc_values, dtype="float32",
                       kernel="auto", device="cuda"
                       ) -> HeterogeneousPoissonProblem:
    """The ``HeterogeneousPoissonProblem`` of this coefficient field ``a``
    (numpy), spacing and (Dirichlet) walls; ``kernel`` as in JAX
    (``auto``, ``xla``, ``pallas``)."""
    return HeterogeneousPoissonProblem(
        shape=tuple(int(n) for n in shape), a=np.asarray(a), h=float(h),
        bc=bc_from_arrays(bc_values), dtype=str(dtype), kernel=str(kernel),
        device=str(device))


def wave_from_arrays(shape, c, h, dt, bc_values,
                     periodic: Sequence[bool] = (),
                     neumann: Sequence[bool] = (), dtype="float32",
                     device="cuda") -> WaveEquation:
    """The ``WaveEquation`` of this speed, spacing, step (None: the CFL
    limit) and walls."""
    return WaveEquation(
        shape=tuple(int(n) for n in shape), c=float(c), h=float(h),
        dt=None if dt is None else float(dt),
        bc=bc_from_arrays(bc_values, periodic, neumann), dtype=str(dtype),
        device=str(device))


def advdiff_from_arrays(shape, velocity, nu, h, bc_values, dtype="float32",
                        scheme="upwind", device="cuda"
                        ) -> AdvectionDiffusionProblem:
    """The ``AdvectionDiffusionProblem`` of this velocity, diffusivity,
    spacing, (Dirichlet) walls and scheme."""
    return AdvectionDiffusionProblem(
        shape=tuple(int(n) for n in shape),
        velocity=tuple(float(v) for v in velocity), nu=float(nu),
        h=float(h), bc=bc_from_arrays(bc_values), dtype=str(dtype),
        scheme=str(scheme), device=str(device))
