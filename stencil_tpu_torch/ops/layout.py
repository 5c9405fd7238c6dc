"""Deep-halo padded layout for the sweep kernels, its dynamic-wall refresh,
and their padded source.

Counterpart of ``stencil_tpu/ops/layout.py`` (``PaddedLayout``,
``refresh_dynamic_layout``) and of ``stencil_tpu/ops/pallas_tiled.py:
pad_source``. The padded tensor carries ``halo = k * r`` ghost layers on
every side of every dim, so one kernel launch can run k sweeps without a
refresh. Every pad cell holds the BC face value of its nearest face, later
dims winning in corners (the ``core.grid.fill_halo`` rule); the ghosts of a
periodic or Neumann dim are then refilled from the interior by
:func:`refresh_dynamic_layout` before every launch. The TPU layout's
128-lane and sublane rounding is dropped: a CUDA block addresses any
offset.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, torch_dtype
from stencil_tpu_torch.ops.eager import round_to


@dataclasses.dataclass(frozen=True)
class PaddedLayout:
    """Static geometry of a padded tensor: ``halo`` pad cells per side."""

    interior_shape: Tuple[int, ...]
    halo: int

    @staticmethod
    def for_halo(interior_shape: Tuple[int, ...], halo: int) -> "PaddedLayout":
        return PaddedLayout(interior_shape=tuple(interior_shape), halo=halo)

    @property
    def ndim(self) -> int:
        return len(self.interior_shape)

    @property
    def padded_shape(self) -> Tuple[int, ...]:
        return tuple(s + 2 * self.halo for s in self.interior_shape)

    @property
    def interior_index(self):
        return tuple(slice(self.halo, self.halo + s)
                     for s in self.interior_shape)

    def pad(self, interior: torch.Tensor, bc: DirichletBC) -> torch.Tensor:
        """A new padded tensor on ``interior``'s device: the interior copied
        in, every pad cell set to its BC face value (increasing-dim fill
        order, so later dims win in corners)."""
        if tuple(interior.shape) != self.interior_shape:
            raise ValueError(f"interior shape {tuple(interior.shape)} != "
                             f"layout {self.interior_shape}")
        padded = torch.empty(self.padded_shape, dtype=interior.dtype,
                             device=interior.device)
        h = self.halo
        for d in range(self.ndim):
            lo_v, hi_v = bc.values[d]
            n = padded.shape[d]
            padded[tuple(slice(0, h) if i == d else slice(None)
                         for i in range(self.ndim))] = lo_v
            padded[tuple(slice(n - h, None) if i == d else slice(None)
                         for i in range(self.ndim))] = hi_v
        padded[self.interior_index] = interior
        return padded

    def unpad(self, padded: torch.Tensor) -> torch.Tensor:
        """A view of the interior."""
        return padded[self.interior_index]

    def pad_grid(self, grid: HaloGrid) -> torch.Tensor:
        return self.pad(grid.interior(), grid.bc)


def refresh_dynamic_layout(padded: torch.Tensor, layout: PaddedLayout,
                           bc: DirichletBC, radius: int) -> torch.Tensor:
    """Refill rings ``1..radius`` of the dynamic dims of a ``layout``
    tensor in place and return it: wrap-around copies for periodic dims,
    mirror copies (ghost ring j holds interior layer j-1) for Neumann dims.
    Pass ``radius = k*r`` to seed the full ghost depth of a launch of k
    sweeps.

    Dims go in increasing order over the full extent of the other dims, so
    corner ghosts become the doubly wrapped or mirrored values and the face
    values of Dirichlet dims are carried through: the corner rule of
    ``core.grid.refresh_dynamic`` and of both golden models. A periodic dim
    costs two slice copies; a Neumann dim two ``torch.flip`` calls (each
    allocates a ``radius``-deep band from the caching allocator) and two
    copies.

    Counterpart of ``stencil_tpu/ops/layout.py:refresh_dynamic_layout``,
    which returns a new array where this one writes in place."""
    if not bc.any_dynamic:  # the runners call this before every launch
        return padded
    ndim = layout.ndim
    per = bc.periodic_mask(ndim)
    neu = bc.neumann_mask(ndim)
    lo = layout.halo
    for d in range(ndim):
        if not (per[d] or neu[d]):
            continue
        kind = "periodic" if per[d] else "Neumann"
        n = layout.interior_shape[d]
        if n < radius:
            raise ValueError(
                f"{kind} dim {d} needs interior extent >= radius "
                f"({n} < {radius})"
            )

        def at(sl, _d=d):
            return tuple(sl if i == _d else slice(None) for i in range(ndim))

        ghost_lo = at(slice(lo - radius, lo))
        ghost_hi = at(slice(lo + n, lo + n + radius))
        if per[d]:
            padded[ghost_lo] = padded[at(slice(lo + n - radius, lo + n))]
            padded[ghost_hi] = padded[at(slice(lo, lo + radius))]
        else:
            padded[ghost_lo] = torch.flip(
                padded[at(slice(lo, lo + radius))], dims=(d,))
            padded[ghost_hi] = torch.flip(
                padded[at(slice(lo + n - radius, lo + n))], dims=(d,))
    return padded


def pad_source(plan, source, source_scale, bc: DirichletBC) -> torch.Tensor:
    """The padded source operand of a sweep kernel's plan (3D tiled or 2D
    slab): interior ``dtype(source) * dtype(source_scale)`` in the plan
    dtype, scaled there as the JAX ``pad_source`` scales it (the scale
    rounded once, :func:`~stencil_tpu_torch.ops.eager.round_to`, the
    product rounded to the dtype); Dirichlet ghosts 0
    (the kernels add no source to a pinned ghost); the ghosts of a periodic
    or Neumann dim hold the wrapped or mirrored source to the layout's full
    depth, once, since the source does not change (a live ghost update adds
    the source of the interior point it stands for). On the device of
    ``source`` when it is a tensor, else on the CPU; the caller moves it."""
    scaled = torch.as_tensor(source).to(torch_dtype(plan.dtype))
    if tuple(scaled.shape) != plan.interior_shape:
        raise ValueError(f"source shape {tuple(scaled.shape)} != interior "
                         f"{plan.interior_shape}")
    scaled = scaled * round_to(source_scale, plan.dtype)
    ndim = len(plan.interior_shape)
    src_bc = DirichletBC(values=((0.0, 0.0),) * ndim, periodic=bc.periodic,
                         neumann=bc.neumann)
    padded = plan.layout.pad(scaled, src_bc)
    if src_bc.any_dynamic:
        refresh_dynamic_layout(padded, plan.layout, src_bc,
                               plan.layout.halo)
    return padded
