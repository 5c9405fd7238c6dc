"""Deep-halo padded layout for the sweep kernels, and their padded source.

Counterpart of ``stencil_tpu/ops/layout.py`` (``PaddedLayout``) and of
``stencil_tpu/ops/pallas_tiled.py:pad_source``. The padded
tensor carries ``halo = k * r`` ghost layers on every side of every dim, so
one kernel launch can run k sweeps without a refresh. Every pad cell holds
the BC face value of its nearest face, later dims winning in corners (the
``core.grid.fill_halo`` rule). The TPU layout's 128-lane and sublane
rounding is dropped: a CUDA block addresses any offset.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid


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


def pad_source(plan, source, source_scale, bc: DirichletBC) -> torch.Tensor:
    """The padded source operand of a sweep kernel's plan (3D tiled or 2D
    slab): interior ``float32(source) * float32(source_scale)``, scaled in
    the plan dtype as the JAX ``pad_source`` scales it; ghosts 0 (the
    kernels add no source to a ghost). On the device of ``source`` when it
    is a tensor, else on the CPU; the caller moves it.

    Dynamic (periodic/Neumann) walls would need the wrapped or mirrored
    source in the ghosts; the kernels refuse dynamic walls, so this does
    too."""
    if bc.any_dynamic:
        raise NotImplementedError(
            "a source with periodic/Neumann walls on the sweep kernels is "
            "not ported yet (needs the kernels' pins); use the eager "
            "method")
    scaled = torch.as_tensor(source).to(torch.float32)
    if tuple(scaled.shape) != plan.interior_shape:
        raise ValueError(f"source shape {tuple(scaled.shape)} != interior "
                         f"{plan.interior_shape}")
    scaled = scaled * float(np.float32(source_scale))
    return plan.layout.pad(scaled, DirichletBC.zero(len(plan.interior_shape)))
