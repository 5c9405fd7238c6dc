"""The frozen count: the bytes and operations one stencil launch needs, and
its least time on one NVIDIA H100 SXM at the published peaks.

Copied from ``chip_smoke.py`` (``needed_cells``, ``point_cells``, ``bound``,
``bound_of`` and its peaks, written for the port's kernel table) and frozen
here, so that a change to the program cannot change the yardstick. It takes
plain numbers (shape, radius, sweeps, mode), never a plan of the program.

Each launch reads its input once where the function needs it: the interior
widened by the radius at a pinned (Dirichlet) face, by the launch's ghosts
(k*r) at a live one. A source (the Chebyshev modes' raw f, the source
mode's scaled f) is read at the points it is added to. Each output's
interior is written once. Operations: every sweep's update of every
interior point, the spec's taps (adds and multiplies) plus one add for a
source; in the Chebyshev modes 3 multiplies and 2 adds per update, and
from sweep 2 on one more of each (the older level's term).
"""

from __future__ import annotations

import dataclasses
from math import prod
from typing import Optional, Sequence

# NVIDIA's data sheet for the H100 SXM: device memory bandwidth, fp32
# outside the tensor cores, and the table's rate for bf16 operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12

ITEMSIZE = {"float32": 4, "bfloat16": 2}
MODES = ("homogeneous", "source", "cheby", "dual")


def needed_cells(shape: Sequence[int], radius: int, halo: int,
                 pins: Optional[Sequence[int]] = None,
                 pinned: Optional[int] = None,
                 live: Optional[int] = None) -> int:
    """The cells of one padded operand that a launch needs: the interior
    widened on each face by ``pinned`` cells where the face is pinned and
    by ``live`` where it is live (``pins``, one per face of every dim but
    the last, default all pinned; the last dim's faces always pinned). The
    defaults are the input's: the radius at a pinned face, the launch's
    ghosts ``halo`` (k*r) at a live one."""
    pinned = radius if pinned is None else pinned
    live = halo if live is None else live
    nd = len(shape)
    pins = (1,) * (2 * (nd - 1)) if pins is None else tuple(pins)
    cells = 1
    for d, n in enumerate(shape):
        ends = (pins[2 * d], pins[2 * d + 1]) if d < nd - 1 else (1, 1)
        cells *= n + sum(pinned if p else live for p in ends)
    return cells


def point_cells(shape: Sequence[int], radius: int, halo: int,
                pins: Optional[Sequence[int]] = None) -> int:
    """The cells of an operand read only at the points a launch updates:
    the interior, and at a live face the ghosts its first sweep updates,
    (k-1)*r."""
    return needed_cells(shape, radius, halo, pins, 0, halo - radius)


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of the 3D stencil kernel: ``mode`` one of ``MODES``
    ("cheby" the Chebyshev smoother, "dual" the fused smooth+residual with
    its second output), ``sweeps`` k, ``flops_per_point`` the spec's taps
    (a uniform weight: taps - 1 adds and 1 multiply)."""

    shape: tuple
    radius: int
    sweeps: int
    flops_per_point: int
    mode: str = "homogeneous"
    dtype: str = "float32"
    pins: Optional[tuple] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}: one of {MODES}")
        if self.dtype not in ITEMSIZE:
            raise ValueError(f"dtype {self.dtype!r}: one of "
                             f"{sorted(ITEMSIZE)}")

    @property
    def nbytes(self) -> int:
        halo = self.radius * self.sweeps
        n_int = prod(self.shape)
        src = self.mode != "homogeneous"
        cells = (needed_cells(self.shape, self.radius, halo, self.pins)
                 + n_int
                 + (point_cells(self.shape, self.radius, halo, self.pins)
                    if src else 0)
                 + (n_int if self.mode == "dual" else 0))
        return ITEMSIZE[self.dtype] * cells

    @property
    def ops(self) -> int:
        n_int = prod(self.shape)
        per_point = self.flops_per_point
        if self.mode in ("cheby", "dual"):
            return n_int * sum(per_point + 5 + (2 if t >= 2 else 0)
                               for t in range(1, self.sweeps + 1))
        return n_int * self.sweeps * (
            per_point + (1 if self.mode == "source" else 0))

    @property
    def bound_s(self) -> float:
        return bound_of(self.nbytes, self.ops, self.dtype)[0]


def bound_of(nbytes: float, ops: float, dtype: str = "float32"):
    """(least seconds, "bytes" or "operations") of moving ``nbytes`` and
    doing ``ops`` operations on ``dtype`` values at the card's peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / (PEAK_BF16_PER_S if dtype == "bfloat16"
                   else PEAK_FP32_PER_S)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def share_percent(work, kernel_s: float):
    """100 x the least time of the launches in ``work`` (entries with
    ``count`` and ``bound_s``) / ``kernel_s``, the time the trace gives
    them; None where there is nothing to divide."""
    if not work or kernel_s <= 0:
        return None
    least = sum(w["count"] * w["bound_s"] for w in work)
    return 100.0 * least / kernel_s if least > 0 else None
