"""2D temporally blocked iterate: plan, and the user-facing handle.

Counterpart of ``stencil_tpu/ops/pallas.py`` (``SlabPlan``, ``make_plan``,
``choose_slab``, ``_cached_iterate``, ``_cached_source_iterate``,
``PallasStencil``) on 2D grids, homogeneous or with a source, with
Dirichlet, periodic or Neumann walls (JAX's gates: a dynamic d1 at k=1, a
Neumann d0 at k>1 with a spec mirror-symmetric in d0). Each launch of the
CUDA kernel (``ops/slab_kernel.py``) runs k sweeps per round trip to
device memory.

The TPU kernel streams slabs of full minor width; a CUDA block has 227 KB
(232,448 bytes) of shared memory, which a 4096-wide slab with a k*r halo
overflows, so the port tiles both dims: one block per (t0, t1) output tile
and its k*r-deep window, two window buffers when k > 1, of 4-byte points
in float32 and 2-byte ones in bfloat16. ``-b/--block``
pins t0, the rows per tile, as the JAX ``-b`` pins the rows per slab. The
TPU's sublane rule (rows and slab a multiple of 8) is TPU layout machinery
and is not carried: any row count runs.

The chooser (:func:`choose_tiles`) takes the tile of least estimated time
for the whole grid: the warp slots of one block (a fixed cost, the window
load and the k shrinking sweeps), times the blocks each SM runs, over the
latency hiding that the blocks resident on one SM buy. Counting the
blocks per SM is what keeps a small grid (512² is 64 tiles of 64² on 132
SMs) from being cut into too few tiles, and the recompute of deep windows
from being cut into too many. Its constants are fitted to a sweep of
tiles on an H100 (``stencil_tpu_torch/tile_sweep.py`` measures, scores
and refits; PERF.md, Findings).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

from stencil_tpu_torch.core.grid import dtype_name, torch_dtype
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.ops.layout import PaddedLayout
from stencil_tpu_torch.ops.slab_kernel import slab_sweep
from stencil_tpu_torch.ops.sweep_kernel import KernelStencil
from stencil_tpu_torch.ops.tiled import (
    DTYPES, MAX_BLOCKS_PER_SM, SM_COUNT, SM_SHARED, SMEM_LIMIT, TiledPlan,
    _smem_bytes,
)

_T0_CANDIDATES = (8, 16, 32, 64, 128, 256)
# the chooser's cost model in warp slots: a block's fixed cost, a window
# row segment's load, a swept row's cost beyond its tap loads; fitted to a
# sweep of 2D tiles over 15 shapes and depths on an H100
# (``stencil_tpu_torch/tile_sweep.py``, its rows in
# ``data/slab_tiles_h100_fit.csv``)
COST_CONSTANTS = (200, 0.5, 6)


@dataclasses.dataclass(frozen=True)
class SlabPlan(TiledPlan):
    """Geometry of one 2D kernel launch: ``sweeps_per_call`` sweeps of
    ``spec`` over (t0, t1) ``tiles`` of a tensor padded per ``layout``.
    The 3D plan's geometry in two dims; ``kernel_geometry()`` is the 2D
    kernel's int32[11]: n0 n1 p0 p1 halo t0 t1 nt0 nt1 k r."""


def _t1_candidates(kr: int) -> Tuple[int, ...]:
    """Powers of two, and extents whose window rows are whole warps."""
    return tuple(sorted({32, 64, 128, 256} | {32 * m - 2 * kr
                                              for m in range(1, 9)
                                              if 32 * m > 2 * kr}))


def _cost(tiles, k: int, spec: StencilSpec, interior_shape,
          constants=COST_CONSTANTS, itemsize: int = 4) -> float:
    """Estimated time of one launch over the whole grid: each SM runs
    ``ceil(blocks / SM_COUNT)`` blocks of the warp slots of one block (a
    fixed cost, then a load cost per 32-point segment of a window row, then
    sweep by sweep a row of c points takes ceil(c / 32) slots of
    ``num_taps`` plus a row cost; ``constants`` are the three costs),
    divided by the latency hiding of the blocks resident together,
    ``resident ** 0.25``; the windows hold ``itemsize``-byte points."""
    block_cost, load_cost, row_cost = constants
    r = spec.radius
    w0, w1 = (t + 2 * k * r for t in tiles)
    slots = block_cost + w0 * -(-w1 // 32) * load_cost
    for s in range(1, k + 1):
        e = s * r
        slots += (w0 - 2 * e) * -(-(w1 - 2 * e) // 32) \
            * (spec.num_taps + row_cost)
    blocks = math.prod(-(-n // t) for n, t in zip(interior_shape, tiles))
    per_sm = -(-blocks // SM_COUNT)
    resident = min(per_sm, MAX_BLOCKS_PER_SM,
                   SM_SHARED // (_smem_bytes(tiles, k, r, itemsize) + 1024))
    return per_sm * slots / max(1, resident) ** 0.25


def candidate_tiles(spec: StencilSpec, interior_shape, sweeps_per_call: int,
                    t0_fixed: Optional[int] = None,
                    itemsize: int = 4) -> list:
    """The tiles the chooser weighs, sorted: each t0 candidate (or
    ``t0_fixed``) with each t1 candidate, clamped to the grid, that fit one
    block's shared memory at ``itemsize`` bytes per point."""
    k, r = sweeps_per_call, spec.radius
    n0, n1 = interior_shape
    t0s = (t0_fixed,) if t0_fixed is not None else _T0_CANDIDATES
    tiles = {(min(t0, n0), min(t1, n1))
             for t0, t1 in itertools.product(t0s, _t1_candidates(k * r))}
    return sorted(t for t in tiles
                  if _smem_bytes(t, k, r, itemsize) <= SMEM_LIMIT)


def tile_key(tiles, k: int, spec: StencilSpec, interior_shape,
             constants=COST_CONSTANTS, itemsize: int = 4):
    """The chooser's order: least :func:`_cost`, then the wider t1, then
    the larger tile."""
    return (_cost(tiles, k, spec, interior_shape, constants, itemsize),
            -tiles[1], -math.prod(tiles))


def choose_tiles(spec: StencilSpec, interior_shape, sweeps_per_call: int,
                 t0_fixed: Optional[int] = None, dtype="float32"
                 ) -> Optional[Tuple[int, int]]:
    """The feasible tile of least estimated time (:func:`tile_key`) for
    windows of ``dtype``. None if nothing fits."""
    itemsize = torch_dtype(dtype).itemsize
    tiles = candidate_tiles(spec, interior_shape, sweeps_per_call, t0_fixed,
                            itemsize)
    if not tiles:
        return None
    return min(tiles, key=lambda t: tile_key(
        t, sweeps_per_call, spec, interior_shape, itemsize=itemsize))


def make_slab_plan(spec: StencilSpec, interior_shape, dtype="float32",
                   sweeps_per_call: int = 1, tiles=None,
                   t0_fixed: Optional[int] = None) -> SlabPlan:
    """Plan for ``sweeps_per_call`` sweeps per launch on a 2D grid;
    ``tiles`` pins (t0, t1), ``t0_fixed`` (the CLI's ``-b``) pins only
    t0."""
    if spec.ndim != 2 or len(interior_shape) != 2:
        raise ValueError("slab kernel is 2D-only in the port (3D grids run "
                         "the tiled kernel)")
    dtype = dtype_name(torch_dtype(dtype))
    if dtype not in DTYPES:
        raise ValueError(f"slab kernel dtype {dtype!r}: the kernel takes "
                         f"{' or '.join(DTYPES)}")
    if sweeps_per_call < 1:
        raise ValueError("sweeps_per_call must be >= 1")
    if t0_fixed is not None and t0_fixed < 1:
        raise ValueError(f"block (t0) {t0_fixed} must be >= 1")
    interior_shape = tuple(int(n) for n in interior_shape)
    k, r = sweeps_per_call, spec.radius
    itemsize = torch_dtype(dtype).itemsize
    if tiles is None:
        tiles = choose_tiles(spec, interior_shape, k, t0_fixed, dtype)
        if tiles is None:
            raise ValueError(
                f"no tile of {interior_shape} at k={k}"
                + (f" with t0={t0_fixed}" if t0_fixed is not None else "")
                + f" fits {SMEM_LIMIT} bytes of shared memory")
    tiles = tuple(int(t) for t in tiles)
    if len(tiles) != 2 or any(t < 1 or t > n
                              for t, n in zip(tiles, interior_shape)):
        raise ValueError(f"tiles {tiles} must lie in [1, {interior_shape}]")
    if _smem_bytes(tiles, k, r, itemsize) > SMEM_LIMIT:
        raise ValueError(
            f"tiles {tiles} at k={k}, r={r} need "
            f"{_smem_bytes(tiles, k, r, itemsize)} bytes of shared memory "
            f"> {SMEM_LIMIT}")
    return SlabPlan(spec=spec, interior_shape=interior_shape, dtype=dtype,
                    sweeps_per_call=k, tiles=tiles,
                    layout=PaddedLayout.for_halo(interior_shape, k * r))


class SlabStencil(KernelStencil):
    """User-facing handle mirroring ``PallasStencil`` on 2D grids: k
    sweeps per kernel launch over a ``HaloGrid`` on ``device``,
    with an optional static ``source`` (``u' = S(u) + source_scale *
    source``). Iterations that are not a multiple of k end in one launch
    of the remainder, on the same padded tensors."""

    kernel = slab_sweep

    def __init__(self, spec: StencilSpec, interior_shape, dtype="float32",
                 sweeps_per_call: int = 1, tiles=None,
                 t0_fixed: Optional[int] = None, device="cuda",
                 source=None, source_scale=1.0):
        super().__init__(make_slab_plan(spec, interior_shape, dtype,
                                        sweeps_per_call, tiles, t0_fixed),
                         device, source, source_scale)
