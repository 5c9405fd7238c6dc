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

The plan picks one of two schedules of the kernel (``SlabPlan.schedule``),
as the 3D plan does (``ops/tiled.py``):

- ``"march"`` (``csrc/slab_march.cu``): a block owns a strip of t1
  columns and a chunk of t0 rows, and marches d0 through one ring of
  2r+1+3 rows per sweep level (:func:`slab_march_smem_bytes`), 256
  threads, one barrier per step; its tiles come from
  :func:`choose_slab_march_tiles`, whose cost model estimates the launch's
  milliseconds (``SLAB_MARCH_COST_CONSTANTS``, fitted to a 2D march tile
  sweep on an H100, ``data/slab_march_tiles_h100_fit.csv``).
- ``"window"`` (``csrc/slab_sweep.cu``): the windows above.

The rule (``schedule=None``, :func:`march_wins`): a float32 plan of any
mode (homogeneous, source, pins) takes the march where its rings fit
(:func:`slab_march_fits`) and the march's estimate is below the chosen
window tile's
(:func:`window_ms`: the window's cost scaled to milliseconds, or a
launch's floor, ``WINDOW_MS_CONSTANTS``, fitted to the window launches
timed in the same sweep), and the window otherwise. Measured on an H100
(NVIDIA H100 80GB HBM3, 700 W; PERF.md, Findings, the 2D march): cfg2
(jacobi9 4096² k=4, ``-b 256``) takes the march, 0.30 ms a launch
against 0.35, and so do the 63² Poisson solve, k <= 4 at 512² and the
ragged star2d_r2 at k=3; cfg1 (jacobi5 512² k=16) keeps the window, 0.048
against 0.063 ms, its chunks' 80 barrier-separated steps longer than the
window's 16 sweeps; the 4096² source mode keeps it, 0.46 against 0.60
(four taps, and a source load per level per point). A bfloat16 plan
keeps the window wherever a window tile fits: the cost model knows the
item size only through the rings' shared memory, and the march is
1.44-1.49x the window at cfg1 and 4096² in bf16, 1.22x on the 63² solve,
and ahead only at cfg2, by 4% (0.407 against 0.424 ms), a near-tie. On
cases the fit never saw (``data/slab_march_tiles_h100_held_out.csv``)
the rule takes the faster schedule wherever the two differ by more than
10%; the 63² source mode marches at (8, 63), 0.048 ms against the
window's 0.044, while the march's best tile there, (16, 32), takes 0.032.
``-b``
(``t0_fixed``) pins the march's chunk as it pins the window's rows per
tile; ``tiles`` pins a window tile (ask for ``schedule="march"`` to pin
a march tile); ``schedule="window"`` or ``"march"`` asks for one
(``ValueError`` where it does not fit).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

from stencil_tpu_torch import device_model
from stencil_tpu_torch.core.grid import dtype_name, torch_dtype
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.ops.layout import PaddedLayout
from stencil_tpu_torch.ops.slab_kernel import slab_sweep
from stencil_tpu_torch.ops.sweep_kernel import KernelStencil
from stencil_tpu_torch.ops.tiled import (  # noqa: F401 (re-export)
    DTYPES, SCHEDULES, SMEM_LIMIT, WINDOW_THREADS, TiledPlan, _smem_bytes,
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
    ``spec`` over (t0, t1) ``tiles`` of a tensor padded per ``layout``,
    on the ``schedule`` "window" or "march" (tiles = (d0 chunk, t1)).
    The 3D plan's geometry in two dims; ``kernel_geometry()`` is the 2D
    kernels' int32[11]: n0 n1 p0 p1 halo t0 t1 nt0 nt1 k r."""

    @property
    def smem_bytes(self) -> int:
        """Shared memory of one block: the march's rings
        (:func:`slab_march_smem_bytes`, without the source mode's ring) or
        the window's one or two windows."""
        k, r = self.sweeps_per_call, self.spec.radius
        if self.schedule == "march":
            return slab_march_smem_bytes(self.tiles, k, r, self.itemsize,
                                         self.interior_shape[1])
        return _smem_bytes(self.tiles, k, r, self.itemsize)


def _t1_candidates(kr: int) -> Tuple[int, ...]:
    """Powers of two, and extents whose window rows are whole warps."""
    return tuple(sorted({32, 64, 128, 256} | {32 * m - 2 * kr
                                              for m in range(1, 9)
                                              if 32 * m > 2 * kr}))


def _cost(tiles, k: int, spec: StencilSpec, interior_shape,
          constants=COST_CONSTANTS, itemsize: int = 4,
          budgets: Optional[device_model.Budgets] = None) -> float:
    """Estimated time of one launch over the whole grid: each SM (of
    ``budgets``, by default the card's) runs ``ceil(blocks / SMs)``
    blocks of the warp slots of one block (a
    fixed cost, then a load cost per 32-point segment of a window row, then
    sweep by sweep a row of c points takes ceil(c / 32) slots of
    ``num_taps`` plus a row cost; ``constants`` are the three costs),
    divided by the latency hiding of the blocks resident together,
    ``resident ** 0.25``; the windows hold ``itemsize``-byte points."""
    block_cost, load_cost, row_cost = constants
    b = budgets or device_model.budgets()
    r = spec.radius
    w0, w1 = (t + 2 * k * r for t in tiles)
    slots = block_cost + w0 * -(-w1 // 32) * load_cost
    for s in range(1, k + 1):
        e = s * r
        slots += (w0 - 2 * e) * -(-(w1 - 2 * e) // 32) \
            * (spec.num_taps + row_cost)
    blocks = math.prod(-(-n // t) for n, t in zip(interior_shape, tiles))
    per_sm = -(-blocks // b.sm_count)
    resident = min(per_sm, b.threads_per_sm // WINDOW_THREADS,
                   b.smem_per_sm // (_smem_bytes(tiles, k, r, itemsize)
                                     + b.smem_reserved))
    return per_sm * slots / max(1, resident) ** 0.25


def candidate_tiles(spec: StencilSpec, interior_shape, sweeps_per_call: int,
                    t0_fixed: Optional[int] = None,
                    itemsize: int = 4) -> list:
    """The tiles the chooser weighs, sorted: each t0 candidate (or
    ``t0_fixed``) with each t1 candidate, clamped to the grid, that fit one
    block's shared memory (the card's) at ``itemsize`` bytes per point."""
    k, r = sweeps_per_call, spec.radius
    limit = device_model.budgets().smem_per_block
    n0, n1 = interior_shape
    t0s = (t0_fixed,) if t0_fixed is not None else _T0_CANDIDATES
    tiles = {(min(t0, n0), min(t1, n1))
             for t0, t1 in itertools.product(t0s, _t1_candidates(k * r))}
    return sorted(t for t in tiles
                  if _smem_bytes(t, k, r, itemsize) <= limit)


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


SLAB_MARCH_AHEAD = 3      # input rows in flight: rings of 2r+1+3 rows
SLAB_MARCH_MAX_THREADS = 1024  # one thread per column of the input row
SLAB_MARCH_GROUP_THREADS = 256  # a block's threads, as groups allow
SLAB_MARCH_MAX_SWEEPS = 32  # sweep levels the march kernel takes
SLAB_MARCH_SLACK = 64     # points before and after the rings
SLAB_MARCH_T0 = (8, 16, 32, 64, 128, 256, 512)
# strips whose input rows, t1 + 2kr, are 1 .. 8 whole warps (and 16 and
# 32 columns at any depth)
SLAB_MARCH_WARPS = (1, 2, 3, 4, 6, 8)
# the march's cost model (:func:`_slab_march_cost`): a point's cost beyond
# its tap loads (in tap loads), ns per step of a block, ns per tap load on
# a thread's chain of levels in a step, ns per warp slot of an SM, and a
# launch's fixed ms; fitted to a 2D march tile sweep on an H100
# (``tile_sweep.py --dims 2 --march``, ``data/slab_march_tiles_h100_fit.csv``)
SLAB_MARCH_COST_CONSTANTS = (32, 300, 2, 0.3, 0.02)
# the window's cost (:func:`_cost`) in ms, and a launch's floor in ms,
# fitted to the window launches of the same sweep
WINDOW_MS_CONSTANTS = (1.3e-6, 0.041)


def slab_march_columns(tiles, k: int, r: int) -> int:
    """Threads of one group of a march block: one per column of its input
    row, t1 + 2kr, rounded up to whole warps."""
    return -(-(tiles[1] + 2 * k * r) // 32) * 32


def slab_march_threads(tiles, k: int, r: int) -> int:
    """Threads of a march block: G groups of :func:`slab_march_columns`,
    each computing every G-th level, G the most that keep the block within
    256 threads and give each group 4 levels (at least 1)."""
    cols = slab_march_columns(tiles, k, r)
    return cols * max(1, min(k // 4, SLAB_MARCH_GROUP_THREADS // cols))


def slab_march_slot(tiles, k: int, r: int, itemsize: int = 4,
                    n1: Optional[int] = None) -> int:
    """The points of one slot of the march's rings (``csrc/slab_march.cu``):
    one row of each level s = 0 .. k-1, each a group's threads + 4
    wide (level 0's holds the input row and, in bfloat16, its word
    copies' spill); in bfloat16 one point more where the slot would
    differ in parity from the padded row, n1 + 2kr (``n1`` None: the
    larger)."""
    q = k * (slab_march_columns(tiles, k, r) + 4)
    if itemsize == 2 and (n1 is None or (q - n1) % 2):
        q += 1
    return q


def slab_march_smem_bytes(tiles, k: int, r: int, itemsize: int = 4,
                          n1: Optional[int] = None,
                          source: bool = False) -> int:
    """Shared memory of a march block: 2r+1+3 slots
    (:func:`slab_march_slot`), 64 points before and after them that the
    taps of the edge columns read, and with a ``source`` its ring of
    k(r+1)+3 rows, each a group's threads + 2 wide."""
    q = slab_march_slot(tiles, k, r, itemsize, n1)
    points = (2 * r + 1 + SLAB_MARCH_AHEAD) * q + 2 * SLAB_MARCH_SLACK
    if source:
        points += (k * (r + 1) + SLAB_MARCH_AHEAD) \
            * (slab_march_columns(tiles, k, r) + 2)
    return points * itemsize


def slab_march_fits(tiles, k: int, r: int, itemsize: int = 4,
                    n1: Optional[int] = None) -> bool:
    """Whether the march kernel takes these tiles, with or without a
    source: k <= 32, radius <= 64, an input row of at most 1024 points (one
    thread each), its rings within one block's shared memory (the
    card's)."""
    return k <= SLAB_MARCH_MAX_SWEEPS and r <= 64 \
        and tiles[1] + 2 * k * r <= SLAB_MARCH_MAX_THREADS \
        and slab_march_smem_bytes(tiles, k, r, itemsize, n1, source=True) \
        <= device_model.budgets().smem_per_block


def _slab_march_cost(tiles, interior_shape, k: int, spec: StencilSpec,
                     itemsize: int = 4,
                     constants=SLAB_MARCH_COST_CONSTANTS) -> float:
    """Estimated ms of one march launch over the whole grid: the launch's
    fixed ms, then the larger of its latency (each wave of the blocks
    resident together on an SM runs t0 + k(2r+1) steps, each a barrier and
    one thread's chain of ceil(k/G) levels of ``num_taps`` + the point
    cost) and its issue (per SM, every step of its blocks computes k
    levels of a row of threads, ``num_taps`` + the point cost slots per
    warp); ``constants`` are the point cost, ns per step, ns per chain
    slot, ns per warp slot and the launch's ms."""
    point_cost, step_ns, chain_ns, slot_ns, launch = constants
    b = device_model.budgets()
    r = spec.radius
    t0, _ = tiles
    cols = slab_march_columns(tiles, k, r)
    threads = slab_march_threads(tiles, k, r)
    chain = -(-k // (threads // cols))
    steps = t0 + k * (2 * r + 1)
    blocks = math.prod(-(-n // t) for n, t in zip(interior_shape, tiles))
    per_sm = -(-blocks // b.sm_count)
    resident = min(per_sm, 32, b.threads_per_sm // threads,
                   b.smem_per_sm // (slab_march_smem_bytes(tiles, k, r,
                                                           itemsize)
                                     + b.smem_reserved))
    waves = -(-per_sm // max(1, resident))
    cost = spec.num_taps + point_cost
    latency = waves * steps * (step_ns + chain * cost * chain_ns)
    issue = per_sm * steps * k * cols / 32 * cost * slot_ns
    return launch + 1e-6 * max(latency, issue)


def window_ms(tiles, k: int, spec: StencilSpec, interior_shape,
              itemsize: int = 4, window=WINDOW_MS_CONSTANTS) -> float:
    """The window's estimated ms for one launch at ``tiles``: its cost
    (:func:`_cost`) times ``window[0]``, or the launch's floor
    ``window[1]`` where that is more."""
    per_unit, floor = window
    return max(floor, per_unit * _cost(tiles, k, spec, interior_shape,
                                       itemsize=itemsize))


def march_candidates(spec: StencilSpec, interior_shape, sweeps_per_call: int,
                     t0_fixed: Optional[int] = None,
                     itemsize: int = 4) -> list:
    """The march tiles the chooser weighs, sorted: each chunk candidate
    (or ``t0_fixed``) with each strip, clamped to the grid, whose rings
    fit."""
    k, r = sweeps_per_call, spec.radius
    n0, n1 = interior_shape
    t0s = (t0_fixed,) if t0_fixed is not None else SLAB_MARCH_T0
    t1s = {16, 32} | {32 * m - 2 * k * r for m in SLAB_MARCH_WARPS
                      if 32 * m - 2 * k * r >= 8}
    tiles = {(min(t0, n0), min(t1, n1))
             for t0, t1 in itertools.product(t0s, t1s)}
    return sorted(t for t in tiles if slab_march_fits(t, k, r, itemsize, n1))


def march_key(tiles, k: int, spec: StencilSpec, interior_shape,
              itemsize: int = 4, constants=SLAB_MARCH_COST_CONSTANTS):
    """The march chooser's order: least :func:`_slab_march_cost`, then the
    wider strip, then the larger tile."""
    return (_slab_march_cost(tiles, interior_shape, k, spec, itemsize,
                             constants), -tiles[1], -math.prod(tiles))


def march_wins(march, window, k: int, spec: StencilSpec, interior_shape,
               itemsize: int = 4, constants=SLAB_MARCH_COST_CONSTANTS,
               window_constants=WINDOW_MS_CONSTANTS) -> bool:
    """The schedule rule: whether the march at tiles ``march`` is
    estimated faster than the window at ``window``; never in bfloat16
    (``itemsize`` 2), where the march was measured slower (the module
    docstring)."""
    if itemsize == 2:
        return False
    return _slab_march_cost(march, interior_shape, k, spec, itemsize,
                            constants) < window_ms(
        window, k, spec, interior_shape, itemsize, window_constants)


def choose_slab_march_tiles(spec: StencilSpec, interior_shape,
                            sweeps_per_call: int,
                            t0_fixed: Optional[int] = None, dtype="float32"
                            ) -> Optional[Tuple[int, int]]:
    """The (d0 chunk, t1) of least estimated time (:func:`march_key`)
    among those whose rings fit; None if nothing fits. ``t0_fixed`` pins
    the chunk."""
    itemsize = torch_dtype(dtype).itemsize
    tiles = march_candidates(spec, interior_shape, sweeps_per_call, t0_fixed,
                             itemsize)
    if not tiles:
        return None
    return min(tiles, key=lambda t: march_key(
        t, sweeps_per_call, spec, interior_shape, itemsize))


def make_slab_plan(spec: StencilSpec, interior_shape, dtype="float32",
                   sweeps_per_call: int = 1, tiles=None,
                   t0_fixed: Optional[int] = None,
                   schedule: Optional[str] = None) -> SlabPlan:
    """Plan for ``sweeps_per_call`` sweeps per launch on a 2D grid;
    ``tiles`` pins (t0, t1), ``t0_fixed`` (the CLI's ``-b``) pins only
    t0, the window's rows per tile or the march's chunk. ``schedule``
    None takes the rule of the module docstring (``tiles`` given: the
    window); "march" or "window" asks for one."""
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
    if schedule not in (None, *SCHEDULES):
        raise ValueError(f"schedule {schedule!r}: one of {SCHEDULES}")
    interior_shape = tuple(int(n) for n in interior_shape)
    k, r = sweeps_per_call, spec.radius
    n1 = interior_shape[1]
    itemsize = torch_dtype(dtype).itemsize
    limit = device_model.budgets().smem_per_block
    pinned = f" with t0={t0_fixed}" if t0_fixed is not None else ""
    if tiles is not None:
        tiles = tuple(int(t) for t in tiles)
        if len(tiles) != 2 or any(t < 1 or t > n
                                  for t, n in zip(tiles, interior_shape)):
            raise ValueError(
                f"tiles {tiles} must lie in [1, {interior_shape}]")
        if schedule is None:
            schedule = "window"
    march = window = tiles
    if schedule != "window" and tiles is None:
        march = choose_slab_march_tiles(spec, interior_shape, k, t0_fixed,
                                        dtype)
        if march is None and schedule == "march":
            raise ValueError(
                f"no march tile of {interior_shape} at k={k}{pinned} "
                f"fits {limit} bytes of shared memory")
    if schedule == "march":
        if not slab_march_fits(march, k, r, itemsize, n1):
            raise ValueError(
                f"tiles {march} at k={k}, r={r} do not fit the march "
                f"kernel ({slab_march_smem_bytes(march, k, r, itemsize, n1)}"
                f" bytes of rings, at most {limit})")
        chosen = "march"
    else:
        if tiles is None:
            window = choose_tiles(spec, interior_shape, k, t0_fixed, dtype)
        if window is None and march is None:
            raise ValueError(
                f"no tile of {interior_shape} at k={k}{pinned} fits "
                f"{limit} bytes of shared memory")
        if window is not None and \
                _smem_bytes(window, k, r, itemsize) > limit:
            raise ValueError(
                f"tiles {window} at k={k}, r={r} need "
                f"{_smem_bytes(window, k, r, itemsize)} bytes of shared "
                f"memory > {limit}")
        chosen = "march" if schedule is None and march is not None and (
            window is None or march_wins(march, window, k, spec,
                                         interior_shape, itemsize)) \
            else "window"
    return SlabPlan(spec=spec, interior_shape=interior_shape, dtype=dtype,
                    sweeps_per_call=k,
                    tiles=march if chosen == "march" else window,
                    layout=PaddedLayout.for_halo(interior_shape, k * r),
                    schedule=chosen)


class SlabStencil(KernelStencil):
    """User-facing handle mirroring ``PallasStencil`` on 2D grids: k
    sweeps per kernel launch over a ``HaloGrid`` on ``device``,
    with an optional static ``source`` (``u' = S(u) + source_scale *
    source``), on the plan's ``schedule`` (:func:`make_slab_plan`).
    Iterations that are not a multiple of k end in one launch of the
    remainder, on the same padded tensors."""

    kernel = slab_sweep

    def __init__(self, spec: StencilSpec, interior_shape, dtype="float32",
                 sweeps_per_call: int = 1, tiles=None,
                 t0_fixed: Optional[int] = None, device="cuda",
                 source=None, source_scale=1.0,
                 schedule: Optional[str] = None):
        super().__init__(make_slab_plan(spec, interior_shape, dtype,
                                        sweeps_per_call, tiles, t0_fixed,
                                        schedule),
                         device, source, source_scale)
