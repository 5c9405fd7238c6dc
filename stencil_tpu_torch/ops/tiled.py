"""3D temporally blocked tiled iterate: plan, and the user-facing handle.

Counterpart of ``stencil_tpu/ops/pallas_tiled.py`` (``TiledPlan``,
``make_tiled_plan``, ``_dynamic_pins``, ``_cached_tiled_iterate``,
``TiledPallasStencil``). Each launch of the CUDA kernel
(``ops/tiled_kernel.py``) runs k sweeps per round trip to device memory.

Periodic and Neumann walls (on any dim at k=1, on d0 and d1 at any k) take
JAX's gates (``ops/sweep_kernel.py:check_dynamic_walls``). Every runner
then pads once,
refreshes the dynamic ghosts of its inputs to the launch's depth k*r before
every launch (``ops/layout.py:refresh_dynamic_layout``), and launches with
those faces live (:func:`dynamic_pins`); the padded source and coefficient
carry the wrapped or mirrored images once, to full depth.

A plan may carry ``cheby_coeffs`` (the kernel's Chebyshev mode) and
``cheby_dual`` (its fused smooth+residual), ``two_level`` (the leapfrog of
the wave equation) or ``coeff_scales`` (the variable-coefficient operator
of heterogeneous diffusion). Two runners serve the multigrid fine level,
whose right-hand side changes from call to call, with the padded source
given per call: :func:`source_iterate` (counterpart of
``_cached_tiled_source_iterate``) and :func:`cheby_dual` (counterpart of
``_cached_cheby_dual_fn``). :func:`wave_iterate` (``_cached_wave_iterate``)
marches the two levels of a ``two_level`` plan; :func:`coeff_iterate`
(``_cached_tiled_coeff_iterate``) marches a ``coeff`` plan and
:func:`coeff_apply` (``_cached_coeff_apply``) applies it once, the Krylov
matvec, both with the plan's coefficient operand given per call
(:func:`coeff_operand`: on the march the weight fields that
``csrc/coeff_weights.cu`` forms once from :func:`pad_coeff`'s padded a(x),
on the window the padded a(x) itself).

The plan is new, not a port of the TPU's ``choose_tiles``. It picks one of
two schedules of the kernel (``TiledPlan.schedule``):

- ``"march"`` (``csrc/tiled_march.cu``): a CUDA block owns a (t1, t2) tile
  of d1 and d2 and a chunk of t0 planes of d0, and marches d0 through one
  ring of 2r+2 planes per sweep level (2r+3 in the two-level, Chebyshev
  and dual modes, whose level s also reads level s-2's plane), each
  level's planes as wide as the tile grown by (k-s)*r; the rings,
  :func:`march_smem_bytes`, must fit 227 KB (232,448 bytes) on sm_90.
  Every mode takes it, in float32 and bfloat16 (the coefficient mode in
  float32), with pins (the Chebyshev modes keep every face pinned) and,
  but in the two-level mode, tile subsets, wherever the rings fit (k <=
  16; a bf16 input plane of at most 8192 points), the tiles from
  :func:`choose_march_tiles`. That holds at k=1 too: the two schedules'
  k=1 launches timed at 256^3 by ``chip_smoke.py`` put the march ahead
  (PERF.md), and the Krylov matvec (a coefficient plan at k=1) marches as
  well; ``chip_smoke.py`` times it on both schedules. A two-level or
  Chebyshev plan of one sweep takes the window: its one window, with no
  second buffer, was the faster launch on an H100, at cfg9's 256^3 for
  the two-level mode (``data/march_two_level_tiles_h100.csv``) and at
  255^3 for the Chebyshev mode (``data/march_cheby_tiles_h100_fit.csv``;
  from k=2 on the march wins there, in both modes and both dtypes timed).
- ``"window"`` (``csrc/tiled_sweep.cu``): a block holds one output tile of
  (t0, t1, t2) points plus its k*r-deep 3D window in shared memory, two
  window buffers when k > 1, the windows shrinking by r per sweep in
  every dim. A two-level or Chebyshev plan at k=1 takes it, and plans of
  every mode whose rings do not fit.
  Among the tiles that fit, :func:`choose_tiles` takes the one of least
  estimated time per output point: the warp slots of the window load and
  of the k shrinking sweeps, discounted by the blocks that fit on one SM
  (:func:`_cost`, fitted to a tile sweep measured on an H100).

Each point takes ``plan.itemsize`` bytes of shared memory (4 in float32,
2 in bfloat16).

``TiledStencil.iterate`` is the iterate both kernels share
(``ops/sweep_kernel.py:KernelStencil``). :func:`partition_tiles` splits a
plan's tile columns into the interior and edge subsets of the overlapped
sharded step (``parallel/sharded_kernel.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from stencil_tpu_torch import device_model
from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, dtype_name, torch_dtype,
)
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.ops.layout import PaddedLayout, refresh_dynamic_layout
from stencil_tpu_torch.ops.sweep_kernel import (  # noqa: F401 (re-export)
    KernelStencil, check_dynamic_walls, dynamic_pins, launch_plans,
)
from stencil_tpu_torch.ops.tiled_kernel import coeff_weights, tiled_sweep
from stencil_tpu_torch.utils.tracing import count, span

# an H100's shared memory per block; the plans read the card's budgets
# from ``device_model.budgets()``, an H100's on an H100 and on the CPU
SMEM_LIMIT = device_model.H100.smem_per_block
WINDOW_THREADS = 512   # threads of a window block
MAX_CHEBY_SWEEPS = 16  # coefficient tuples the kernel takes per launch
DTYPES = ("float32", "bfloat16")  # the kernels' element types

SCHEDULES = ("march", "window")
MARCH_MAX_SWEEPS = 16   # sweep levels the march kernel takes per launch
MARCH_THREADS = 512     # threads of a march block
MARCH_STAGE = 16        # bf16: input plane points per thread (registers)

_T0_CANDIDATES = (1, 2, 4, 8, 16)
_T1_CANDIDATES = (2, 4, 8, 16, 32)
# the chooser's cost model, fitted to a 256^3 tile sweep on an H100
# (PERF.md, Findings): a row's fixed cost in tap loads, and the number of
# resident blocks beyond which more hide no more latency
_ROW_COST = 10
_BLOCKS_SATURATE = 3


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """Geometry of one kernel launch: ``sweeps_per_call`` sweeps of
    ``spec`` over tiles ``tiles`` of a tensor padded per ``layout``
    (``layout.halo >= sweeps_per_call * spec.radius``)."""

    spec: StencilSpec
    interior_shape: Tuple[int, int, int]
    dtype: str
    sweeps_per_call: int
    tiles: Tuple[int, int, int]
    layout: PaddedLayout
    # Chebyshev mode: one (c, n, pv, s) per sweep, u_t = n*S(u_{t-1}) +
    # c*u_{t-1} + pv*u_{t-2} + s*f over the raw f; () = the plain or source
    # sweep
    cheby_coeffs: Tuple = ()
    # dual mode: sweep k-1 also goes to a second output (the fused
    # smooth+residual of multigrid)
    cheby_dual: bool = False
    # two-level mode: the leapfrog L_t = S(L_{t-1}) - L_{t-2}, two inputs
    # (levels n, n-1) and two outputs (levels n+k, n+k-1)
    two_level: bool = False
    # coefficient mode: (nb, c0, cs) of the radius-1 operator with face
    # weights nb*harm(a(p), a(p+-e_d)) and center c0 + cs*sum(face means)
    # over a padded coefficient a(x); () = not that mode
    coeff_scales: Tuple = ()
    # "window" (tiled_sweep.cu) or "march" (tiled_march.cu; tiles = (d0
    # chunk, t1, t2)), each running every mode
    schedule: str = "window"

    @property
    def has_coeff(self) -> bool:
        return bool(self.coeff_scales)

    @property
    def reads_older(self) -> bool:
        """Whether sweep s also reads sweep s-2 at the point (the
        two-level, Chebyshev and dual modes): the march keeps rings of
        2r+3 planes for them (:func:`march_slots`)."""
        return self.two_level or bool(self.cheby_coeffs)

    @property
    def itemsize(self) -> int:
        """Bytes per point of the padded tensors and the windows."""
        return torch_dtype(self.dtype).itemsize

    @property
    def halo(self) -> int:
        """Window overfetch per side, k*r."""
        return self.sweeps_per_call * self.spec.radius

    @property
    def window_shape(self) -> Tuple[int, int, int]:
        return tuple(t + 2 * self.halo for t in self.tiles)

    @property
    def num_tiles(self) -> Tuple[int, int, int]:
        return tuple(-(-n // t) for n, t in zip(self.interior_shape,
                                                 self.tiles))

    @property
    def smem_bytes(self) -> int:
        """Shared memory of one block. March: the rings
        (:func:`march_smem_bytes`). Window, in every mode: one window, two
        when k > 1 (the Chebyshev, dual and two-level modes write u_t over
        u_{t-2}; the coefficient mode reads a(x) from global memory)."""
        if self.schedule == "march":
            return march_smem_bytes(self.tiles, self.sweeps_per_call,
                                    self.spec.radius, self.itemsize,
                                    self.reads_older)
        return _smem_bytes(self.tiles, self.sweeps_per_call,
                           self.spec.radius, self.itemsize)

    def tile_starts(self, d: int) -> Tuple[int, ...]:
        """Interior start of each tile along dim ``d``; the last one is
        clamped to ``n - t`` (the kernel computes the same)."""
        n, t = self.interior_shape[d], self.tiles[d]
        return tuple(min(i * t, n - t) for i in range(self.num_tiles[d]))

    def window_origin(self, d: int, start: int) -> int:
        """Padded index where the window of a tile starting at interior
        index ``start`` begins along dim ``d``."""
        return start + self.layout.halo - self.halo

    def kernel_geometry(self) -> Tuple[int, ...]:
        """The kernel's int32[15] geometry: n0 n1 n2 p0 p1 p2 halo t0 t1
        t2 nt0 nt1 nt2 k r."""
        return (*self.interior_shape, *self.layout.padded_shape,
                self.layout.halo, *self.tiles, *self.num_tiles,
                self.sweeps_per_call, self.spec.radius)

    def with_sweeps(self, k: int) -> "TiledPlan":
        """The same tiles and layout at ``k <= sweeps_per_call`` sweeps
        (the remainder launch reuses the padded tensors). A Chebyshev plan
        keeps its first k coefficient tuples, which are the degree-k
        smoother (``pallas_tiled.py:2440``); a dual plan cut short loses
        its second output; the two-level and coefficient modes stay."""
        if not 1 <= k <= self.sweeps_per_call:
            raise ValueError(f"k={k} outside [1, {self.sweeps_per_call}]")
        return dataclasses.replace(
            self, sweeps_per_call=k, cheby_coeffs=self.cheby_coeffs[:k],
            cheby_dual=self.cheby_dual and k == self.sweeps_per_call)


def _smem_bytes(tiles, k: int, r: int, itemsize: int = 4) -> int:
    return (1 if k == 1 else 2) * math.prod(t + 2 * k * r for t in tiles) \
        * itemsize


def _cost(tiles, k: int, spec: StencilSpec, itemsize: int = 4,
          budgets: Optional[device_model.Budgets] = None) -> float:
    """Estimated time per output point of a tile: the warp slots of the
    window load (32 points each) and of the k sweeps (a row of c points
    takes ceil(c / 32) slots of ``num_taps + _ROW_COST``), divided by the
    latency hiding that resident blocks buy, ``min(blocks, 3) ** 0.25``
    (the blocks an SM of ``budgets``, by default the card's, holds).
    On the sweep it was fitted to (float32), it picks within 20% of the
    fastest tile at every k, for jacobi7 and jacobi27; in bfloat16 the
    same model counts 2-byte windows."""
    b = budgets or device_model.budgets()
    r = spec.radius
    w = [t + 2 * k * r for t in tiles]
    slots = math.prod(w) / 32
    for s in range(1, k + 1):
        e = s * r
        slots += (w[0] - 2 * e) * (w[1] - 2 * e) * -(-(w[2] - 2 * e) // 32) \
            * (spec.num_taps + _ROW_COST)
    blocks = min(b.threads_per_sm // WINDOW_THREADS, _BLOCKS_SATURATE,
                 b.smem_per_sm // (_smem_bytes(tiles, k, r, itemsize)
                                   + b.smem_reserved))
    return slots / math.prod(tiles) / max(1, blocks) ** 0.25


def march_slots(r: int, deep: bool = False) -> int:
    """Planes in each ring of a march block: 2r+2, one more (``deep``) in
    the modes that read level s-2 (two-level, Chebyshev, dual). A step
    reads planes j-r .. j+r of every level's ring and writes plane j+r+1;
    those modes also read level s-2's plane j-r-1 (the leapfrog's
    subtrahend, the recurrence's u_{t-2}), which must not be the slot
    written in the same step: 2r+3 is the least depth for which it is
    not."""
    return 2 * r + 2 + bool(deep)


def march_smem_bytes(tiles, k: int, r: int, itemsize: int = 4,
                     deep: bool = False) -> int:
    """Shared memory of a march block: :func:`march_slots` planes per sweep
    level s = 0 .. k-1, each (t1 + 2(k-s)r) x (t2 + 2(k-s)r) points."""
    _, t1, t2 = tiles
    return march_slots(r, deep) * itemsize * sum(
        (t1 + 2 * (k - s) * r) * (t2 + 2 * (k - s) * r) for s in range(k))


def march_fits(tiles, k: int, r: int, itemsize: int = 4,
               deep: bool = False,
               budgets: Optional[device_model.Budgets] = None) -> bool:
    """Whether the march kernel takes these tiles: k <= 16, the rings
    (``deep``: 2r+3 planes) in one block's shared memory (of ``budgets``,
    by default the card's), and in bfloat16 (2-byte points, which the
    kernel stages through registers) an input plane of at most 8192
    points."""
    _, t1, t2 = tiles
    plane = (t1 + 2 * k * r) * (t2 + 2 * k * r)
    limit = (budgets or device_model.budgets()).smem_per_block
    return (k <= MARCH_MAX_SWEEPS
            and march_smem_bytes(tiles, k, r, itemsize, deep) <= limit
            and (itemsize == 4 or plane <= MARCH_STAGE * MARCH_THREADS))


# the march chooser's cost model, in warp slots of one block, fitted to
# march tiles timed at 256^3 on an H100 (jacobi7 k = 1, 2, 4, 8 fp32 and
# k=8 bf16; data/march_tiles_h100_fit.csv, tile_sweep.py --march): a
# point's cost beyond its tap loads, an input point's load, a step's
# barrier and the imbalance it exposes
MARCH_COST_CONSTANTS = (10, 32, 2048)


def _march_cost(tiles, interior_shape, k: int, spec: StencilSpec,
                constants=MARCH_COST_CONSTANTS,
                budgets: Optional[device_model.Budgets] = None) -> float:
    """Estimated time per output point of a march plan: per block, each
    level's planes (t0 + 2(k-s)r of them) in passes of 512 threads of
    ``num_taps`` + the row cost slots per point, the input planes' loads
    and one barrier per step; times the blocks each SM runs (the SMs of
    ``budgets``, by default the card's: 132 on an H100; blocks resident
    together share the SM: on the sweep it was fitted to, more of them per
    SM hid nothing). On that sweep it picks
    the fastest tile of each of the five cases; the fit needed no term
    for the item size."""
    row_cost, load_cost, step_cost = constants
    r = spec.radius
    t0, t1, t2 = tiles
    warps = MARCH_THREADS // 32

    def passes(s):
        return -(-(t1 + 2 * (k - s) * r) * (t2 + 2 * (k - s) * r)
                 // MARCH_THREADS)

    slots = sum((t0 + 2 * (k - s) * r) * passes(s) * warps
                * (spec.num_taps + row_cost) for s in range(1, k + 1))
    slots += (t0 + 2 * k * r) * passes(0) * warps * load_cost
    slots += (t0 + 2 * k * r + k) * step_cost
    blocks = math.prod(-(-n // t) for n, t in zip(interior_shape, tiles))
    sms = (budgets or device_model.budgets()).sm_count
    return -(-blocks // sms) * slots / math.prod(interior_shape)


MARCH_T0_CANDIDATES = (8, 16, 32, 64, 128, 256)
_MARCH_T_CANDIDATES = (8, 16, 24, 32, 48, 64)


# the same model's constants for the two-level mode, whose update adds a
# subtrahend read and a subtraction to the taps and whose rings are a plane
# deeper, fitted to its tiles timed at cfg9's 256^3 on an H100 (k = 1, 2,
# 4, 8 fp32, k=8 bf16 and with periodic d0 and Neumann d1;
# data/march_two_level_tiles_h100.csv, tile_sweep.py --march --two-level):
# among the constants of the fit grid that pick the fastest tile of every
# case, the nearest to MARCH_COST_CONSTANTS
MARCH_TWO_LEVEL_COST_CONSTANTS = (8, 32, 8192)
# The Chebyshev and dual modes (an update adds the source read, the level
# s-2 read and five operations to nbsum3d's six taps; the rings are 2r+3
# planes deep) keep MARCH_COST_CONSTANTS: fitted to their tiles timed at
# 255^3 on an H100 (data/march_cheby_tiles_h100_fit.csv, tile_sweep.py
# --march --cheby), those constants are the nearest to themselves among
# the constants of the fit grid that pick the fastest tile of every case.


def march_constants(two_level: bool) -> Tuple[int, int, int]:
    """The cost model's constants of a mode: the two-level mode's own,
    every other mode's (the Chebyshev and dual modes too) the homogeneous
    ones."""
    return MARCH_TWO_LEVEL_COST_CONSTANTS if two_level \
        else MARCH_COST_CONSTANTS


def rank_march_tiles(spec: StencilSpec, interior_shape,
                     sweeps_per_call: int,
                     t0_fixed: Optional[int] = None, dtype="float32",
                     deep: bool = False,
                     constants: Tuple[int, int, int] = MARCH_COST_CONSTANTS
                     ) -> List[Tuple[int, int, int]]:
    """Every (d0 chunk, t1, t2) whose rings fit (:func:`march_fits`;
    ``deep``: rings of 2r+3 planes), each once, in order of estimated cost
    (:func:`_march_cost` with ``constants``, :func:`march_constants` of the
    mode), ties to the wider d2 extent, then the larger tile, then the
    earlier candidate. ``t0_fixed`` pins the chunk. The first is
    :func:`choose_march_tiles`' pick; the autotuner measures the head
    (``autotune.py``)."""
    k, r = sweeps_per_call, spec.radius
    itemsize = torch_dtype(dtype).itemsize
    b = device_model.budgets()
    n0, n1, n2 = interior_shape
    t0s = (t0_fixed,) if t0_fixed is not None else MARCH_T0_CANDIDATES
    keys = {}
    for t0, t1, t2 in itertools.product(t0s, _MARCH_T_CANDIDATES,
                                        _MARCH_T_CANDIDATES):
        tiles = (min(t0, n0), min(t1, n1), min(t2, n2))
        if tiles in keys or not march_fits(tiles, k, r, itemsize, deep, b):
            continue
        keys[tiles] = (_march_cost(tiles, interior_shape, k, spec, constants,
                                   b),
                       -tiles[2], -math.prod(tiles))
    return sorted(keys, key=keys.get)


def choose_march_tiles(spec: StencilSpec, interior_shape,
                       sweeps_per_call: int,
                       t0_fixed: Optional[int] = None, dtype="float32",
                       deep: bool = False,
                       constants: Tuple[int, int, int] = MARCH_COST_CONSTANTS
                       ) -> Optional[Tuple[int, int, int]]:
    """The (d0 chunk, t1, t2) of least estimated cost, the head of
    :func:`rank_march_tiles`; None if nothing fits."""
    ranked = rank_march_tiles(spec, interior_shape, sweeps_per_call,
                              t0_fixed, dtype, deep, constants)
    return ranked[0] if ranked else None


def _t2_candidates(kr: int) -> Tuple[int, ...]:
    """Powers of two, and extents whose window rows are whole warps."""
    return tuple(sorted({16, 32, 64, 128} | {32 * m - 2 * kr
                                             for m in range(1, 5)
                                             if 32 * m > 2 * kr}))


def rank_tiles(spec: StencilSpec, interior_shape, sweeps_per_call: int,
               t0_fixed: Optional[int] = None, dtype="float32"
               ) -> List[Tuple[int, int, int]]:
    """Every window tile whose windows of ``dtype`` fit one block's shared
    memory, each once, in order of estimated cost (:func:`_cost`), ties to
    the wider d2 extent, then the larger tile, then the earlier candidate.
    The first is :func:`choose_tiles`' pick; the autotuner measures the
    head (``autotune.py``)."""
    k, r = sweeps_per_call, spec.radius
    itemsize = torch_dtype(dtype).itemsize
    b = device_model.budgets()
    n0, n1, n2 = interior_shape
    t0s = (t0_fixed,) if t0_fixed is not None else _T0_CANDIDATES
    keys = {}
    for t0, t1, t2 in itertools.product(t0s, _T1_CANDIDATES,
                                        _t2_candidates(k * r)):
        tiles = (min(t0, n0), min(t1, n1), min(t2, n2))
        if tiles in keys \
                or _smem_bytes(tiles, k, r, itemsize) > b.smem_per_block:
            continue
        keys[tiles] = (_cost(tiles, k, spec, itemsize, b), -tiles[2],
                       -math.prod(tiles))
    return sorted(keys, key=keys.get)


def choose_tiles(spec: StencilSpec, interior_shape, sweeps_per_call: int,
                 t0_fixed: Optional[int] = None, dtype="float32"
                 ) -> Optional[Tuple[int, int, int]]:
    """The feasible tile of least estimated cost, the head of
    :func:`rank_tiles`; None if nothing fits."""
    ranked = rank_tiles(spec, interior_shape, sweeps_per_call, t0_fixed,
                        dtype)
    return ranked[0] if ranked else None


def _check_cheby(spec: StencilSpec, k: int, has_source: bool,
                 cheby_coeffs, cheby_dual: bool):
    """The Chebyshev-mode validation of ``make_tiled_plan``
    (``pallas_tiled.py:481-508``, the same messages); returns the
    coefficients as a tuple of float 4-tuples, or ()."""
    if cheby_coeffs is None:
        if cheby_dual:
            raise ValueError("cheby_dual needs cheby_coeffs")
        return ()
    if not has_source:
        raise ValueError(
            "cheby_coeffs needs the fused source stream "
            "(has_source=True): every sweep reads s_t * f")
    if spec.radius != 1:
        raise ValueError(
            "cheby_coeffs expects the radius-1 neighbor-sum spec")
    if len(cheby_coeffs) != k:
        raise ValueError(
            f"cheby_coeffs has {len(cheby_coeffs)} sweeps, plan has "
            f"sweeps_per_call={k}")
    coeffs = tuple(tuple(float(v) for v in c) for c in cheby_coeffs)
    if any(len(c) != 4 for c in coeffs):
        raise ValueError("each cheby sweep needs (c, n, pv, s)")
    if cheby_dual and k < 2:
        raise ValueError(
            "cheby_dual fuses the final sweep as a second output; "
            "it needs sweeps_per_call >= 2 (smoother + final)")
    if k > MAX_CHEBY_SWEEPS:
        raise ValueError(f"cheby_coeffs has {k} sweeps; the kernel takes "
                         f"at most {MAX_CHEBY_SWEEPS} per launch")
    return coeffs


def _check_modes(spec: StencilSpec, dtype, has_source: bool,
                 two_level: bool, coeff_scales, cheby_coeffs):
    """The two-level and coefficient-mode validation of
    ``make_tiled_plan`` (``pallas_tiled.py:447-463, 477-491``, the same
    messages); returns the coefficient scales as a float 3-tuple, or ()."""
    if coeff_scales is not None:
        if torch_dtype(dtype).itemsize != 4:
            raise ValueError(
                "coeff tap mode needs a 4-byte dtype (its d1 shifts are "
                "sublane rotates, which have no Mosaic-safe lowering "
                "for 16-bit dtypes)")
        if two_level:
            raise ValueError(
                "coeff tap mode composes with the plain pipelined "
                "schedule only (no slide/two_level)")
        if spec.radius != 1:
            raise ValueError(
                "coeff tap mode is the radius-1 face-weight stencil; "
                "pass a radius-1 spec")
    if two_level and has_source:
        raise ValueError(
            "the two-level (leapfrog) recursion composes with the plain "
            "pipelined schedule only (no source/slide/cores/embed)")
    if cheby_coeffs is not None and has_source and (
            two_level or coeff_scales is not None):
        raise ValueError(
            "the Chebyshev recurrence composes with the plain "
            "pipelined source schedule only "
            "(no slide/two_level/embed/coeff)")
    if coeff_scales is None:
        return ()
    scales = tuple(float(v) for v in coeff_scales)
    if len(scales) != 3:
        raise ValueError("coeff_scales is (nb, c0, cs)")
    return scales


def make_tiled_plan(spec: StencilSpec, interior_shape, dtype="float32",
                    sweeps_per_call: int = 1, tiles=None,
                    t0_fixed: Optional[int] = None, has_source: bool = False,
                    cheby_coeffs=None, cheby_dual: bool = False,
                    two_level: bool = False, coeff_scales=None,
                    schedule: Optional[str] = None) -> TiledPlan:
    """Plan for ``sweeps_per_call`` sweeps per launch; ``tiles`` pins
    (t0, t1, t2), ``t0_fixed`` pins only t0 (a march plan's d0 chunk).
    ``cheby_coeffs`` (one ``(c, n, pv, s)`` per sweep; needs
    ``has_source``, the padded raw f of every launch) selects the
    Chebyshev mode, ``cheby_dual`` its fused smooth+residual;
    ``two_level`` the leapfrog; ``coeff_scales`` (nb, c0, cs) the
    coefficient mode. On the window schedule every mode takes the shared
    memory of a source plan (the kernel writes u_t over u_{t-2} in place;
    a(x) is read from global memory), so the chooser counts them the same.

    ``schedule`` None takes the rule of the module docstring: a plan
    marches where its rings fit, but a two-level or Chebyshev plan at k=1,
    which takes the window; "march" or "window" asks for one
    (``ValueError`` where it cannot run the plan). Each plan made is the
    span ``plan.make`` and counts in ``plans_made``."""
    with span("plan.make"):
        plan = _make_tiled_plan(spec, interior_shape, dtype,
                                sweeps_per_call, tiles, t0_fixed, has_source,
                                cheby_coeffs, cheby_dual, two_level,
                                coeff_scales, schedule)
    count("plans_made")
    return plan


def _make_tiled_plan(spec, interior_shape, dtype, sweeps_per_call, tiles,
                     t0_fixed, has_source, cheby_coeffs, cheby_dual,
                     two_level, coeff_scales, schedule) -> TiledPlan:
    if spec.ndim != 3 or len(interior_shape) != 3:
        raise ValueError("tiled kernel is 3D-only")
    dtype = dtype_name(torch_dtype(dtype))
    scales = _check_modes(spec, dtype, has_source, two_level, coeff_scales,
                          cheby_coeffs)
    if dtype not in DTYPES:
        raise ValueError(f"tiled kernel dtype {dtype!r}: the kernel takes "
                         f"{' or '.join(DTYPES)}")
    if sweeps_per_call < 1:
        raise ValueError("sweeps_per_call must be >= 1")
    coeffs = _check_cheby(spec, sweeps_per_call, has_source, cheby_coeffs,
                          cheby_dual)
    interior_shape = tuple(int(n) for n in interior_shape)
    k, r = sweeps_per_call, spec.radius
    itemsize = torch_dtype(dtype).itemsize
    limit = device_model.budgets().smem_per_block
    if schedule is not None and schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r}: one of {SCHEDULES}")
    # a two-level or Chebyshev launch of one sweep: the window's (one
    # window, no second buffer) beats the march's on an H100, 0.1615
    # against 0.2012 ms at cfg9's 256^3 (data/march_two_level_tiles_h100
    # .csv), 0.1249 against 0.1353 at 255^3
    # (data/march_cheby_tiles_h100_fit.csv)
    deep = two_level or bool(coeffs)
    march = schedule == "march" or (
        schedule is None and not (deep and k == 1))
    if tiles is None and march:
        tiles = choose_march_tiles(spec, interior_shape, k, t0_fixed, dtype,
                                   deep, march_constants(two_level))
        if tiles is None and schedule == "march":
            raise ValueError(f"no march tile of {interior_shape} at k={k} "
                             f"fits {limit} bytes of shared memory")
        march = tiles is not None
    if tiles is None:
        tiles = choose_tiles(spec, interior_shape, k, t0_fixed, dtype)
        if tiles is None:
            raise ValueError(
                f"no tile of {interior_shape} at k={k} fits "
                f"{limit} bytes of shared memory")
    tiles = tuple(int(t) for t in tiles)
    if any(t < 1 or t > n for t, n in zip(tiles, interior_shape)):
        raise ValueError(f"tiles {tiles} must lie in [1, {interior_shape}]")
    march = march and march_fits(tiles, k, r, itemsize, deep)
    if schedule == "march" and not march:
        raise ValueError(
            f"tiles {tiles} at k={k}, r={r} do not fit the march kernel "
            f"({march_smem_bytes(tiles, k, r, itemsize, deep)} bytes "
            f"of rings, at most {limit}; k <= {MARCH_MAX_SWEEPS})")
    if not march and _smem_bytes(tiles, k, r, itemsize) > limit:
        raise ValueError(
            f"tiles {tiles} at k={k}, r={r} need "
            f"{_smem_bytes(tiles, k, r, itemsize)} bytes of shared memory "
            f"> {limit}")
    return TiledPlan(spec=spec, interior_shape=interior_shape, dtype=dtype,
                     sweeps_per_call=k, tiles=tiles,
                     layout=PaddedLayout.for_halo(interior_shape, k * r),
                     cheby_coeffs=coeffs, cheby_dual=bool(cheby_dual),
                     two_level=bool(two_level), coeff_scales=scales,
                     schedule="march" if march else "window")


def partition_tiles(plan: TiledPlan) -> Tuple[Tuple[int, ...],
                                              Tuple[int, ...]]:
    """(interior ids, edge ids) of the plan's tile columns, the phase split
    of the overlapped sharded step. A column is one (i0, i1) pair with
    every d2 tile of it, id ``i0 * nt1 + i1`` (the kernel's subset unit,
    ``csrc/tiled_sweep.cu``). It is interior when its windows stay clear
    of the ``k*r``-deep d0 and d1 ghost bands, which a mesh exchange and
    the refresh of an unsharded periodic or Neumann dim write: its clamped
    tile start is ``>= k*r`` and start + t + ``k*r`` ``<= n`` in d0 and in
    d1. Every other column is edge. Device-independent, as JAX's: a
    column by a physical wall is edge too, a scheduling choice only.

    Counterpart of ``pallas_tiled.partition_tiles`` (:1879-1908), whose
    tiles span d2 whole."""
    kr = plan.halo
    starts = [plan.tile_starts(d) for d in (0, 1)]
    interior, edge = [], []
    for i0, s0 in enumerate(starts[0]):
        for i1, s1 in enumerate(starts[1]):
            clear = all(kr <= s and s + t + kr <= n for s, t, n in zip(
                (s0, s1), plan.tiles[:2], plan.interior_shape[:2]))
            (interior if clear else edge).append(i0 * len(starts[1]) + i1)
    return tuple(interior), tuple(edge)


def _interior(data: torch.Tensor, halo: int) -> torch.Tensor:
    return data[tuple(slice(halo, s - halo) for s in data.shape)]


def _repad(plan: TiledPlan, padded: torch.Tensor, halo: int,
           bc: DirichletBC) -> torch.Tensor:
    """The interior of a plan-padded tensor as a new ``halo``-padded one
    with the ring set to ``bc``."""
    return HaloGrid.from_interior(plan.layout.unpad(padded), halo, bc,
                                  device=padded.device).data


def source_iterate(plan: TiledPlan, data: torch.Tensor, bc: DirichletBC,
                   src: torch.Tensor, n_outer: int = 1,
                   grid_halo: int = 1) -> torch.Tensor:
    """``n_outer`` launches of ``plan`` on the ``grid_halo``-padded tensor
    ``data`` (its interior is read; ``data`` is unchanged) with the padded
    source ``src`` given per call (``ops/layout.py:pad_source`` for the
    source mode, the raw f scaled by 1.0 for the Chebyshev mode). Returns
    a new ``grid_halo``-padded tensor with the ring set to ``bc``.

    Counterpart of ``pallas_tiled._cached_tiled_source_iterate(plan, bc,
    interpret, grid_halo)(data, n_outer, src)``; with periodic/Neumann
    walls ``src`` must carry their images (``pad_source`` with ``bc``)."""
    if plan.cheby_dual:
        raise ValueError("a cheby_dual plan runs through cheby_dual()")
    pins = check_dynamic_walls(plan, bc)
    cur = plan.layout.pad(_interior(data, grid_halo), bc)
    nxt = cur.clone()
    for _ in range(n_outer):
        refresh_dynamic_layout(cur, plan.layout, bc, plan.halo)
        tiled_sweep(cur, nxt, plan, src, pins)
        cur, nxt = nxt, cur
    return _repad(plan, cur, grid_halo, bc)


def cheby_dual(plan: TiledPlan, data: torch.Tensor, bc: DirichletBC,
               src: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the dual ``plan`` (the fused smooth+residual) on the
    halo-1 padded ``data`` with the padded raw source ``src``: returns
    ``(u, r)``, the smoothed iterate (sweep k-1) halo-1 padded with the
    ring set to ``bc`` and the residual (sweep k) interior-shaped.

    Counterpart of ``pallas_tiled._cached_cheby_dual_fn(plan, bc,
    interpret)(data, src)``."""
    if not plan.cheby_dual:
        raise ValueError("cheby_dual() runs a cheby_dual plan")
    check_dynamic_walls(plan, bc)
    cur = plan.layout.pad(_interior(data, 1), bc)
    r_pad = torch.empty_like(cur)  # only its interior is written and read
    u_pad = cur.clone()            # its ghosts must hold the walls
    tiled_sweep(cur, r_pad, plan, src, out2=u_pad)
    return _repad(plan, u_pad, 1, bc), plan.layout.unpad(r_pad)


def wave_iterate(plan: TiledPlan, cur_data: torch.Tensor,
                 prev_data: torch.Tensor, bc: DirichletBC, n_outer: int,
                 grid_halo: int = 1, rem: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_outer`` launches of the ``two_level`` ``plan``, then one of
    ``rem`` steps (``plan.with_sweeps(rem)``), on the ``grid_halo``-padded
    levels ``cur_data`` (L_n) and ``prev_data`` (L_{n-1}): returns new
    ``grid_halo``-padded ``(L_{n+s}, L_{n+s-1})``, s = k*n_outer + rem,
    rings set to ``bc``. Both levels are padded once and unpadded once; the
    four padded tensors rotate, the pair just read becoming the next
    launch's outputs; with periodic/Neumann walls both levels are
    refreshed before every launch.

    Counterpart of ``pallas_tiled._cached_wave_iterate(plan, bc, interpret,
    grid_halo)(cur_data, prev_data, n_outer)`` (:2216-2261)."""
    if not plan.two_level:
        raise ValueError("wave_iterate() runs a two_level plan")
    pins = check_dynamic_walls(plan, bc)
    h = grid_halo
    cur = plan.layout.pad(_interior(cur_data, h), bc)
    prev = plan.layout.pad(_interior(prev_data, h), bc)
    out, out2 = cur.clone(), prev.clone()  # ghosts hold the walls
    for launch_plan in launch_plans(plan, n_outer, rem):
        refresh_dynamic_layout(cur, plan.layout, bc, launch_plan.halo)
        refresh_dynamic_layout(prev, plan.layout, bc, launch_plan.halo)
        tiled_sweep(cur, out, launch_plan, pins=pins, prev=prev, out2=out2)
        cur, prev, out, out2 = out, out2, cur, prev
    return _repad(plan, cur, h, bc), _repad(plan, prev, h, bc)


def pad_coeff(plan: TiledPlan, a, bc: DirichletBC) -> torch.Tensor:
    """The padded coefficient operand of a ``coeff`` plan: ``float32(a)``
    with every ghost edge-replicated (the nearest interior value) to the
    layout's full depth, so that the face mean at a wall is the wall
    cell's own coefficient (``models/diffusion.py:face_harmonic_means``)
    and every pad cell stays positive; then the ghosts of a periodic or
    Neumann dim hold the wrapped or mirrored a(x), to full depth, once (it
    does not change). On the device of ``a`` when it is a tensor, else on
    the CPU; the caller moves it.

    Counterpart of ``pallas_tiled.pad_coeff`` (:2098-2121)."""
    arr = torch.as_tensor(a).to(torch.float32)
    if tuple(arr.shape) != plan.interior_shape:
        raise ValueError(
            f"coefficient shape {tuple(arr.shape)} != interior "
            f"{plan.interior_shape}")
    h = plan.layout.halo
    padded = F.pad(arr[None, None], (h,) * 6, mode="replicate")[0, 0] \
        .contiguous()
    return refresh_dynamic_layout(padded, plan.layout, bc, plan.halo)


def coeff_operand(plan: TiledPlan, coeff_padded: torch.Tensor
                  ) -> torch.Tensor:
    """What the launches of the ``coeff`` ``plan`` read, from the padded
    coefficient ``coeff_padded`` (:func:`pad_coeff`, on the launches'
    device): on the march the four weight fields ``[4, *padded]``, formed
    here once by the weights kernel (``ops/tiled_kernel.py:
    coeff_weights``, the TPU kernel's ``prep_weights``); on the window the
    padded a(x) itself, whose weights that kernel forms at every update.
    a(x) is static and its wall images are filled once, so a runner calls
    this once and passes the result to every launch; no launch refreshes
    it."""
    if not plan.has_coeff:
        raise ValueError("coeff_operand() takes a coeff plan")
    if plan.schedule == "march":
        return coeff_weights(coeff_padded, plan)
    return coeff_padded


def coeff_iterate(plan: TiledPlan, data: torch.Tensor, bc: DirichletBC,
                  coeff: torch.Tensor, n_outer: int = 1,
                  grid_halo: int = 1, rem: int = 0) -> torch.Tensor:
    """``n_outer`` launches of the ``coeff`` ``plan``, then one of ``rem``
    sweeps, on the ``grid_halo``-padded ``data`` with the plan's
    coefficient operand given per call (:func:`coeff_operand`): returns a
    new ``grid_halo``-padded tensor with the ring set to ``bc``.

    Counterpart of ``pallas_tiled._cached_tiled_coeff_iterate(plan, bc,
    interpret, grid_halo)(data, n_outer, coeff_padded)`` (:2125-2161);
    with periodic/Neumann walls the operand must carry their images
    (:func:`pad_coeff` with ``bc``)."""
    if not plan.has_coeff:
        raise ValueError("coeff_iterate() runs a coeff plan")
    pins = check_dynamic_walls(plan, bc)
    cur = plan.layout.pad(_interior(data, grid_halo), bc)
    nxt = cur.clone()
    for launch_plan in launch_plans(plan, n_outer, rem):
        refresh_dynamic_layout(cur, plan.layout, bc, launch_plan.halo)
        tiled_sweep(cur, nxt, launch_plan, pins=pins, coeff=coeff)
        cur, nxt = nxt, cur
    return _repad(plan, cur, grid_halo, bc)


def coeff_apply(plan: TiledPlan, padded_h1: torch.Tensor,
                coeff: torch.Tensor) -> torch.Tensor:
    """One application of the coefficient operator of a k=1 ``coeff``
    ``plan`` to the halo-1 padded ``padded_h1``, with the plan's
    coefficient operand (:func:`coeff_operand`): returns the interior.

    The operator honours the ghost ring of its input (the Krylov solvers
    apply it to a zero-padded correction and to the true-wall iterate). At
    k=1 the layout's halo is 1, so ``padded_h1`` is the kernel's padded
    input as it is and its ring is read directly; the wall faces, d2's
    included, weigh it by ``nb * harm(a, a)`` like every face (on the
    march the weights at padded index 1 .. n+1 of each dim, which the
    weights kernel forms from neighbours inside the padded array).

    Counterpart of ``pallas_tiled._cached_coeff_apply(plan,
    interpret)(padded_h1, coeff_padded)`` (:2165-2212), whose lane layout
    has no d2 ghosts and adds that face's term outside its kernel."""
    if plan.sweeps_per_call != 1 or not plan.has_coeff:
        raise ValueError("operator apply wants a sweeps_per_call=1 coeff "
                         "plan")
    cur = padded_h1.contiguous()
    out = torch.empty_like(cur)  # only its interior is written and read
    tiled_sweep(cur, out, plan, coeff=coeff)
    return plan.layout.unpad(out)


class TiledStencil(KernelStencil):
    """User-facing handle mirroring ``TiledPallasStencil``: k sweeps per
    kernel launch over a ``HaloGrid`` on ``device``, with an
    optional static ``source`` (``u' = S(u) + source_scale * source``), or
    with ``cheby_coeffs`` the Chebyshev recurrence over
    ``source_scale * source`` (each launch restarts it; the remainder launch
    runs the first coefficients). ``schedule`` goes to
    :func:`make_tiled_plan` (None: the rule)."""

    kernel = tiled_sweep

    def __init__(self, spec: StencilSpec, interior_shape, dtype="float32",
                 sweeps_per_call: int = 1, tiles=None,
                 t0_fixed: Optional[int] = None, device="cuda",
                 source=None, source_scale=1.0, cheby_coeffs=None,
                 cheby_dual: bool = False, schedule: Optional[str] = None):
        super().__init__(make_tiled_plan(spec, interior_shape, dtype,
                                         sweeps_per_call, tiles, t0_fixed,
                                         has_source=source is not None,
                                         cheby_coeffs=cheby_coeffs,
                                         cheby_dual=cheby_dual,
                                         schedule=schedule),
                         device, source, source_scale)
