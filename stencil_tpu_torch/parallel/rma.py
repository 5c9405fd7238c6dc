"""In-kernel halo exchange: every rank's blocks resident for a whole run,
strips pushed between ranks inside one launch (method ``rma``).

Counterpart of ``stencil_tpu/parallel/rma.py`` (``RmaPlan``,
``make_rma_plan``, ``push_bytes_per_step``, ``build_rma_iterate`` and
``RmaStencil``) on the port's single-controller mesh
(``parallel/mesh.py``), on Dirichlet, periodic and Neumann walls, in
float32 and bfloat16. The TPU kernel keeps each chip's padded block in VMEM
for ``n_outer`` outer steps and pushes k*r-deep edge strips chip to chip by
remote DMA, paced by semaphores. Its port, ``csrc/rma_iterate.cu``, keeps
the contract and changes the means:

- **one launch for the whole run**: a cooperative launch whose blocks are
  all co-resident, each owning fixed tiles of the ranks' interiors
  (:func:`rma_tiles`, the tile chosen by :func:`choose_rma_tile`);
- **the blocks never leave the device**: all ranks' buffers are one tensor
  ``[R, nbuf, *B]`` in device memory, sized by :func:`make_rma_plan` to
  stay inside the card's L2 (50 MiB on an H100), where the TPU kernel's
  budget was VMEM; each step's k sweeps of a tile run in shared memory;
- **the exchange written by its producer**: the phased exchange below is
  a fixed map of ghost cells to the cells whose values they receive
  (:func:`ghost_map`), so the tile that computes a source cell writes its
  ghost copies after its last sweep; no host copy, no ``ppermute``;
- **flags in place of the neighbour semaphores**: a tile waits, once per
  step, for the tiles whose writes meet its window and those whose window
  meets its writes (:attr:`RmaTiles.deps`), and publishes its own epoch;
  one grid barrier per launch, after the opening exchange.

One outer step from slot ``s`` to slot ``1 - s``, as the plain version
(:func:`rma_iterate_reference`) runs it (:func:`phase_copies` lists every
copy of the exchange):

- **the local refresh**, only where a dynamic dim is unsharded: its
  k*r-deep ghosts in slot ``s`` wrapped (periodic) or mirrored (Neumann:
  ghost layer j holds interior layer j-1) from the rank's own rows, over
  the interior of the sharded dim and the launch's extent of the others
  (JAX's ``refresh_unsharded``, :510-551). That dim can only be d1 of a 3D
  grid on a 1D mesh: the lane dim is gated and a 2D grid always shards d0.
  The phase-0 strips span these ghosts and carry them into the
  neighbours' corners;
- **one exchange phase per sharded dim**: each rank pushes its edge strips
  into its neighbours' opposite ghost bands. On a periodic dim the chain
  closes into a ring (JAX's ``per_sh``, :281): on a ring of 2 both
  neighbours are the same rank and on a ring of 1 the rank itself, each
  push into its own band. A rank on a Neumann face writes its own mirror
  ghosts with the strip's footprint (``mirror_dim``, :465-508); a rank on
  a Dirichlet face writes nothing there;
- **k sweeps**: sweep t updates the rank's interior grown by (k-t)*r on
  every live face (a neighbour's, a ring's, a Neumann face, both faces of
  the unsharded dynamic dim: JAX's ``ext_dims``/``rect``, :286-332).
  Sweeps 1..k-1 write the compute buffers (the kernel keeps them in
  shared memory), the last one the other slot.

The buffer tensor holds ``2 + num_compute_bufs`` padded blocks per rank,
all of which the L2 budget counts, as JAX counts its VMEM
(``resident_bytes``); the kernel touches the two slots (``live_bytes``).
An iteration count that k does not divide ends in one launch of
``plan.with_sweeps(rem)`` on the same buffers: rem*r-deep refreshes,
mirrors and strips, boxes grown by (rem-t)*r.

**The cells no phase writes.** A cell with a coordinate in a Dirichlet
ghost band (a Dirichlet face of a sharded dim at the mesh's edge, or
either face of a Dirichlet unsharded dim) is never a sweep's output: the
update boxes stop at Dirichlet faces. Its golden value never changes: the
golden fills the Dirichlet faces first, then wraps or mirrors the dynamic
dims over the full extent (``core/grid.py:fill_halo``), so a corner of a
Dirichlet band and a live band holds that Dirichlet face's value, and a
corner of two Dirichlet bands the later dim's. :meth:`RmaStencil.scatter`
cuts each rank's window from the global grid padded in that order into
every buffer, so these cells hold their golden value for the whole run; a
phase that copies into one copies the same constant from the same place
of the sender's band. JAX pads each block with the later dims winning
(``scatter_local``, :912), re-pins only the sharded faces (``pin``,
:562-601) and refreshes only the interior of the sharded dims, so where a
Dirichlet face of the sharded dim meets the dynamic unsharded dim its
corner keeps d1's nominal face value; the port follows the golden there.
Two more kinds of cell go unwritten and are never read: live ghosts
deeper than a remainder launch's rem*r, and the compute buffers' cells
outside the update boxes.

The per-rank tables (neighbour codes per phase, strip boxes, update boxes
per sweep) are built once per launch plan in Python (:func:`rma_tables`);
the plain version (:func:`rma_iterate_reference`) walks the copies and
boxes, the kernel the ghost map, tiles and dependencies built from them
(:func:`device_table`); tests/test_torch_rma_tiles.py runs the kernel's
schedule in Python, tile steps in any order the dependencies allow, so a
table or schedule fault shows on the CPU. The kernel leaves the compute
buffers alone: after a launch its slots, not its whole tensor, are the
plain version's.

JAX's TPU-layout rules are dropped: the DMA granules (``_dma_quantum``),
the 128/sublane divisibility refusal and the rounded pads of
``_rma_layout``. Ghosts are exactly k*r deep on every dim. A mesh whose
ranks sit on more than one card is refused: one launch spans the ranks of
one card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch import _build, device_model
from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, dtype_name, fill_halo, torch_dtype,
)
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.ops.layout import PaddedLayout
from stencil_tpu_torch.ops.sweep_kernel import TAPS_HEADER, tap_table
from stencil_tpu_torch.parallel.mesh import Mesh
from stencil_tpu_torch.parallel.sharded_kernel import strip_box

SOURCE = _build.PACKAGE_DIR / "csrc" / "rma_iterate.cu"
# where the TPU kernel this one replaces is defined (build_rma_iterate)
REPLACES = "stencil_tpu/parallel/rma.py:253"
REPLACES_MODE = {
    # the dynamic walls: rings (per_sh), mirror_dim :465, refresh_unsharded
    # :510
    "rma_iterate+pins": "stencil_tpu/parallel/rma.py:281",
    # the same kernel at dtype=bfloat16 (its dtype taken from the plan)
    "rma_iterate+bf16": "stencil_tpu/parallel/rma.py:264",
}
# the L2 cache of an H100 (50 MiB, ``device_model.H100``): the residency
# budget where no card is asked (a plan made on the CPU); on a card its own
H100_L2_BYTES = device_model.H100.l2_bytes
# neighbour codes of a face with no neighbour (rma_tables): Dirichlet
# ghosts stay as the scatter left them; Neumann ghosts are the rank's own
# mirror, written in the dim's phase
NBR_DIRICHLET = -1
NBR_MIRROR = -2


def l2_budget(device) -> int:
    """The residency budget of one launch on ``device``: its L2 size on a
    CUDA device (``device_model.budgets``), :data:`H100_L2_BYTES`
    elsewhere."""
    if torch.device(device).type == "cuda":
        return device_model.budgets(device).l2_bytes
    return H100_L2_BYTES


@dataclasses.dataclass(frozen=True)
class RmaPlan:
    """One launch's static geometry: each rank's interior ``local_shape``
    padded by ``layout.halo`` = k*r on every side, ``sweeps_per_call``
    sweeps per outer step (``halo`` = sweeps*r, the strips' depth; below
    ``layout.halo`` only for a remainder plan, :meth:`with_sweeps`),
    ``num_buffers`` padded blocks per rank, the walls: ``periodic`` and
    ``neumann`` per grid dim (Dirichlet where both are False), and the
    kernel's ``tile`` of each rank's interior (:func:`choose_rma_tile`)."""

    spec: StencilSpec
    local_shape: Tuple[int, ...]
    dtype: str
    mesh_shape: Tuple[int, ...]
    sweeps_per_call: int
    layout: PaddedLayout
    num_buffers: int
    periodic: Tuple[bool, ...]
    neumann: Tuple[bool, ...]
    tile: Tuple[int, ...]

    @property
    def interior_shape(self) -> Tuple[int, ...]:
        return self.local_shape

    @property
    def halo(self) -> int:
        return self.sweeps_per_call * self.spec.radius

    @property
    def block_shape(self) -> Tuple[int, ...]:
        return self.layout.padded_shape

    @property
    def sharded_dims(self) -> Tuple[int, ...]:
        return tuple(range(len(self.mesh_shape)))

    @property
    def ranks(self) -> int:
        return math.prod(self.mesh_shape)

    @property
    def num_compute_bufs(self) -> int:
        """Buffers sweeps 1..k-1 write (JAX's ``num_compute_bufs``): none
        at k=1, one at k=2, two beyond."""
        k = self.sweeps_per_call
        return 0 if k == 1 else (1 if k == 2 else 2)

    @property
    def itemsize(self) -> int:
        return torch_dtype(self.dtype).itemsize

    @property
    def buffer_shape(self) -> Tuple[int, ...]:
        """The shape of the tensor one launch runs on: every rank's
        buffers."""
        return (self.ranks, self.num_buffers) + self.layout.padded_shape

    @property
    def resident_bytes(self) -> int:
        """The bytes the budget counts: every buffer of every rank, as
        JAX counts its VMEM (the admission rule)."""
        return math.prod(self.buffer_shape) * self.itemsize

    @property
    def live_bytes(self) -> int:
        """The bytes the kernel really touches: the two slots of every
        rank (the sweeps between run in shared memory)."""
        return 2 * self.ranks * math.prod(self.block_shape) * self.itemsize

    @property
    def dynamic(self) -> bool:
        """Whether any wall is periodic or Neumann."""
        return any(self.periodic) or any(self.neumann)

    @property
    def refresh_dim(self) -> Optional[int]:
        """The unsharded dynamic dim, whose ghosts each step refreshes
        locally, or None: at most one, d1 of a 3D grid on a 1D mesh."""
        nsh = len(self.mesh_shape)
        dims = [d for d in range(nsh, len(self.local_shape))
                if self.periodic[d] or self.neumann[d]]
        return dims[0] if dims else None

    def with_sweeps(self, k: int) -> "RmaPlan":
        """The plan of a launch of ``k`` sweeps per step (a remainder, at
        most this plan's) on the same buffers."""
        if not 1 <= k <= self.sweeps_per_call:
            raise ValueError(f"sweeps {k} outside [1, "
                             f"{self.sweeps_per_call}]")
        return dataclasses.replace(self, sweeps_per_call=k)


def make_rma_plan(spec: StencilSpec, local_shape, dtype="float32",
                  mesh_shape: Tuple[int, ...] = (1,),
                  sweeps_per_call: int = 1,
                  budget: int = H100_L2_BYTES,
                  bc: Optional[DirichletBC] = None,
                  tile: Optional[Tuple[int, ...]] = None) -> RmaPlan:
    """The plan, with JAX's gates and messages (``make_rma_plan``,
    :175-221): a 2D or 3D grid, a 1D or 2D mesh over the leading dims,
    k >= 1, a sharded local extent of at least 2*k*r; then the card's
    budget: every rank's ``2 + num_compute_bufs`` padded blocks, all on one
    card, within ``budget`` (its L2), at the dtype's size. ``bc`` gives the
    walls (None: Dirichlet); a dynamic dim must be a leading one, and an
    unsharded one at least k*r deep (the gates of
    :meth:`RmaStencil.iterate` say so in JAX's words first). ``tile``
    overrides :func:`choose_rma_tile`'s tile."""
    if spec.ndim not in (2, 3):
        raise ValueError("rma kernel supports 2D and 3D grids")
    ndim = spec.ndim
    if len(local_shape) != ndim:
        raise ValueError("local_shape rank must match spec.ndim")
    if not 1 <= len(mesh_shape) <= min(2, ndim):
        raise ValueError("mesh must be 1D or 2D over the leading grid dims")
    if sweeps_per_call < 1:
        raise ValueError("sweeps_per_call must be >= 1")
    kr = sweeps_per_call * spec.radius
    for d in range(len(mesh_shape)):
        n = local_shape[d]
        if n < 2 * kr:
            raise ValueError(
                f"sharded dim {d} local size {n} too small: needs >= "
                f"max(push depth {kr}, 2*k*r = {2 * kr})"
            )
    per = bc.periodic_mask(ndim) if bc is not None else (False,) * ndim
    neu = bc.neumann_mask(ndim) if bc is not None else (False,) * ndim
    if per[-1] or neu[-1]:
        raise ValueError("the 'rma' method takes periodic/Neumann walls on "
                         "the leading dims only, not the lane (last) dim")
    for d in range(len(mesh_shape), ndim - 1):
        if (per[d] or neu[d]) and local_shape[d] < kr:
            raise ValueError(f"dynamic unsharded dim {d} ({local_shape[d]}) "
                             f"is shallower than k*r = {kr}")
    k = sweeps_per_call
    itemsize = torch_dtype(dtype).itemsize
    if tile is None:
        tile = choose_rma_tile(local_shape, math.prod(mesh_shape), k,
                               spec.radius, itemsize)
    elif (len(tile) != ndim
          or not all(1 <= t <= n for t, n in zip(tile, local_shape))
          or tile_cost(local_shape, tile, 1, k, spec.radius,
                       itemsize) is None):
        raise ValueError(f"tile {tuple(tile)} does not fit {local_shape} "
                         f"at k*r = {kr}")
    plan = RmaPlan(spec=spec, local_shape=tuple(local_shape), dtype=dtype,
                   mesh_shape=tuple(mesh_shape), sweeps_per_call=k,
                   layout=PaddedLayout.for_halo(local_shape, kr),
                   num_buffers=2 + (0 if k == 1 else (1 if k == 2 else 2)),
                   periodic=tuple(per), neumann=tuple(neu),
                   tile=tuple(tile))
    if plan.resident_bytes > budget:
        B = plan.block_shape
        raise ValueError(
            f"per-device block {B} x{plan.num_buffers} buffers x"
            f"{plan.ranks} ranks on one card = {plan.resident_bytes} B "
            f"exceeds the L2-resident budget {budget}; use the "
            "sharded_pallas method for blocks this large"
        )
    return plan


def strip_boxes(plan: RmaPlan, d: int) -> Tuple[Tuple[tuple, tuple], ...]:
    """The phase-``d`` pushes of every rank, (source box, destination box)
    for the push to the lo neighbour and the one to the hi neighbour: my
    first (last) ``plan.halo`` interior rows into its last (first) ghost
    rows, spanning the launch's padded extent in the earlier sharded and
    the unsharded dims, the interior in the later sharded dims
    (``strip_extent``/``push_desc``, :385-433, the footprint of
    ``sharded_kernel.strip_box``)."""
    nsh = len(plan.mesh_shape)
    h, kr, n = plan.layout.halo, plan.halo, plan.local_shape[d]
    return ((strip_box(plan, nsh, d, h), strip_box(plan, nsh, d, h + n)),
            (strip_box(plan, nsh, d, h + n - kr),
             strip_box(plan, nsh, d, h - kr)))


def refresh_box(plan: RmaPlan, start: int) -> tuple:
    """The local refresh's footprint, ``plan.halo`` rows of the unsharded
    dynamic dim from padded index ``start``: the interior of the sharded
    dims (their ghost bands are what the pushes write), the launch's
    padded extent of the lane (``refresh_unsharded``'s ``span``)."""
    h, kr, nsh = plan.layout.halo, plan.halo, len(plan.mesh_shape)
    return tuple(slice(start, start + kr) if e == plan.refresh_dim
                 else slice(h, h + n) if e < nsh
                 else slice(h - kr, h + n + kr)
                 for e, n in enumerate(plan.local_shape))


def push_bytes_per_step(plan: RmaPlan) -> int:
    """Bytes a mesh-interior rank pushes per outer step: both strips of
    every phase. It depends on the local block only, never on the mesh
    size (``push_bytes_per_step``, :224-250)."""
    strips = [strip_boxes(plan, d)[0][0] for d in plan.sharded_dims]
    return sum(2 * math.prod(s.stop - s.start for s in strip)
               for strip in strips) * plan.itemsize


def _coords(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        rank, i = divmod(rank, n)
        out.append(i)
    return tuple(reversed(out))


def _rank(coords, shape) -> int:
    r = 0
    for i, n in zip(coords, shape):
        r = r * n + i
    return r


@dataclasses.dataclass(frozen=True)
class RmaTables:
    """What one launch of a plan needs per rank, built once in Python and
    walked alike by the kernel and the plain version:

    - ``neighbours[rank][d]``: the (lo, hi) neighbour along sharded dim d,
      wrapping on a periodic dim (a ring), else :data:`NBR_MIRROR` on a
      Neumann face or :data:`NBR_DIRICHLET` on a Dirichlet one;
    - ``strips[d]``: :func:`strip_boxes` of phase d, the same for every
      rank;
    - ``boxes[rank][t-1]``: the region sweep t updates, the interior grown
      by (k-t)*r on each live face: a neighbour's (ring or not), a Neumann
      face, either face of the unsharded dynamic dim. A Dirichlet face is
      never grown."""

    neighbours: Tuple[Tuple[Tuple[int, int], ...], ...]
    strips: Tuple[Tuple[Tuple[tuple, tuple], ...], ...]
    boxes: Tuple[Tuple[tuple, ...], ...]


@functools.lru_cache(maxsize=64)
def rma_tables(plan: RmaPlan) -> RmaTables:
    shape, nsh = plan.mesh_shape, len(plan.mesh_shape)
    h, r, k = plan.layout.halo, plan.spec.radius, plan.sweeps_per_call
    neighbours, boxes = [], []
    for rank in range(plan.ranks):
        c = _coords(rank, shape)
        nbrs = []
        for d in range(nsh):
            lo_hi = []
            for step, edge in ((-1, 0), (1, shape[d] - 1)):
                if c[d] != edge or plan.periodic[d]:
                    i = (c[d] + step) % shape[d]
                    lo_hi.append(_rank(c[:d] + (i,) + c[d + 1:], shape))
                else:
                    lo_hi.append(NBR_MIRROR if plan.neumann[d]
                                 else NBR_DIRICHLET)
            nbrs.append(tuple(lo_hi))
        neighbours.append(tuple(nbrs))
        live = [code != NBR_DIRICHLET for lo_hi in nbrs for code in lo_hi]
        live += [d == plan.refresh_dim
                 for d in range(nsh, len(plan.local_shape)) for _ in (0, 1)]
        rank_boxes = []
        for t in range(1, k + 1):
            ext = (k - t) * r
            rank_boxes.append(tuple(
                slice(h - (ext if live[2 * d] else 0),
                      h + n + (ext if live[2 * d + 1] else 0))
                for d, n in enumerate(plan.local_shape)))
        boxes.append(tuple(rank_boxes))
    return RmaTables(neighbours=tuple(neighbours),
                     strips=tuple(strip_boxes(plan, d)
                                  for d in plan.sharded_dims),
                     boxes=tuple(boxes))


class Copy(NamedTuple):
    """One copy of a phase: ``src`` of rank ``src_rank`` into ``dst`` of
    rank ``dst_rank``, in the step's input slot, flipped along dim ``flip``
    (a mirror) or not (None). ``kind`` is "push", "mirror" or "wrap"."""

    src_rank: int
    src: tuple
    dst_rank: int
    dst: tuple
    flip: Optional[int]
    kind: str


@functools.lru_cache(maxsize=64)
def phase_copies(plan: RmaPlan) -> Tuple[Tuple[Copy, ...], ...]:
    """Every copy of a step's phases in order: the local refresh of the
    unsharded dynamic dim (where there is one), then one phase per sharded
    dim. No copy of a phase reads a cell another copy of it writes, and no
    two write one cell, so their order within the phase is free (the
    kernel runs them at once)."""
    h, kr = plan.layout.halo, plan.halo
    tables = rma_tables(plan)
    phases = []
    rd = plan.refresh_dim
    if rd is not None:
        n = plan.local_shape[rd]
        lo, hi = refresh_box(plan, h - kr), refresh_box(plan, h + n)
        if plan.periodic[rd]:  # ghost rows <- the far interior rows
            pairs = ((refresh_box(plan, h + n - kr), lo, None),
                     (refresh_box(plan, h), hi, None))
        else:  # ghost layer j <- interior layer j-1
            pairs = ((refresh_box(plan, h), lo, rd),
                     (refresh_box(plan, h + n - kr), hi, rd))
        phases.append(tuple(
            Copy(rank, src, rank, dst, flip,
                 "mirror" if flip is not None else "wrap")
            for rank in range(plan.ranks) for src, dst, flip in pairs))
    for d, ((src_lo, dst_lo), (src_hi, dst_hi)) in enumerate(tables.strips):
        copies = []
        for rank in range(plan.ranks):
            lo, hi = tables.neighbours[rank][d]
            for to, src, dst, mirror in ((lo, src_lo, dst_lo, dst_hi),
                                         (hi, src_hi, dst_hi, dst_lo)):
                if to >= 0:
                    copies.append(Copy(rank, src, to, dst, None, "push"))
                elif to == NBR_MIRROR:  # my own ghosts on that side
                    copies.append(Copy(rank, src, rank, mirror, d,
                                       "mirror"))
        phases.append(tuple(copies))
    return tuple(phases)


def buffer_of(plan: RmaPlan, t: int, slot: int) -> int:
    """The buffer index (of ``num_buffers``) that sweep ``t`` of a step
    writes, ``t = 0`` naming the step's input: the input slot, the compute
    buffers for t = 1..k-1 (JAX's ``write_buf``), the other slot for
    t = k."""
    if t == 0:
        return slot
    if t == plan.sweeps_per_call:
        return 1 - slot
    return 2 + (t - 1) % plan.num_compute_bufs


def exchange_reference(buffers: torch.Tensor, plan: RmaPlan,
                       slot: int) -> List[int]:
    """The phases of one step in the plain version (:func:`phase_copies`),
    into slot ``slot``: the local refresh, then each sharded dim's pushes
    and mirrors. Returns the number of values each rank pushed."""
    pushed = [0] * plan.ranks
    for phase in phase_copies(plan):
        for cp in phase:
            v = buffers[(cp.src_rank, slot) + cp.src]
            if cp.flip is not None:
                v = torch.flip(v, (cp.flip,))
            buffers[(cp.dst_rank, slot) + cp.dst].copy_(v)
            if cp.kind == "push":
                pushed[cp.src_rank] += v.numel()
    return pushed


def rma_iterate_reference(buffers: torch.Tensor, plan: RmaPlan,
                          n_steps: int, slot: int = 0) -> torch.Tensor:
    """Plain version of one launch: ``n_steps`` outer steps of every rank on
    ``buffers`` (``plan.buffer_shape``) in place, the first reading slot
    ``slot``: per step :func:`exchange_reference`, then k eager sweeps per
    rank over its update boxes (``eager.apply_spec``, the kernels' tap
    order, in the buffers' dtype). Returns ``buffers``; the result lies in
    slot ``(slot + n_steps) % 2``."""
    tables = rma_tables(plan)
    r = plan.spec.radius
    for step in range(n_steps):
        s = (slot + step) % 2
        exchange_reference(buffers, plan, s)
        for t in range(1, plan.sweeps_per_call + 1):
            src, dst = buffer_of(plan, t - 1, s), buffer_of(plan, t, s)
            for rank in range(plan.ranks):
                box = tables.boxes[rank][t - 1]
                grown = tuple(slice(b.start - r, b.stop + r) for b in box)
                eager.apply_spec(buffers[rank, src][grown], plan.spec,
                                 halo=r, out=buffers[rank, dst][box])
    return buffers


# ---- the tiled schedule (csrc/rma_iterate.cu) ------------------------------

# the tile rule respects the card's limits (``device_model.budgets()``, an
# H100's on the CPU): shared memory per block (227 KB on an H100, this
# name's) and per SM (228 KB, 1 KB of it reserved per block), the SM count,
# the threads per SM over the kernel's threads per block
SHARED_PER_BLOCK = device_model.H100.smem_per_block
THREADS = 1024
# the tile rule's cost of one step, in ns (choose_rma_tile): per window
# cell loaded, per cell updated over the k sweeps, per wave of resident
# tiles (the wait on the flags, the barriers, the latency of a tile);
# fitted on an H100 by ``tile_sweep.py --rma --fit`` to
# data/rma_tiles_h100_fit.csv
RMA_TILE_CONSTANTS = (0.1355, 0.3131, 4162.0)


def tile_candidates(n: int) -> List[int]:
    """A dim's tile extents: the powers of two below ``n``, and ``n``."""
    out, t = [n], 1
    while t < n:
        out.append(t)
        t *= 2
    return sorted(set(out))


def shared_bytes(tile, ranks: int, k: int, kr: int, itemsize: int) -> int:
    """One block's shared memory (rma_iterate.cu): two copies of the
    window (the tile grown by ``kr``), then every rank's update boxes."""
    window = 2 * math.prod(t + 2 * kr for t in tile) * itemsize
    return -(-window // 16) * 16 + 4 * 6 * ranks * k


def tile_features(local_shape, tile, ranks: int, k: int, r: int,
                  itemsize: int,
                  budgets: Optional[device_model.Budgets] = None
                  ) -> Optional[Tuple[int, int, int]]:
    """What one step costs with ``tile`` (one extent per grid dim), or
    None where its window does not fit a block's shared memory (of
    ``budgets``, by default the card's): m = ceil(tiles / SMs) tiles per
    SM, resident ``bps`` at a time, each loading
    its window (the tile grown by k*r: W cells) and updating the tile
    grown by (k-t)*r at sweep t (C cells over the k sweeps), a row of the
    last dim counted as whole warps of 32 cells. Returns (ceil(m / bps),
    m * W, m * C)."""
    def cells(grow):
        *rows, width = (t + 2 * grow for t in tile)
        return math.prod(rows) * -(-width // 32) * 32

    b = budgets or device_model.budgets()
    kr = k * r
    shared = shared_bytes(tile, ranks, k, kr, itemsize)
    if shared > b.smem_per_block:
        return None
    bps = min(b.threads_per_sm // THREADS,
              b.smem_per_sm // (shared + b.smem_reserved))
    tiles = ranks * math.prod(-(-n // t) for n, t in zip(local_shape, tile))
    m = -(-tiles // b.sm_count)
    swept = sum(cells((k - s) * r) for s in range(1, k + 1))
    return -(-m // bps), m * cells(kr), m * swept


def tile_cost(local_shape, tile, ranks: int, k: int, r: int, itemsize: int,
              constants=RMA_TILE_CONSTANTS,
              budgets: Optional[device_model.Budgets] = None
              ) -> Optional[float]:
    """The rule's estimate of one step's ns with ``tile``, or None where it
    does not fit: ``constants`` (a, b, c) weigh :func:`tile_features`,
    c * ceil(m / bps) + a * m * W + b * m * C."""
    f = tile_features(local_shape, tile, ranks, k, r, itemsize,
                      budgets=budgets)
    if f is None:
        return None
    a, b, c = constants
    return c * f[0] + a * f[1] + b * f[2]


def choose_rma_tile(local_shape, ranks: int, k: int, r: int, itemsize: int,
                    constants=RMA_TILE_CONSTANTS) -> Tuple[int, ...]:
    """The tile of least :func:`tile_cost` among every product of
    :func:`tile_candidates` whose window fits (ties: the larger tile)."""
    b = device_model.budgets()
    best = None
    for tile in itertools.product(*map(tile_candidates, local_shape)):
        cost = tile_cost(local_shape, tile, ranks, k, r, itemsize,
                         constants, b)
        if cost is not None:
            key = (cost, -math.prod(tile))
            if best is None or key < best[0]:
                best = (key, tile)
    if best is None:
        raise ValueError(f"no rma tile of {tuple(local_shape)} fits "
                         f"{b.smem_per_block} B of shared memory at k*r = "
                         f"{k * r}")
    return best[1]


def ghost_map(plan: RmaPlan) -> Tuple[np.ndarray, np.ndarray]:
    """What one step's exchange (:func:`phase_copies`) amounts to: every
    ghost cell it writes, as a flat index ``rank * block + offset`` into
    one slot of every rank, beside the cell whose value it ends up holding
    (the refresh, the pushes, the rings and the mirrors in order, corners
    riding through earlier phases): :func:`exchange_reference` run on the
    cells' own indices. Raises if a source is itself written (the pairs
    could then not all be applied at once)."""
    return _ghost_map(plan)


@functools.lru_cache(maxsize=64)
def _ghost_map(plan: RmaPlan) -> Tuple[np.ndarray, np.ndarray]:
    block = math.prod(plan.block_shape)
    ids = torch.arange(plan.ranks * block, dtype=torch.int64).reshape(
        (plan.ranks, 1) + plan.block_shape)
    exchange_reference(ids, plan, 0)
    flat = ids.reshape(-1).numpy()
    dst = np.nonzero(flat != np.arange(flat.size))[0]
    src = flat[dst]
    if np.isin(src, dst).any():
        raise AssertionError("an exchange source is itself written")
    return dst, src


@dataclasses.dataclass(frozen=True)
class RmaTiles:
    """The tiled schedule of one launch plan, the same every step. Tile
    ``i`` of ``ntiles`` (rank-major, then the tile grid ``grid`` in C
    order) owns ``tile`` interior cells per dim (fewer in a ragged last
    tile) from ``lo[i]`` to ``hi[i]`` (padded coordinates) and loads its
    window, ``lo - plan.halo`` to ``hi + plan.halo``, into shared memory of
    row pitch ``pitch`` (the tile grown by k*r). Per tile, in CSR form
    (``*_ptr[i]:*_ptr[i+1]``):

    - ``pairs``: the ghost-map pairs it writes after its level k, (flat
      destination, flat source, the source's index in its window or -1):
      a source in its interior (the value in shared memory), or a source
      no tile writes (a Dirichlet ghost a strip carries; index -1, read
      from the output slot), given to the destination's rank's tile
      nearest the destination;
    - ``deps``: the tiles whose writes (interior or pairs) meet its window,
      and those whose window meets its writes, itself excluded: the read-
      after-write hazards between one step and the next, and the write-
      after-read ones on the ping-pong slot. The relation is symmetric."""

    grid: Tuple[int, ...]
    tile: Tuple[int, ...]
    pitch: Tuple[int, ...]
    lo: np.ndarray          # [ntiles, ndim]
    hi: np.ndarray
    rank: np.ndarray        # [ntiles]
    pair_ptr: np.ndarray    # [ntiles + 1]
    pairs: np.ndarray       # [npairs, 3]
    dep_ptr: np.ndarray     # [ntiles + 1]
    deps: np.ndarray        # [ndeps]
    shared_bytes: int       # one block's (:func:`shared_bytes`)

    @property
    def ntiles(self) -> int:
        return len(self.rank)

    @property
    def waits_per_step(self) -> int:
        """Flags all tiles wait on in one step (each a dependency)."""
        return len(self.deps)



def _csr(owner: np.ndarray, rows: np.ndarray, n: int):
    order = np.argsort(owner, kind="stable")
    ptr = np.zeros(n + 1, np.int64)
    np.add.at(ptr, owner + 1, 1)
    return np.cumsum(ptr), rows[order]


@functools.lru_cache(maxsize=64)
def rma_tiles(plan: RmaPlan) -> RmaTiles:
    h, kr = plan.layout.halo, plan.halo
    n = np.asarray(plan.local_shape)
    T = np.asarray(plan.tile)
    grid = tuple(int(v) for v in -(-n // T))
    per_rank = math.prod(grid)
    ntiles = plan.ranks * per_rank
    idx = np.stack(np.unravel_index(np.arange(per_rank), grid), axis=1)
    lo = np.tile(h + idx * T, (plan.ranks, 1))
    hi = np.minimum(lo + T, h + n)
    rank = np.repeat(np.arange(plan.ranks), per_rank)
    pitch = tuple(int(t) + 2 * kr for t in T)

    def tile_of(r, coords):
        """The tile of rank(s) ``r`` holding interior cell(s) ``coords``."""
        j = (coords - h) // T
        return r * per_rank + np.ravel_multi_index(tuple(j.T), grid)

    dst, src = ghost_map(plan)
    block = math.prod(plan.block_shape)
    s_rank, s_off = np.divmod(src, block)
    d_rank, d_off = np.divmod(dst, block)
    s_c = np.stack(np.unravel_index(s_off, plan.block_shape), axis=1)
    d_c = np.stack(np.unravel_index(d_off, plan.block_shape), axis=1)
    inside = ((s_c >= h) & (s_c < h + n)).all(axis=1)
    owner = np.where(inside, tile_of(s_rank, np.clip(s_c, h, h + n - 1)),
                     tile_of(d_rank, np.clip(d_c, h, h + n - 1)))
    wlo = lo[owner] - kr
    local = np.where(inside, np.ravel_multi_index(
        tuple(np.clip(s_c - wlo, 0, np.asarray(pitch) - 1).T), pitch), -1)
    pair_ptr, pairs = _csr(owner, np.stack([dst, src, local], axis=1),
                           ntiles)

    # read-after-write and write-after-read: a tile's writes meet another's
    # window. Interiors against windows: per dim the tile indices within
    # reach; ghost-map destinations against windows: per dim the tiles
    # whose window spans the destination's coordinate.
    edges = []
    reach = [int(-(-kr // t)) for t in T]
    for off in itertools.product(*(range(-q, q + 1) for q in reach)):
        j = idx + np.asarray(off)
        ok = ((j >= 0) & (j < np.asarray(grid))).all(axis=1)
        if not any(off) or not ok.any():
            continue
        a = np.nonzero(ok)[0]
        b = np.ravel_multi_index(tuple(j[ok].T), grid)
        for r_ in range(plan.ranks):
            edges.append(np.stack([a + r_ * per_rank, b + r_ * per_rank],
                                  axis=1))
    u = d_c - h
    jlo = np.maximum(0, np.floor_divide(u - kr, T))
    jhi = np.minimum(np.asarray(grid) - 1, np.floor_divide(u + kr, T))
    span = int((jhi - jlo).max(initial=0)) + 1
    for off in itertools.product(*(range(span) for _ in plan.local_shape)):
        j = jlo + np.asarray(off)
        ok = (j <= jhi).all(axis=1) & (u - kr < n).all(axis=1)
        if ok.any():
            reader = d_rank[ok] * per_rank + np.ravel_multi_index(
                tuple(j[ok].T), grid)
            edges.append(np.stack([owner[ok], reader], axis=1))
    e = np.concatenate(edges + [np.zeros((0, 2), np.int64)])
    e = np.concatenate([e, e[:, ::-1]])
    e = np.unique(e[e[:, 0] != e[:, 1]], axis=0)
    dep_ptr, deps = _csr(e[:, 0], e[:, 1], ntiles)
    return RmaTiles(grid=grid, tile=tuple(int(t) for t in T), pitch=pitch,
                    lo=lo, hi=hi, rank=rank, pair_ptr=pair_ptr, pairs=pairs,
                    dep_ptr=dep_ptr, deps=deps,
                    shared_bytes=shared_bytes(
                        plan.tile, plan.ranks, plan.sweeps_per_call, kr,
                        plan.itemsize))


# the host geometry's layout (_geometry, rma_iterate.cu's kGeomLen)
GEOM_LEN = 33


def _geometry(plan: RmaPlan, n_steps: int, slot: int) -> np.ndarray:
    """The host int32 geometry of a launch, in 3D (a 2D plan gains a
    leading dim of 1, with no tile, halo or radius): R, nbuf, P0 P1 P2, k,
    the steps, the first slot, the tile count; per dim the tile extent,
    the tile grid, the layout's halo, the launch's halo k*r, the interior
    extent and the radius; the pair and dependency counts; then the
    offsets in :func:`device_table` of the pair pointers, the pairs, the
    dependency pointers and the dependencies (the boxes at 0)."""
    tiles = rma_tiles(plan)
    lead = 3 - len(plan.local_shape)

    def per_dim(vals, pad):
        return [pad] * lead + list(vals)

    nd = len(plan.local_shape)
    k = plan.sweeps_per_call
    boxes = plan.ranks * k * 6
    geom = [plan.ranks, plan.num_buffers,
            *per_dim(plan.layout.padded_shape, 1), k, n_steps, slot,
            tiles.ntiles, *per_dim(tiles.tile, 1), *per_dim(tiles.grid, 1),
            *per_dim([plan.layout.halo] * nd, 0),
            *per_dim([plan.halo] * nd, 0), *per_dim(plan.local_shape, 1),
            *per_dim([plan.spec.radius] * nd, 0), len(tiles.pairs),
            len(tiles.deps), boxes, boxes + tiles.ntiles + 1,
            boxes + tiles.ntiles + 1 + 3 * len(tiles.pairs),
            boxes + 2 * (tiles.ntiles + 1) + 3 * len(tiles.pairs)]
    assert len(geom) == GEOM_LEN
    return np.asarray(geom, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def device_table(plan: RmaPlan, device: torch.device) -> torch.Tensor:
    """The int32 table the kernel reads from device memory, built once per
    plan and device (a launch copies nothing from the host): each rank's
    update boxes [R][k][start0..2, size0..2] in 3D padded coordinates, the
    pair pointers [ntiles+1], the pairs [npairs][3] (destination and
    source as ``rank * nbuf * block + offset`` in buffer 0 of the rank,
    the source's window index or -1), the dependency pointers [ntiles+1]
    and the dependencies."""
    tables, tiles = rma_tables(plan), rma_tiles(plan)
    lead = 3 - len(plan.local_shape)
    block = math.prod(plan.block_shape)
    if plan.ranks * plan.num_buffers * block >= 2 ** 31:
        raise ValueError("the buffers exceed an int32 index")

    def six(box):
        return ([0] * lead + [b.start for b in box]
                + [1] * lead + [b.stop - b.start for b in box])

    boxes = [v for rank in tables.boxes for box in rank for v in six(box)]
    pairs = tiles.pairs.copy()
    for c in (0, 1):
        rank, off = np.divmod(pairs[:, c], block)
        pairs[:, c] = rank * plan.num_buffers * block + off
    table = np.concatenate([np.asarray(boxes, np.int64), tiles.pair_ptr,
                            pairs.reshape(-1), tiles.dep_ptr, tiles.deps])
    return torch.from_numpy(table.astype(np.int32)).to(device)


class RmaKernel:
    """The hand-written kernel ``csrc/rma_iterate.cu``: its build, its
    wrapper (``kernel(buffers, plan, n_steps, slot=0)``) and its counts of
    launches: ``launches``, and again ``pins_launches`` for a plan with a
    periodic or Neumann wall and ``bf16_launches`` for a bfloat16 plan
    (plain-version calls do not count)."""

    name = "rma_iterate"
    ENTRIES = {"float32": "rma_iterate_f32", "bfloat16": "rma_iterate_bf16"}

    def __init__(self):
        self.source = SOURCE
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = 0
        self.pins_launches = 0
        self.bf16_launches = 0

    def build(self) -> _build.BuildResult:
        """Compile the source (cached by content). Raises
        ``_build.BuildError`` with the compiler's stderr on failure."""
        return _build.build(_build.find_nvcc(), [self.source],
                            _build.NVCC_FLAGS, self.name,
                            headers=[TAPS_HEADER])

    @functools.cached_property
    def _entries(self):
        lib = ctypes.CDLL(str(self.build().path))
        P, I = ctypes.c_void_p, ctypes.c_int
        entries = {}
        for dtype, name in self.ENTRIES.items():
            fn = getattr(lib, name)
            fn.restype = I
            # buffers, flags, device table (device); geometry int32 (host)
            # and its length; the tap table (host): offsets [ntaps*3],
            # group sizes, group weights, ntaps, ngroups, uniform, uniform
            # weight; device, stream
            fn.argtypes = [P, P, P, P, I, P, P, P, I, I, I, ctypes.c_float,
                           I, P]
            entries[dtype] = fn
        err = lib.rma_iterate_error
        err.restype = ctypes.c_char_p
        err.argtypes = [I]
        return entries, err

    def library(self):
        """Build and load the library; returns its float32 C entry."""
        return self._entries[0]["float32"]

    @staticmethod
    def check(buffers: torch.Tensor, plan: RmaPlan, n_steps: int,
              slot: int) -> None:
        if buffers.dtype != torch_dtype(plan.dtype):
            raise ValueError(f"buffers dtype {dtype_name(buffers.dtype)} != "
                             f"plan dtype {plan.dtype}")
        if tuple(buffers.shape) != plan.buffer_shape:
            raise ValueError(f"buffers shape {tuple(buffers.shape)} != "
                             f"{plan.buffer_shape}")
        if not buffers.is_contiguous():
            raise ValueError("buffers must be contiguous")
        if n_steps < 1 or slot not in (0, 1):
            raise ValueError(f"n_steps {n_steps} >= 1 and slot {slot} in "
                             "(0, 1)")

    def __call__(self, buffers: torch.Tensor, plan: RmaPlan, n_steps: int,
                 slot: int = 0) -> torch.Tensor:
        """``n_steps`` outer steps of every rank in one launch, on
        ``buffers`` in place, the first step reading slot ``slot``; the
        result lies in slot ``(slot + n_steps) % 2``. Returns ``buffers``.

        A CUDA tensor launches the kernel's entry for ``plan.dtype``
        (float32 or bfloat16) on the current stream (no synchronisation),
        its tiles' flags in a new int32 tensor, and leaves the compute
        buffers as they were; it raises ``ValueError`` for another dtype
        and ``RuntimeError`` if the build or the cooperative launch fails.
        A CPU tensor runs :func:`rma_iterate_reference`."""
        self.check(buffers, plan, n_steps, slot)
        if buffers.device.type == "cpu":
            return rma_iterate_reference(buffers, plan, n_steps, slot)
        if buffers.device.type != "cuda":
            raise ValueError(f"{self.name} runs on cuda (or cpu for the "
                             f"plain version), not {buffers.device}")
        if plan.dtype not in self.ENTRIES:
            raise ValueError(f"{self.name} runs "
                             f"{' or '.join(self.ENTRIES)}, not "
                             f"{plan.dtype}")
        entries, err = self._entries
        offsets, sizes, weights, uniform, uw = tap_table(plan.spec,
                                                         plan.dtype)
        lead = 3 - len(plan.local_shape)
        offsets = np.ascontiguousarray(np.concatenate(
            [np.zeros((len(offsets) // plan.spec.ndim, lead), np.int32),
             offsets.reshape(-1, plan.spec.ndim)], axis=1).reshape(-1))
        geom = _geometry(plan, n_steps, slot)
        table = device_table(plan, buffers.device)
        # the tiles' epochs, zeroed by the launch on its stream
        flags = torch.empty(rma_tiles(plan).ntiles, dtype=torch.int32,
                            device=buffers.device)
        device = buffers.device.index if buffers.device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = entries[plan.dtype](
            buffers.data_ptr(), flags.data_ptr(), table.data_ptr(),
            geom.ctypes.data, len(geom), offsets.ctypes.data,
            sizes.ctypes.data,
            weights.ctypes.data, len(offsets) // 3, len(sizes), int(uniform),
            uw, device, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed ({rc}): "
                               f"{err(rc).decode()}")
        self.launches += 1
        self.pins_launches += plan.dynamic
        self.bf16_launches += plan.dtype == "bfloat16"
        return buffers


rma_iterate = RmaKernel()


@dataclasses.dataclass(frozen=True)
class RmaStencil:
    """Distributed Jacobi iteration with every rank's blocks resident for a
    whole iterate and the halos pushed inside one launch: leading-dim
    sharding over a 1D or 2D mesh (its axes in order shard d0, d1) whose
    ranks share one card, ``sweeps_per_call`` sweeps per exchange."""

    spec: StencilSpec
    interior_shape: Tuple[int, ...]
    dtype: str = "float32"
    sweeps_per_call: int = 1

    def local_plan(self, mesh_shape, sweeps: Optional[int] = None,
                   budget: int = H100_L2_BYTES,
                   bc: Optional[DirichletBC] = None) -> RmaPlan:
        """The per-rank plan (``local_plan``, :800-813): each sharded dim
        must divide its mesh axis. ``bc`` gives the walls."""
        local = list(self.interior_shape)
        for d, n_dev in enumerate(mesh_shape):
            if local[d] % n_dev:
                raise ValueError(
                    f"grid dim {d} ({local[d]}) not divisible by mesh "
                    f"axis size {n_dev}"
                )
            local[d] //= n_dev
        return make_rma_plan(
            self.spec, tuple(local), self.dtype, tuple(mesh_shape),
            self.sweeps_per_call if sweeps is None else sweeps, budget, bc)

    def plan_for(self, mesh: Mesh,
                 bc: Optional[DirichletBC] = None) -> RmaPlan:
        """The plan on ``mesh``, whose ranks must share one device; the
        budget is that device's L2."""
        devices = tuple(dict.fromkeys(mesh.devices))
        if len(devices) > 1:
            raise ValueError(
                f"the rma method runs one launch over the ranks of one "
                f"card; this mesh spans {len(devices)} devices (rma across "
                "cards is not ported yet, ROADMAP)")
        return self.local_plan(mesh.shape, budget=l2_budget(devices[0]),
                               bc=bc)

    def _block(self, mesh: Mesh, plan: RmaPlan, rank: int) -> tuple:
        """The slice of the global interior that ``rank`` holds."""
        coords = mesh.coords(rank) + (0,) * (
            len(self.interior_shape) - len(mesh.shape))
        return tuple(slice(i * n, (i + 1) * n)
                     for i, n in zip(coords, plan.local_shape))

    def scatter(self, grid: HaloGrid, mesh: Mesh,
                plan: RmaPlan) -> torch.Tensor:
        """Every rank's blocks as one tensor on the mesh's device, every
        buffer of a rank holding its window of the global grid padded by
        k*r in the golden's order (``core/grid.py:fill_halo``: Dirichlet
        faces first, later dims winning in their corners, then the dynamic
        dims wrapped or mirrored over the full extent): JAX's initial load
        into every buffer (:356-364), with the golden's corners.

        The window, not the rank's own block padded alone: a ghost cell
        on a Dirichlet face of one dim that lies in a live ghost band of
        another (a corner) holds the Dirichlet face's value in the global
        grid. No sweep writes it (Dirichlet faces are never grown), so
        every buffer must hold it right from the start (the module
        docstring lists these cells)."""
        kr = plan.layout.halo
        padded = torch.empty(tuple(n + 2 * kr for n in self.interior_shape),
                             dtype=grid.dtype, device=mesh.devices[0])
        padded[tuple(slice(kr, kr + n) for n in self.interior_shape)] = \
            grid.interior().to(mesh.devices[0])
        fill_halo(padded, kr, grid.bc)
        buffers = torch.empty(plan.buffer_shape, dtype=grid.dtype,
                              device=mesh.devices[0])
        for rank in range(mesh.size):
            window = tuple(slice(s.start, s.stop + 2 * kr)
                           for s in self._block(mesh, plan, rank))
            buffers[rank].copy_(padded[window].expand(
                plan.num_buffers, *plan.block_shape))
        return buffers

    def gather(self, buffers: torch.Tensor, slot: int, mesh: Mesh,
               plan: RmaPlan, grid: HaloGrid) -> HaloGrid:
        """Slot ``slot``'s interiors as a new grid like ``grid``."""
        out = torch.empty(tuple(self.interior_shape), dtype=grid.dtype,
                          device=grid.device)
        for rank in range(mesh.size):
            out[self._block(mesh, plan, rank)] = plan.layout.unpad(
                buffers[rank, slot]).to(out.device)
        return HaloGrid.from_interior(out, halo=grid.halo, bc=grid.bc,
                                      device=grid.device)

    def iterate(self, grid: HaloGrid, iterations: int, mesh: Mesh
                ) -> HaloGrid:
        """``iterations`` sweeps of ``grid`` over ``mesh``: one launch of
        ``iterations // k`` outer steps and one launch of the remainder,
        on buffers scattered and gathered once. ``grid`` is unchanged; the
        result lies on ``grid``'s device. Dynamic walls take JAX's gates
        and messages (:830-871)."""
        if grid.dtype != torch_dtype(self.dtype):
            raise ValueError(
                f"grid dtype {dtype_name(grid.dtype)} != plan dtype "
                f"{self.dtype}; pass dtype= when constructing RmaStencil")
        if grid.bc.any_dynamic:
            ndim = len(grid.interior_shape)
            per = grid.bc.periodic_mask(ndim)
            neu = grid.bc.neumann_mask(ndim)
            kr = self.sweeps_per_call * self.spec.radius
            problems = []
            if per[ndim - 1] or neu[ndim - 1]:
                problems.append(
                    "a periodic/Neumann LANE (last) dim is unsupported "
                    "(use 'xla', or 'pallas_tiled' at -k 1)")
            if self.sweeps_per_call > 1:
                asym = [d for d in range(ndim - 1)
                        if neu[d] and not self.spec.symmetric_in(d)]
                if asym:
                    problems.append(
                        f"Neumann dim(s) {asym} at sweeps_per_call>1 "
                        "need the stencil mirror-symmetric in those "
                        "dims (use -k 1 for asymmetric taps)")
            nsh = len(mesh.shape)
            shallow = [d for d in range(nsh, ndim - 1)
                       if (per[d] or neu[d])
                       and grid.interior_shape[d] < kr]
            if shallow:
                problems.append(
                    f"dynamic unsharded dim(s) {shallow} are shallower "
                    f"than the temporal ghost depth k*r = {kr}")
            if problems:
                raise ValueError(
                    "periodic/Neumann BCs on the 'rma' method: "
                    + "; ".join(problems))
        if grid.interior_shape != tuple(self.interior_shape):
            raise ValueError(f"grid interior {grid.interior_shape} != "
                             f"{tuple(self.interior_shape)}")
        plan = self.plan_for(mesh, grid.bc)
        buffers = self.scatter(grid, mesh, plan)
        n_outer, rem = divmod(iterations, plan.sweeps_per_call)
        slot = 0
        if n_outer:
            rma_iterate(buffers, plan, n_outer, slot)
            slot = n_outer % 2
        if rem:
            rma_iterate(buffers, plan.with_sweeps(rem), 1, slot)
            slot = 1 - slot
        return self.gather(buffers, slot, mesh, plan, grid)
