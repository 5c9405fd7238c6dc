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
- **the blocks never leave the device**: a card's ranks' buffers are one
  tensor ``[R, nbuf, *B]`` in device memory, sized by
  :func:`make_rma_plan` to stay inside the card's L2 (50 MiB on an H100),
  where the TPU kernel's budget was VMEM; each step's k sweeps of a tile
  run in shared memory;
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
``_rma_layout``. Ghosts are exactly k*r deep on every dim.

**Across cards** (JAX's one rank per chip, its strips moved by
``make_async_remote_copy``, :397-433, paced by send and recv semaphores,
:435-463, after one neighbour barrier, :365-383). Each distinct device of
the mesh is a card (:meth:`RmaStencil.plan_for`), rank i on the card of
its device, so ``make_mesh``'s round robin may give a card ranks that are
not neighbours. Each card holds its own ranks' buffers in an allocation
of its own (``[ranks on the card, nbuf, *B]``, the card's ranks in rank
order) within its own L2 budget. The tiles are numbered card by card
(:attr:`RmaPlan.rank_order`); a ghost-map pair is produced on the card of
its source and stored straight into the destination card's allocation; a
dependency between tiles on two cards is a flag the producer publishes
into the waiting card's flag array as well as its own, so that every wait
polls its own card's memory; and one barrier across cards follows the
opening exchange. The kernel runs one cooperative launch per card; every
edge between two cards synchronises at system scope (a tile with waiters
on other cards fences once, then stores its epoch into each array), every
edge within a card at gpu scope. ``virtual_cards=G`` on a mesh of one device
puts rank i on virtual card i % G instead: separate allocations and flag
arrays on that device, every instruction of the real path, in one launch
whose blocks are all co-resident (two launches on one card are not
co-scheduled), the test device of the protocol on one card. A plan of one
card runs what it ran before cards existed (its waits now acquire at
system scope).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

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
    # across cards: the remote copies chip to chip (make_async_remote_copy)
    "rma_iterate+cards": "stencil_tpu/parallel/rma.py:397",
}
# the L2 cache of an H100 (50 MiB, ``device_model.H100``): the residency
# budget where no card is asked (a plan made on the CPU); on a card its own
H100_L2_BYTES = device_model.H100.l2_bytes
# neighbour codes of a face with no neighbour (rma_tables): Dirichlet
# ghosts stay as the scatter left them; Neumann ghosts are the rank's own
# mirror, written in the dim's phase
NBR_DIRICHLET = -1
NBR_MIRROR = -2
# the most cards one plan spans (rma_iterate.cu's kMaxCards: the launch
# parameters hold one buffer and one flag pointer per card)
MAX_CARDS = 16


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
    ``neumann`` per grid dim (Dirichlet where both are False), the
    kernel's ``tile`` of each rank's interior (:func:`choose_rma_tile`),
    the card of each rank (``cards``, numbered from 0, each holding one
    rank or more) and whether the cards are ``virtual``: groups of one
    launch on one device, sharing its L2 and SMs (False on one card)."""

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
    cards: Tuple[int, ...]
    virtual: bool

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
        """Every rank's buffers in one tensor: the tensor a plan of one
        card runs on (:meth:`card_shape` of each card otherwise)."""
        return (self.ranks, self.num_buffers) + self.layout.padded_shape

    @property
    def ncards(self) -> int:
        return max(self.cards) + 1

    @functools.cached_property
    def card_ranks(self) -> Tuple[Tuple[int, ...], ...]:
        """The ranks each card holds, in rank order."""
        return tuple(tuple(r for r, c in enumerate(self.cards) if c == card)
                     for card in range(self.ncards))

    @functools.cached_property
    def places(self) -> Tuple[Tuple[int, int], ...]:
        """(card, index among the card's ranks) of each rank: where its
        buffers lie."""
        return tuple((self.cards[r], self.card_ranks[self.cards[r]].index(r))
                     for r in range(self.ranks))

    @property
    def rank_order(self) -> Tuple[int, ...]:
        """Every rank, card by card: the order of the tiles and of the
        kernel's per-rank tables."""
        return sum(self.card_ranks, ())

    @property
    def device_ranks(self) -> Tuple[int, ...]:
        """The ranks each device holds: all of them on one card or on
        virtual cards, else each card's."""
        if self.virtual or self.ncards == 1:
            return (self.ranks,)
        return tuple(map(len, self.card_ranks))

    def card_shape(self, card: int) -> Tuple[int, ...]:
        """The shape of ``card``'s buffer tensor: its ranks' buffers."""
        return ((len(self.card_ranks[card]), self.num_buffers)
                + self.layout.padded_shape)

    @property
    def on_one_card(self) -> "RmaPlan":
        """The same geometry with every rank on one card."""
        return dataclasses.replace(self, cards=(0,) * self.ranks,
                                   virtual=False)

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
                  budget=H100_L2_BYTES,
                  bc: Optional[DirichletBC] = None,
                  tile: Optional[Tuple[int, ...]] = None,
                  cards: Optional[Sequence[int]] = None,
                  virtual: bool = False) -> RmaPlan:
    """The plan, with JAX's gates and messages (``make_rma_plan``,
    :175-221): a 2D or 3D grid, a 1D or 2D mesh over the leading dims,
    k >= 1, a sharded local extent of at least 2*k*r; then each device's
    budget, as JAX checks each chip's VMEM (``_block_budget``, :96): the
    ``2 + num_compute_bufs`` padded blocks of every rank the device holds
    (:attr:`RmaPlan.device_ranks`), at the dtype's size, within
    ``budget`` (its L2; one value for every device, or one per device).
    ``cards`` gives the card of each rank (None: all on card 0) and
    ``virtual`` whether the cards share one device. ``bc`` gives the walls
    (None: Dirichlet); a dynamic dim must be a leading one, and an
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
    ranks = math.prod(mesh_shape)
    cards = (0,) * ranks if cards is None else tuple(int(c) for c in cards)
    ncards = max(cards, default=0) + 1
    if len(cards) != ranks or set(cards) != set(range(ncards)):
        raise ValueError(f"card map {cards} does not put {ranks} ranks on "
                         "cards 0, 1, ... each holding one or more")
    if ncards > MAX_CARDS:
        raise ValueError(f"{ncards} cards: the rma kernel spans at most "
                         f"{MAX_CARDS}")
    plan = RmaPlan(spec=spec, local_shape=tuple(local_shape), dtype=dtype,
                   mesh_shape=tuple(mesh_shape), sweeps_per_call=k,
                   layout=PaddedLayout.for_halo(local_shape, kr),
                   num_buffers=2 + (0 if k == 1 else (1 if k == 2 else 2)),
                   periodic=tuple(per), neumann=tuple(neu), tile=(),
                   cards=cards, virtual=bool(virtual) and ncards > 1)
    if tile is None:
        tile = choose_rma_tile(local_shape, max(plan.device_ranks), k,
                               spec.radius, itemsize)
    elif (len(tile) != ndim
          or not all(1 <= t <= n for t, n in zip(tile, local_shape))
          or tile_cost(local_shape, tile, 1, k, spec.radius,
                       itemsize) is None):
        raise ValueError(f"tile {tuple(tile)} does not fit {local_shape} "
                         f"at k*r = {kr}")
    plan = dataclasses.replace(plan, tile=tuple(tile))
    budgets = ((budget,) * len(plan.device_ranks)
               if isinstance(budget, int) else tuple(budget))
    if len(budgets) != len(plan.device_ranks):
        raise ValueError(f"{len(budgets)} budgets for "
                         f"{len(plan.device_ranks)} devices")
    per_rank = plan.resident_bytes // ranks
    for n, limit in zip(plan.device_ranks, budgets):
        if n * per_rank > limit:
            raise ValueError(
                f"per-device block {plan.block_shape} x{plan.num_buffers} "
                f"buffers x{n} ranks on one card = {n * per_rank} B "
                f"exceeds the L2-resident budget {limit}; use the "
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


Buffers = Union[torch.Tensor, Sequence[torch.Tensor]]


def card_parts(buffers: Buffers, plan: RmaPlan) -> List[torch.Tensor]:
    """Each card's buffer tensor: ``buffers`` itself for a plan of one card
    (a tensor of ``plan.buffer_shape``), else one tensor per card
    (:meth:`RmaPlan.card_shape`)."""
    parts = ([buffers] if isinstance(buffers, torch.Tensor)
             else list(buffers))
    if len(parts) != plan.ncards:
        raise ValueError(f"{len(parts)} buffer tensors for {plan.ncards} "
                         "cards")
    return parts


def exchange_reference(buffers: Buffers, plan: RmaPlan,
                       slot: int) -> List[int]:
    """The phases of one step in the plain version (:func:`phase_copies`),
    into slot ``slot`` of each card's buffers (:func:`card_parts`), each
    rank's where :attr:`RmaPlan.places` puts it: the local refresh, then
    each sharded dim's pushes and mirrors. Returns the number of values
    each rank pushed."""
    parts = card_parts(buffers, plan)
    pushed = [0] * plan.ranks
    for phase in phase_copies(plan):
        for cp in phase:
            card, i = plan.places[cp.src_rank]
            v = parts[card][(i, slot) + cp.src]
            if cp.flip is not None:
                v = torch.flip(v, (cp.flip,))
            card, i = plan.places[cp.dst_rank]
            parts[card][(i, slot) + cp.dst].copy_(v)
            if cp.kind == "push":
                pushed[cp.src_rank] += v.numel()
    return pushed


def rma_iterate_reference(buffers: Buffers, plan: RmaPlan, n_steps: int,
                          slot: int = 0) -> Buffers:
    """Plain version of one launch: ``n_steps`` outer steps of every rank on
    ``buffers`` (:func:`card_parts`) in place, the first reading slot
    ``slot``: per step :func:`exchange_reference`, then k eager sweeps per
    rank over its update boxes (``eager.apply_spec``, the kernels' tap
    order, in the buffers' dtype). Returns ``buffers``; the result lies in
    slot ``(slot + n_steps) % 2``."""
    parts = card_parts(buffers, plan)
    tables = rma_tables(plan)
    r = plan.spec.radius
    for step in range(n_steps):
        s = (slot + step) % 2
        exchange_reference(parts, plan, s)
        for t in range(1, plan.sweeps_per_call + 1):
            src, dst = buffer_of(plan, t - 1, s), buffer_of(plan, t, s)
            for rank, (card, i) in enumerate(plan.places):
                box = tables.boxes[rank][t - 1]
                grown = tuple(slice(b.start - r, b.stop + r) for b in box)
                eager.apply_spec(parts[card][i, src][grown], plan.spec,
                                 halo=r, out=parts[card][i, dst][box])
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
    could then not all be applied at once). The map does not depend on
    the cards."""
    return _ghost_map(plan.on_one_card)


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
    ``i`` of ``ntiles`` (ranks in :attr:`RmaPlan.rank_order`, card by card,
    then the tile grid ``grid`` in C order) belongs to rank ``rank[i]`` on
    card ``card[i]`` and owns ``tile`` interior cells per dim (fewer in a
    ragged last tile) from ``lo[i]`` to ``hi[i]`` (padded coordinates); it
    loads its window, ``lo - plan.halo`` to ``hi + plan.halo``, into
    shared memory of row pitch ``pitch`` (the tile grown by k*r). Per
    tile, in CSR form (``*_ptr[i]:*_ptr[i+1]``):

    - ``pairs``: the ghost-map pairs it writes after its level k, (flat
      destination, flat source, the source's index in its window or -1;
      flat as ``rank * block + offset``): a source in its interior (the
      value in shared memory), or a source no tile writes (a Dirichlet
      ghost a strip carries; index -1, read from the output slot), given
      to the destination's rank's tile nearest the destination where the
      source's rank shares the destination's card, else to the source's
      rank's tile nearest the source. So every source lies on its tile's
      card, and a destination may lie on another card;
    - ``deps``: the tiles whose writes (interior or pairs) meet its window,
      and those whose window meets its writes, itself excluded: the read-
      after-write hazards between one step and the next, and the write-
      after-read ones on the ping-pong slot. The relation is symmetric;
    - ``pub``: the other cards whose tiles depend on it, into whose flag
      arrays it publishes its epoch besides its own card's.

    Per card, ``peers[peer_ptr[c]:peer_ptr[c+1]]``: the other cards it
    shares a dependency with, the cards of its barrier after the opening
    exchange."""

    grid: Tuple[int, ...]
    tile: Tuple[int, ...]
    pitch: Tuple[int, ...]
    lo: np.ndarray          # [ntiles, ndim]
    hi: np.ndarray
    rank: np.ndarray        # [ntiles]
    card: np.ndarray        # [ntiles]
    pair_ptr: np.ndarray    # [ntiles + 1]
    pairs: np.ndarray       # [npairs, 3]
    dep_ptr: np.ndarray     # [ntiles + 1]
    deps: np.ndarray        # [ndeps]
    pub_ptr: np.ndarray     # [ntiles + 1]
    pub: np.ndarray         # [npub]
    peer_ptr: np.ndarray    # [ncards + 1]
    peers: np.ndarray       # [npeers]
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
    order = np.asarray(plan.rank_order)
    pos = np.empty(plan.ranks, np.int64)   # each rank's place in order
    pos[order] = np.arange(plan.ranks)
    cards = np.asarray(plan.cards)
    rank = np.repeat(order, per_rank)
    card = cards[rank]
    pitch = tuple(int(t) + 2 * kr for t in T)

    def tile_of(r, coords):
        """The tile of rank(s) ``r`` holding interior cell(s) ``coords``."""
        j = (coords - h) // T
        return pos[r] * per_rank + np.ravel_multi_index(tuple(j.T), grid)

    dst, src = ghost_map(plan)
    block = math.prod(plan.block_shape)
    s_rank, s_off = np.divmod(src, block)
    d_rank, d_off = np.divmod(dst, block)
    s_c = np.stack(np.unravel_index(s_off, plan.block_shape), axis=1)
    d_c = np.stack(np.unravel_index(d_off, plan.block_shape), axis=1)
    inside = ((s_c >= h) & (s_c < h + n)).all(axis=1)
    owner = np.where(inside | (cards[s_rank] != cards[d_rank]),
                     tile_of(s_rank, np.clip(s_c, h, h + n - 1)),
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
            reader = pos[d_rank[ok]] * per_rank + np.ravel_multi_index(
                tuple(j[ok].T), grid)
            edges.append(np.stack([owner[ok], reader], axis=1))
    e = np.concatenate(edges + [np.zeros((0, 2), np.int64)])
    e = np.concatenate([e, e[:, ::-1]])
    e = np.unique(e[e[:, 0] != e[:, 1]], axis=0)
    dep_ptr, deps = _csr(e[:, 0], e[:, 1], ntiles)
    # tile a waits on tile b: b publishes into a's card too where they
    # differ, and the two cards meet at the barrier
    cut = e[card[e[:, 0]] != card[e[:, 1]]]
    pub_ptr, pub = _csr(*np.unique(np.stack(
        [cut[:, 1], card[cut[:, 0]]], axis=1), axis=0).T, ntiles)
    peer_ptr, peers = _csr(*np.unique(np.stack(
        [card[cut[:, 0]], card[cut[:, 1]]], axis=1), axis=0).T,
        plan.ncards)
    return RmaTiles(grid=grid, tile=tuple(int(t) for t in T), pitch=pitch,
                    lo=lo, hi=hi, rank=rank, card=card, pair_ptr=pair_ptr,
                    pairs=pairs, dep_ptr=dep_ptr, deps=deps,
                    pub_ptr=pub_ptr, pub=pub, peer_ptr=peer_ptr,
                    peers=peers,
                    shared_bytes=shared_bytes(
                        plan.tile, max(plan.device_ranks),
                        plan.sweeps_per_call, kr, plan.itemsize))


def cross_card_bytes_per_step(plan: RmaPlan) -> int:
    """The bytes of one step's ghost-map pairs whose destination lies on
    another card than the tile that writes it: what crosses between cards
    per outer step (0 on one card)."""
    tiles = rma_tiles(plan)
    owner_card = np.repeat(tiles.card, np.diff(tiles.pair_ptr))
    dst_card = np.asarray(plan.cards)[
        tiles.pairs[:, 0] // math.prod(plan.block_shape)]
    return int((owner_card != dst_card).sum()) * plan.itemsize


# the host geometry's layout (_geometry, rma_iterate.cu's kGeomLen)
GEOM_LEN = 38 + MAX_CARDS + 1


@functools.lru_cache(maxsize=64)
def _geometry(plan: RmaPlan, n_steps: int, slot: int) -> np.ndarray:
    """The host int32 geometry of a launch, in 3D (a 2D plan gains a
    leading dim of 1, with no tile, halo or radius): R, nbuf, P0 P1 P2, k,
    the steps, the first slot, the tile count; per dim the tile extent,
    the tile grid, the layout's halo, the launch's halo k*r, the interior
    extent and the radius; the pair and dependency counts; the offsets in
    :func:`device_table` of the pair pointers, the pairs, the dependency
    pointers and the dependencies (the boxes at 0); the card count; the
    offsets of the publish pointers, the publish lists, the peer pointers
    and the peers; then per card c the place in :attr:`RmaPlan.rank_order`
    of its first rank, for c = 0..MAX_CARDS (R past the last card)."""
    tiles = rma_tiles(plan)
    lead = 3 - len(plan.local_shape)

    def per_dim(vals, pad):
        return [pad] * lead + list(vals)

    nd = len(plan.local_shape)
    k = plan.sweeps_per_call
    sizes = [plan.ranks * k * 6, tiles.ntiles + 1, 4 * len(tiles.pairs),
             tiles.ntiles + 1, len(tiles.deps), tiles.ntiles + 1,
             len(tiles.pub), plan.ncards + 1]
    offsets = np.cumsum(sizes).tolist()
    first = np.cumsum([0] + [len(g) for g in plan.card_ranks]).tolist()
    geom = [plan.ranks, plan.num_buffers,
            *per_dim(plan.layout.padded_shape, 1), k, n_steps, slot,
            tiles.ntiles, *per_dim(tiles.tile, 1), *per_dim(tiles.grid, 1),
            *per_dim([plan.layout.halo] * nd, 0),
            *per_dim([plan.halo] * nd, 0), *per_dim(plan.local_shape, 1),
            *per_dim([plan.spec.radius] * nd, 0), len(tiles.pairs),
            len(tiles.deps), *offsets[:4], plan.ncards, *offsets[4:],
            *first, *[plan.ranks] * (MAX_CARDS + 1 - len(first))]
    assert len(geom) == GEOM_LEN
    geom = np.asarray(geom, dtype=np.int32)
    geom.flags.writeable = False   # cached: one array per launch shape
    return geom


@functools.lru_cache(maxsize=64)
def _taps(plan: RmaPlan):
    """The tap table of ``plan`` as the kernel takes it (``tap_table``,
    the offsets widened to 3D), built once per plan."""
    offsets, sizes, weights, uniform, uw = tap_table(plan.spec, plan.dtype)
    lead = 3 - len(plan.local_shape)
    offsets = np.ascontiguousarray(np.concatenate(
        [np.zeros((len(offsets) // plan.spec.ndim, lead), np.int32),
         offsets.reshape(-1, plan.spec.ndim)], axis=1).reshape(-1))
    return offsets, sizes, weights, uniform, uw


@functools.lru_cache(maxsize=64)
def device_table(plan: RmaPlan, device: torch.device) -> torch.Tensor:
    """The int32 table the kernel reads from device memory, built once per
    plan and device (a launch copies nothing from the host): each rank's
    update boxes [R][k][start0..2, size0..2] in 3D padded coordinates, the
    ranks in :attr:`RmaPlan.rank_order`; the pair pointers [ntiles+1]; the
    pairs [npairs][4]: the destination's card, the destination and the
    source as offsets into their cards' buffers (``i * nbuf * block +
    offset`` in buffer 0 of the card's i-th rank; the source on the
    writing tile's card), the source's window index or -1; the dependency
    pointers [ntiles+1] and the dependencies; the publish pointers
    [ntiles+1] and lists; the peer pointers [ncards+1] and the peers."""
    tables, tiles = rma_tables(plan), rma_tiles(plan)
    lead = 3 - len(plan.local_shape)
    block = math.prod(plan.block_shape)
    per_rank = plan.num_buffers * block
    if max(map(len, plan.card_ranks)) * per_rank >= 2 ** 31:
        raise ValueError("a card's buffers exceed an int32 index")

    def six(box):
        return ([0] * lead + [b.start for b in box]
                + [1] * lead + [b.stop - b.start for b in box])

    boxes = [v for rank in plan.rank_order for box in tables.boxes[rank]
             for v in six(box)]
    card, index = np.asarray(plan.places).T
    d_rank, d_off = np.divmod(tiles.pairs[:, 0], block)
    s_rank, s_off = np.divmod(tiles.pairs[:, 1], block)
    writer = np.repeat(tiles.card, np.diff(tiles.pair_ptr))
    if (card[s_rank] != writer).any():
        raise AssertionError("a pair's source lies off its tile's card")
    pairs = np.stack([card[d_rank], index[d_rank] * per_rank + d_off,
                      index[s_rank] * per_rank + s_off, tiles.pairs[:, 2]],
                     axis=1)
    table = np.concatenate([
        np.asarray(boxes, np.int64), tiles.pair_ptr, pairs.reshape(-1),
        tiles.dep_ptr, tiles.deps, tiles.pub_ptr, tiles.pub,
        tiles.peer_ptr, tiles.peers])
    return torch.from_numpy(table.astype(np.int32)).to(device)


def _join(streams) -> None:
    """Make each of ``streams`` wait for the work enqueued so far on every
    other."""
    events = [s.record_event() for s in streams]
    for s in streams:
        for e in events:
            s.wait_event(e)


class RmaKernel:
    """The hand-written kernel ``csrc/rma_iterate.cu``: its build, its
    wrapper (``kernel(buffers, plan, n_steps, slot=0)``) and its counts of
    calls that launch it: ``launches``, and again ``pins_launches`` for a
    plan with a periodic or Neumann wall, ``bf16_launches`` for a bfloat16
    plan and ``cards_launches`` for a plan over more than one card, whose
    call on real cards issues one cooperative launch per card
    (plain-version calls do not count)."""

    name = "rma_iterate"
    ENTRIES = {"float32": "rma_iterate_f32", "bfloat16": "rma_iterate_bf16"}
    # rma_iterate.cu's kErrNoPeer: cudaDeviceCanAccessPeer says no
    ERR_NO_PEER = -3

    def __init__(self):
        self.source = SOURCE
        self._peers = set()   # (device, peer) pairs whose access is on
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = 0
        self.pins_launches = 0
        self.bf16_launches = 0
        self.cards_launches = 0

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
            # each card's buffers and flags (host arrays of device
            # pointers), the device table (device); geometry int32 (host)
            # and its length; the tap table (host): offsets [ntaps*3],
            # group sizes, group weights, ntaps, ngroups, uniform, uniform
            # weight; the launch's cards [card0, card_end), device, stream
            fn.argtypes = [P, P, P, P, I, P, P, P, I, I, I, ctypes.c_float,
                           I, I, I, P]
            entries[dtype] = fn
        err = lib.rma_iterate_error
        err.restype = ctypes.c_char_p
        err.argtypes = [I]
        peer = lib.rma_enable_peer
        peer.restype = I
        peer.argtypes = [I, I]
        return entries, err, peer

    def library(self):
        """Build and load the library; returns its float32 C entry."""
        return self._entries[0]["float32"]

    @staticmethod
    def check(buffers: Buffers, plan: RmaPlan, n_steps: int,
              slot: int) -> List[torch.Tensor]:
        """Each card's buffer tensor (:func:`card_parts`), checked: dtype,
        shape, contiguity, one device type; on CUDA, virtual cards (and one
        card) on one device, real cards each on a device of its own."""
        parts = card_parts(buffers, plan)
        for card, part in enumerate(parts):
            if part.dtype != torch_dtype(plan.dtype):
                raise ValueError(f"buffers dtype {dtype_name(part.dtype)} "
                                 f"!= plan dtype {plan.dtype}")
            if tuple(part.shape) != plan.card_shape(card):
                raise ValueError(f"buffers shape {tuple(part.shape)} != "
                                 f"{plan.card_shape(card)}")
            if not part.is_contiguous():
                raise ValueError("buffers must be contiguous")
        devices = [part.device for part in parts]
        if len({d.type for d in devices}) > 1:
            raise ValueError(f"the cards' buffers lie on {devices}")
        if (devices[0].type == "cuda"
                and len(set(devices)) != len(plan.device_ranks)):
            raise ValueError(f"the plan's {plan.ncards} cards lie on "
                             f"{len(plan.device_ranks)} devices, its "
                             f"buffers on {devices}")
        if n_steps < 1 or slot not in (0, 1):
            raise ValueError(f"n_steps {n_steps} >= 1 and slot {slot} in "
                             "(0, 1)")
        return parts

    def _enable_peers(self, plan: RmaPlan, devices, peer, err) -> None:
        """Peer access from each card's device to every card it exchanges
        with (its tiles store into their memory and publish into their
        flags), once per pair and process; raises naming both devices
        where the hardware has none."""
        tiles = rma_tiles(plan)
        for card in range(plan.ncards):
            for other in tiles.peers[tiles.peer_ptr[card]:
                                     tiles.peer_ptr[card + 1]]:
                a, b = devices[card].index, devices[other].index
                if (a, b) in self._peers:
                    continue
                rc = peer(a, b)
                if rc == self.ERR_NO_PEER:
                    raise RuntimeError(
                        f"cuda:{a} cannot access the memory of cuda:{b} "
                        "(cudaDeviceCanAccessPeer): rma across these cards "
                        "needs peer access")
                if rc != 0:
                    raise RuntimeError(f"enabling peer access from cuda:{a} "
                                       f"to cuda:{b} failed ({rc}): "
                                       f"{err(rc).decode()}")
                self._peers.add((a, b))

    def __call__(self, buffers: Buffers, plan: RmaPlan, n_steps: int,
                 slot: int = 0) -> Buffers:
        """``n_steps`` outer steps of every rank, on ``buffers`` (each
        card's, :func:`card_parts`) in place, the first step reading slot
        ``slot``; the result lies in slot ``(slot + n_steps) % 2``. Returns
        ``buffers``.

        CUDA tensors launch the kernel's entry for ``plan.dtype`` (float32
        or bfloat16) without synchronising: one cooperative launch over
        every card's tiles where the cards share a device (one card, or
        virtual cards), else, after enabling peer access between the cards
        that exchange, one cooperative launch per card on that device's
        current stream, all issued before any is waited on. Each card's
        flags are a new int32 tensor zeroed on its device's stream, and
        across devices every stream waits for every other's work before the
        launches (the zeroing, the buffers' writes) and after them (the
        remote stores into its buffers). The compute buffers are left as
        they were. Raises ``ValueError`` for another dtype and
        ``RuntimeError`` if the build, the peer access or a cooperative
        launch fails. CPU tensors run :func:`rma_iterate_reference`."""
        parts = self.check(buffers, plan, n_steps, slot)
        if parts[0].device.type == "cpu":
            return rma_iterate_reference(buffers, plan, n_steps, slot)
        if parts[0].device.type != "cuda":
            raise ValueError(f"{self.name} runs on cuda (or cpu for the "
                             f"plain version), not {parts[0].device}")
        if plan.dtype not in self.ENTRIES:
            raise ValueError(f"{self.name} runs "
                             f"{' or '.join(self.ENTRIES)}, not "
                             f"{plan.dtype}")
        entries, err, peer = self._entries
        offsets, sizes, weights, uniform, uw = _taps(plan)
        geom = _geometry(plan, n_steps, slot)
        devices = [part.device for part in parts]
        shared = len(set(devices)) == 1
        if not shared:
            self._enable_peers(plan, devices, peer, err)
        streams = [torch.cuda.current_stream(d) for d in devices]
        # each card's flags: every tile's epoch, then one arrival per card
        flags = [torch.zeros(rma_tiles(plan).ntiles + plan.ncards,
                             dtype=torch.int32, device=d) for d in devices]
        if not shared:
            _join(streams)
        bufp = (ctypes.c_void_p * plan.ncards)(
            *(part.data_ptr() for part in parts))
        flagp = (ctypes.c_void_p * plan.ncards)(
            *(f.data_ptr() for f in flags))
        for card0, card_end in ([(0, plan.ncards)] if shared else
                                [(c, c + 1) for c in range(plan.ncards)]):
            device = devices[card0]
            rc = entries[plan.dtype](
                ctypes.addressof(bufp), ctypes.addressof(flagp),
                device_table(plan, device).data_ptr(),
                geom.ctypes.data, len(geom), offsets.ctypes.data,
                sizes.ctypes.data, weights.ctypes.data, len(offsets) // 3,
                len(sizes), int(uniform), uw, card0, card_end, device.index,
                streams[card0].cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{self.name} launch on {device} failed "
                                   f"({rc}): {err(rc).decode()}")
        if not shared:
            _join(streams)
        self.launches += 1
        self.pins_launches += plan.dynamic
        self.bf16_launches += plan.dtype == "bfloat16"
        self.cards_launches += plan.ncards > 1
        return buffers


rma_iterate = RmaKernel()


@dataclasses.dataclass(frozen=True)
class RmaStencil:
    """Distributed Jacobi iteration with every rank's blocks resident for a
    whole iterate and the halos pushed inside the kernel: leading-dim
    sharding over a 1D or 2D mesh (its axes in order shard d0, d1) whose
    ranks lie on one card or several, ``sweeps_per_call`` sweeps per
    exchange."""

    spec: StencilSpec
    interior_shape: Tuple[int, ...]
    dtype: str = "float32"
    sweeps_per_call: int = 1

    def local_plan(self, mesh_shape, sweeps: Optional[int] = None,
                   budget=H100_L2_BYTES,
                   bc: Optional[DirichletBC] = None,
                   cards: Optional[Sequence[int]] = None,
                   virtual: bool = False) -> RmaPlan:
        """The per-rank plan (``local_plan``, :800-813): each sharded dim
        must divide its mesh axis. ``bc`` gives the walls; ``budget``,
        ``cards`` and ``virtual`` are :func:`make_rma_plan`'s."""
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
            self.sweeps_per_call if sweeps is None else sweeps, budget, bc,
            cards=cards, virtual=virtual)

    def plan_for(self, mesh: Mesh, bc: Optional[DirichletBC] = None,
                 virtual_cards: Optional[int] = None,
                 budget: Optional[int] = None) -> RmaPlan:
        """The plan on ``mesh``: each distinct device of the mesh is a card
        (numbered in the order the ranks first name them), rank i on the
        card of its device, each device's ranks within its L2
        (:func:`l2_budget`, or ``budget`` bytes for every device, where the
        plan is made for cards this process need not see). With
        ``virtual_cards=G``, on a mesh of one device only, rank i goes to
        virtual card i % G (``make_mesh``'s rule), every card on that
        device and within its one L2."""
        devices = tuple(dict.fromkeys(mesh.devices))
        if virtual_cards is None:
            cards = tuple(devices.index(d) for d in mesh.devices)
        elif len(devices) > 1:
            raise ValueError(f"virtual_cards splits a mesh of one device; "
                             f"this mesh spans {len(devices)}")
        elif not 1 <= virtual_cards <= mesh.size:
            raise ValueError(f"virtual_cards {virtual_cards} outside [1, "
                             f"{mesh.size}] for {mesh.size} ranks")
        else:
            cards = tuple(i % virtual_cards for i in range(mesh.size))
        if budget is None:
            budget = (l2_budget(devices[0]) if len(devices) == 1
                      else tuple(map(l2_budget, devices)))
        return self.local_plan(mesh.shape, budget=budget, bc=bc,
                               cards=cards,
                               virtual=virtual_cards is not None)

    def _block(self, mesh: Mesh, plan: RmaPlan, rank: int) -> tuple:
        """The slice of the global interior that ``rank`` holds."""
        coords = mesh.coords(rank) + (0,) * (
            len(self.interior_shape) - len(mesh.shape))
        return tuple(slice(i * n, (i + 1) * n)
                     for i, n in zip(coords, plan.local_shape))

    def scatter(self, grid: HaloGrid, mesh: Mesh, plan: RmaPlan) -> Buffers:
        """Every rank's blocks, one tensor per card on the device of its
        ranks (a plan of one card: the tensor itself), every buffer of a
        rank holding its window of the global grid padded by
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
        parts = []
        for card, ranks in enumerate(plan.card_ranks):
            device = mesh.devices[ranks[0]]
            buffers = torch.empty(plan.card_shape(card), dtype=grid.dtype,
                                  device=device)
            for i, rank in enumerate(ranks):
                window = tuple(slice(s.start, s.stop + 2 * kr)
                               for s in self._block(mesh, plan, rank))
                buffers[i].copy_(padded[window].to(device).expand(
                    plan.num_buffers, *plan.block_shape))
            parts.append(buffers)
        return parts[0] if plan.ncards == 1 else parts

    def gather(self, buffers: Buffers, slot: int, mesh: Mesh,
               plan: RmaPlan, grid: HaloGrid) -> HaloGrid:
        """Slot ``slot``'s interiors as a new grid like ``grid``."""
        parts = card_parts(buffers, plan)
        out = torch.empty(tuple(self.interior_shape), dtype=grid.dtype,
                          device=grid.device)
        for rank, (card, i) in enumerate(plan.places):
            out[self._block(mesh, plan, rank)] = plan.layout.unpad(
                parts[card][i, slot]).to(out.device)
        return HaloGrid.from_interior(out, halo=grid.halo, bc=grid.bc,
                                      device=grid.device)

    def iterate(self, grid: HaloGrid, iterations: int, mesh: Mesh,
                virtual_cards: Optional[int] = None) -> HaloGrid:
        """``iterations`` sweeps of ``grid`` over ``mesh``: one launch of
        ``iterations // k`` outer steps and one launch of the remainder,
        on buffers scattered and gathered once, across the mesh's cards
        (or ``virtual_cards``, :meth:`plan_for`). ``grid`` is unchanged;
        the result lies on ``grid``'s device. Dynamic walls take JAX's
        gates and messages (:830-871)."""
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
        plan = self.plan_for(mesh, grid.bc, virtual_cards)
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
