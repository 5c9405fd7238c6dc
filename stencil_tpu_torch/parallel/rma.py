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

- **one launch for the whole run**: a cooperative launch whose CTAs are all
  co-resident; every phase is a grid-stride loop over (rank, cell);
- **the blocks never leave the device**: all ranks' buffers are one tensor
  ``[R, nbuf, *B]`` in device memory, sized by :func:`make_rma_plan` to
  stay inside the card's L2 (50 MiB on an H100), where the TPU kernel's
  budget was VMEM;
- **strips move inside the kernel**: one phase per sharded dim, each rank
  storing its edge rows into its neighbours' opposite ghost bands of the
  same slot, with JAX's footprint (:func:`strip_boxes`), so corners
  transit and no cell is written twice; no host copy, no ``ppermute``;
- **grid barriers in place of the neighbour semaphores**: one after each
  phase and one after each sweep, so a phase's strips read what the last
  phase wrote and a sweep reads what the last sweep wrote.

One outer step from slot ``s`` to slot ``1 - s``, in phases that each end
in a grid barrier (:func:`phase_copies` lists every copy of them):

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
  Sweeps 1..k-1 write the compute buffers, the last one the other slot.

The buffer tensor holds ``2 + num_compute_bufs`` padded blocks per rank.
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
boxes the kernel's geometry describes, so a table fault shows on the CPU.

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
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch import _build
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
# the L2 cache of an H100 (50 MiB): the residency budget where no card is
# asked (a plan made on the CPU); on a card its own L2 size
H100_L2_BYTES = 50 * 2 ** 20
# neighbour codes of a face with no neighbour (rma_tables): Dirichlet
# ghosts stay as the scatter left them; Neumann ghosts are the rank's own
# mirror, written in the dim's phase
NBR_DIRICHLET = -1
NBR_MIRROR = -2
# the local refresh of the unsharded dynamic dim (_geometry)
REFRESH_NONE, REFRESH_WRAP, REFRESH_MIRROR = -1, 0, 1


def l2_budget(device) -> int:
    """The residency budget of one launch on ``device``: its L2 size on a
    CUDA device, :data:`H100_L2_BYTES` elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).L2_cache_size
    return H100_L2_BYTES


@dataclasses.dataclass(frozen=True)
class RmaPlan:
    """One launch's static geometry: each rank's interior ``local_shape``
    padded by ``layout.halo`` = k*r on every side, ``sweeps_per_call``
    sweeps per outer step (``halo`` = sweeps*r, the strips' depth; below
    ``layout.halo`` only for a remainder plan, :meth:`with_sweeps`),
    ``num_buffers`` padded blocks per rank, and the walls: ``periodic``
    and ``neumann`` per grid dim (Dirichlet where both are False)."""

    spec: StencilSpec
    local_shape: Tuple[int, ...]
    dtype: str
    mesh_shape: Tuple[int, ...]
    sweeps_per_call: int
    layout: PaddedLayout
    num_buffers: int
    periodic: Tuple[bool, ...]
    neumann: Tuple[bool, ...]

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
        return math.prod(self.buffer_shape) * self.itemsize

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
                  bc: Optional[DirichletBC] = None) -> RmaPlan:
    """The plan, with JAX's gates and messages (``make_rma_plan``,
    :175-221): a 2D or 3D grid, a 1D or 2D mesh over the leading dims,
    k >= 1, a sharded local extent of at least 2*k*r; then the card's
    budget: every rank's ``2 + num_compute_bufs`` padded blocks, all on one
    card, within ``budget`` (its L2), at the dtype's size. ``bc`` gives the
    walls (None: Dirichlet); a dynamic dim must be a leading one, and an
    unsharded one at least k*r deep (the gates of
    :meth:`RmaStencil.iterate` say so in JAX's words first)."""
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
    plan = RmaPlan(spec=spec, local_shape=tuple(local_shape), dtype=dtype,
                   mesh_shape=tuple(mesh_shape), sweeps_per_call=k,
                   layout=PaddedLayout.for_halo(local_shape, kr),
                   num_buffers=2 + (0 if k == 1 else (1 if k == 2 else 2)),
                   periodic=tuple(per), neumann=tuple(neu))
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


# the host geometry's layout (_geometry, rma_iterate.cu's kGeomLen)
GEOM_HEADER = 10
GEOM_REFRESH = 8
GEOM_PHASE = 17
MAX_PHASES = 2
GEOM_LEN = GEOM_HEADER + GEOM_REFRESH + MAX_PHASES * GEOM_PHASE


def _geometry(plan: RmaPlan, n_steps: int, slot: int) -> np.ndarray:
    """The host int32 geometry of a launch, every box in 3D padded
    coordinates (a 2D plan gains a leading dim of 1): R, nbuf, P0 P1 P2,
    the phase count, k, the steps, the first slot, the refresh's kind
    (``REFRESH_*``); then the refresh's dim, that dim's interior extent n,
    its box's extent and start at the first interior row (zeros without a
    refresh); then for each of two phases the strip's extent, the
    (source, destination) starts of the lo and the hi push, the dim and
    its n (zeros past the phase count). A mirror or refresh item at depth
    j (0-based) of a band whose first interior row is at flat offset a
    writes a - (2j+1)*stride (the lo ghost) or a + n*stride (the hi one)
    and reads what a wrap or a mirror gives (``band_copy`` in the kernel);
    a mirror's band is the lo push's source strip."""
    lead = 3 - len(plan.local_shape)
    pshape = (1,) * lead + plan.layout.padded_shape
    rd = plan.refresh_dim
    kind = REFRESH_NONE if rd is None else (
        REFRESH_WRAP if plan.periodic[rd] else REFRESH_MIRROR)
    geom = [plan.ranks, plan.num_buffers, *pshape, len(plan.mesh_shape),
            plan.sweeps_per_call, n_steps, slot, kind]
    if rd is None:
        geom += [0] * GEOM_REFRESH
    else:
        box = refresh_box(plan, plan.layout.halo)
        geom += [rd + lead, plan.local_shape[rd]]
        geom += [1] * lead + [s.stop - s.start for s in box]
        geom += [0] * lead + [s.start for s in box]
    for d, pushes in enumerate(rma_tables(plan).strips):
        src = pushes[0][0]
        geom += [1] * lead + [s.stop - s.start for s in src]
        for box_src, box_dst in pushes:
            for box in (box_src, box_dst):
                geom += [0] * lead + [s.start for s in box]
        geom += [d + lead, plan.local_shape[d]]
    geom += [0] * (GEOM_LEN - len(geom))
    return np.asarray(geom, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def device_table(plan: RmaPlan, device: torch.device) -> torch.Tensor:
    """The int32 per-rank table the kernel reads from device memory, built
    once per plan and device (a launch copies nothing from the host): the
    neighbour codes [R][phases][2], the update boxes [R][k][start0..2,
    size0..2], then each sweep's bounding box over the ranks [k][6], in 3D
    padded coordinates."""
    tables = rma_tables(plan)
    lead = 3 - len(plan.local_shape)
    nbrs = [v for rank in tables.neighbours for lo_hi in rank for v in lo_hi]

    def six(box):
        return ([0] * lead + [b.start for b in box]
                + [1] * lead + [b.stop - b.start for b in box])

    boxes = [v for rank in tables.boxes for box in rank for v in six(box)]
    bound = []
    for t in range(plan.sweeps_per_call):
        per = [rank[t] for rank in tables.boxes]
        bound += six(tuple(slice(min(b[d].start for b in per),
                                 max(b[d].stop for b in per))
                           for d in range(len(plan.local_shape))))
    return torch.tensor(nbrs + boxes + bound, dtype=torch.int32,
                        device=device)


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
            # buffers, device table (device); geometry int32 (host) and its
            # length; the tap table (host): offsets [ntaps*3], group sizes,
            # group weights, ntaps, ngroups, uniform, uniform weight;
            # device, stream
            fn.argtypes = [P, P, P, I, P, P, P, I, I, I, ctypes.c_float, I,
                           P]
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
        (float32 or bfloat16) on the current stream (no synchronisation)
        and raises ``ValueError`` for another dtype and ``RuntimeError`` if
        the build or the cooperative launch fails; a CPU tensor runs
        :func:`rma_iterate_reference`."""
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
        device = buffers.device.index if buffers.device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = entries[plan.dtype](
            buffers.data_ptr(), table.data_ptr(), geom.ctypes.data,
            len(geom), offsets.ctypes.data, sizes.ctypes.data,
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
