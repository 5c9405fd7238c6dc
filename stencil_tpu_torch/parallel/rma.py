"""In-kernel halo exchange: every rank's blocks resident for a whole run,
strips pushed between ranks inside one launch (method ``rma``).

Counterpart of ``stencil_tpu/parallel/rma.py`` (``RmaPlan``,
``make_rma_plan``, ``push_bytes_per_step``, ``build_rma_iterate`` and
``RmaStencil``) on the port's single-controller mesh
(``parallel/mesh.py``), on Dirichlet walls in float32. The TPU kernel keeps
each chip's padded block in VMEM for ``n_outer`` outer steps and pushes
k*r-deep edge strips chip to chip by remote DMA, paced by semaphores. Its
port, ``csrc/rma_iterate.cu``, keeps the contract and changes the means:

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

One outer step from slot ``s`` to slot ``1 - s``: the exchange into slot
``s``'s ghost bands, then k sweeps. Sweep t updates the rank's interior,
grown by (k-t)*r on each mesh-internal face (JAX's ``rect``); physical
faces and unsharded dims are never grown, so their Dirichlet ghosts hold
the BC from the scatter in every buffer, as the TPU kernel's re-pinning
leaves them. Sweeps 1..k-1 write the compute buffers, the last one the
other slot. The buffer tensor holds ``2 + num_compute_bufs`` padded blocks
per rank. An iteration count that k does not divide ends in one launch of
``plan.with_sweeps(rem)`` on the same buffers: rem*r-deep strips, boxes
grown by (rem-t)*r.

The per-rank tables (neighbours per phase, strip boxes, update boxes per
sweep) are built once per launch plan in Python (:func:`rma_tables`); the
plain version (:func:`rma_iterate_reference`) walks the same tables the
kernel receives, so a table fault shows on the CPU.

JAX's TPU-layout rules are dropped: the DMA granules (``_dma_quantum``),
the 128/sublane divisibility refusal and the rounded pads of
``_rma_layout``. Ghosts are exactly k*r deep on every dim. Periodic and
Neumann walls (JAX's ring pushes, ``mirror_dim``, ``refresh_unsharded``)
and bfloat16 are not ported yet (B3-pins, B3-bf16) and raise
``NotImplementedError``. A mesh whose ranks sit on more than one card is
refused: one launch spans the ranks of one card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch import _build
from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, dtype_name, torch_dtype,
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
# the L2 cache of an H100 (50 MiB): the residency budget where no card is
# asked (a plan made on the CPU); on a card its own L2 size
H100_L2_BYTES = 50 * 2 ** 20
NOT_PORTED = "not ported yet (B3-pins / B3-bf16, ROADMAP)"


def l2_budget(device) -> int:
    """The residency budget of one launch on ``device``: its L2 size on a
    CUDA device, :data:`H100_L2_BYTES` elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).L2_cache_size
    return H100_L2_BYTES


def check_ported(bc: Optional[DirichletBC], dtype) -> None:
    """Raise ``NotImplementedError`` for what B3's port does not run yet:
    periodic or Neumann walls in ``bc``, a dtype other than float32."""
    problems = []
    if bc is not None and bc.any_dynamic:
        problems.append("periodic/Neumann walls")
    if dtype_name(torch_dtype(dtype)) != "float32":
        problems.append(f"dtype {dtype_name(torch_dtype(dtype))}")
    if problems:
        raise NotImplementedError(
            f"{' and '.join(problems)} on the 'rma' method: {NOT_PORTED}")


@dataclasses.dataclass(frozen=True)
class RmaPlan:
    """One launch's static geometry: each rank's interior ``local_shape``
    padded by ``layout.halo`` = k*r on every side, ``sweeps_per_call``
    sweeps per outer step (``halo`` = sweeps*r, the strips' depth; below
    ``layout.halo`` only for a remainder plan, :meth:`with_sweeps`), and
    ``num_buffers`` padded blocks per rank."""

    spec: StencilSpec
    local_shape: Tuple[int, ...]
    dtype: str
    mesh_shape: Tuple[int, ...]
    sweeps_per_call: int
    layout: PaddedLayout
    num_buffers: int

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
                  budget: int = H100_L2_BYTES) -> RmaPlan:
    """The plan, with JAX's gates and messages (``make_rma_plan``,
    :175-221): a 2D or 3D grid, a 1D or 2D mesh over the leading dims,
    k >= 1, a sharded local extent of at least 2*k*r; then the card's
    budget: every rank's ``2 + num_compute_bufs`` padded blocks, all on one
    card, within ``budget`` (its L2)."""
    check_ported(None, dtype)
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
    k = sweeps_per_call
    plan = RmaPlan(spec=spec, local_shape=tuple(local_shape), dtype=dtype,
                   mesh_shape=tuple(mesh_shape), sweeps_per_call=k,
                   layout=PaddedLayout.for_halo(local_shape, kr),
                   num_buffers=2 + (0 if k == 1 else (1 if k == 2 else 2)))
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
      -1 on a physical face (the open chain of Dirichlet walls);
    - ``strips[d]``: :func:`strip_boxes` of phase d, the same for every
      rank;
    - ``boxes[rank][t-1]``: the region sweep t updates, the interior grown
      by (k-t)*r on each mesh-internal face (a physical face, pinned, is
      never grown)."""

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
            lo = _rank(c[:d] + (c[d] - 1,) + c[d + 1:], shape) \
                if c[d] > 0 else -1
            hi = _rank(c[:d] + (c[d] + 1,) + c[d + 1:], shape) \
                if c[d] < shape[d] - 1 else -1
            nbrs.append((lo, hi))
        neighbours.append(tuple(nbrs))
        live = [side >= 0 for lo_hi in nbrs for side in lo_hi]
        live += [False] * (2 * (len(plan.local_shape) - nsh))
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
    """The exchange of one step in the plain version: each phase's strips
    copied rank to rank into slot ``slot``, phase after phase. Returns the
    number of values each rank pushed."""
    tables = rma_tables(plan)
    pushed = [0] * plan.ranks
    for d, pushes in enumerate(tables.strips):
        for rank in range(plan.ranks):
            for (src, dst), to in zip(pushes, tables.neighbours[rank][d]):
                if to < 0:
                    continue
                buffers[(to, slot) + dst].copy_(buffers[(rank, slot) + src])
                pushed[rank] += math.prod(s.stop - s.start for s in src)
    return pushed


def rma_iterate_reference(buffers: torch.Tensor, plan: RmaPlan,
                          n_steps: int, slot: int = 0) -> torch.Tensor:
    """Plain version of one launch: ``n_steps`` outer steps of every rank on
    ``buffers`` (``plan.buffer_shape``) in place, the first reading slot
    ``slot``: per step :func:`exchange_reference`, then k eager sweeps per
    rank over its update boxes (``eager.apply_spec``, the kernels' tap
    order). Returns ``buffers``; the result lies in slot ``(slot +
    n_steps) % 2``."""
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


def _geometry(plan: RmaPlan, n_steps: int, slot: int) -> np.ndarray:
    """The host int32 geometry of a launch, every box in 3D padded
    coordinates (a 2D plan gains a leading dim of 1): R, nbuf, P0 P1 P2,
    the phase count, k, the steps, the first slot, then for each of two
    phases the strip's extent and the (source, destination) starts of the
    lo and the hi push (zeros past the phase count)."""
    lead = 3 - len(plan.local_shape)
    pshape = (1,) * lead + plan.layout.padded_shape
    geom = [plan.ranks, plan.num_buffers, *pshape, len(plan.mesh_shape),
            plan.sweeps_per_call, n_steps, slot]
    for pushes in rma_tables(plan).strips:
        src = pushes[0][0]
        geom += [1] * lead + [s.stop - s.start for s in src]
        for box_src, box_dst in pushes:
            for box in (box_src, box_dst):
                geom += [0] * lead + [s.start for s in box]
    geom += [0] * (39 - len(geom))
    return np.asarray(geom, dtype=np.int32)


@functools.lru_cache(maxsize=64)
def device_table(plan: RmaPlan, device: torch.device) -> torch.Tensor:
    """The int32 per-rank table the kernel reads from device memory, built
    once per plan and device (a launch copies nothing from the host): the
    neighbours [R][phases][2], the update boxes [R][k][start0..2,
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
    wrapper (``kernel(buffers, plan, n_steps, slot=0)``) and its count of
    ``launches`` (plain-version calls do not count)."""

    name = "rma_iterate"

    def __init__(self):
        self.source = SOURCE
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = 0

    def build(self) -> _build.BuildResult:
        """Compile the source (cached by content). Raises
        ``_build.BuildError`` with the compiler's stderr on failure."""
        return _build.build(_build.find_nvcc(), [self.source],
                            _build.NVCC_FLAGS, self.name,
                            headers=[TAPS_HEADER])

    @functools.cached_property
    def _entry(self):
        lib = ctypes.CDLL(str(self.build().path))
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = lib.rma_iterate_f32
        fn.restype = I
        # buffers, device table (device); geometry int32 (host) and its
        # length; the tap table (host): offsets [ntaps*3], group sizes,
        # group weights, ntaps, ngroups, uniform, uniform weight; device,
        # stream
        fn.argtypes = [P, P, P, I, P, P, P, I, I, I, ctypes.c_float, I, P]
        err = lib.rma_iterate_error
        err.restype = ctypes.c_char_p
        err.argtypes = [I]
        return fn, err

    def library(self):
        """Build and load the library; returns its C entry."""
        return self._entry[0]

    @staticmethod
    def check(buffers: torch.Tensor, plan: RmaPlan, n_steps: int,
              slot: int) -> None:
        if plan.dtype != "float32" or buffers.dtype != torch.float32:
            raise NotImplementedError(
                f"rma_iterate runs float32: {NOT_PORTED}")
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

        A CUDA tensor launches the kernel on the current stream (no
        synchronisation) and raises ``RuntimeError`` if the build or the
        cooperative launch fails; a CPU tensor runs
        :func:`rma_iterate_reference`."""
        self.check(buffers, plan, n_steps, slot)
        if buffers.device.type == "cpu":
            return rma_iterate_reference(buffers, plan, n_steps, slot)
        if buffers.device.type != "cuda":
            raise ValueError(f"{self.name} runs on cuda (or cpu for the "
                             f"plain version), not {buffers.device}")
        fn, err = self._entry
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
        rc = fn(buffers.data_ptr(), table.data_ptr(), geom.ctypes.data,
                len(geom), offsets.ctypes.data, sizes.ctypes.data,
                weights.ctypes.data, len(offsets) // 3, len(sizes),
                int(uniform), uw, device, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed ({rc}): "
                               f"{err(rc).decode()}")
        self.launches += 1
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
                   budget: int = H100_L2_BYTES) -> RmaPlan:
        """The per-rank plan (``local_plan``, :800-813): each sharded dim
        must divide its mesh axis."""
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
            self.sweeps_per_call if sweeps is None else sweeps, budget)

    def plan_for(self, mesh: Mesh) -> RmaPlan:
        """The plan on ``mesh``, whose ranks must share one device; the
        budget is that device's L2."""
        devices = tuple(dict.fromkeys(mesh.devices))
        if len(devices) > 1:
            raise ValueError(
                f"the rma method runs one launch over the ranks of one "
                f"card; this mesh spans {len(devices)} devices (rma across "
                "cards is not ported yet, ROADMAP)")
        return self.local_plan(mesh.shape, budget=l2_budget(devices[0]))

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
        k*r (every global pad cell its BC face value, later dims winning
        in corners): JAX's initial load into every buffer (:356-364).

        The window, not the rank's own block padded alone: a ghost cell
        on a physical face of one dim that lies in a mesh-internal ghost
        band of another (a corner) holds the first dim's face value in
        the global grid, where a local pad would let the later dim win.
        No sweep writes it (physical faces are never grown), so every
        buffer must hold it right from the start; the TPU kernel re-pins
        it after every sweep instead (``pin``, :562-601)."""
        kr = plan.layout.halo
        padded = PaddedLayout.for_halo(self.interior_shape, kr).pad(
            grid.interior().to(mesh.devices[0]), grid.bc)
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
        result lies on ``grid``'s device."""
        check_ported(grid.bc, grid.dtype)
        if grid.dtype != torch_dtype(self.dtype):
            raise ValueError(
                f"grid dtype {dtype_name(grid.dtype)} != plan dtype "
                f"{self.dtype}; pass dtype= when constructing RmaStencil")
        if grid.interior_shape != tuple(self.interior_shape):
            raise ValueError(f"grid interior {grid.interior_shape} != "
                             f"{tuple(self.interior_shape)}")
        plan = self.plan_for(mesh)
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
