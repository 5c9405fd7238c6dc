"""Sharded kernel stencil: the hand-written kernels per rank, a k*r-deep
halo exchange once per launch (method ``sharded_pallas``).

Counterpart of ``stencil_tpu/parallel/pallas_sharded.py:
ShardedPallasStencil`` (:174-596) on the port's single-controller mesh
(``parallel/mesh.py``): a 3D grid runs the tiled kernel per rank
(``csrc/tiled_sweep.cu``), sharded over d0 or over d0 and d1; a 2D grid
runs the slab kernel (``csrc/slab_sweep.cu``) over d0, with no split.

Each rank's block is padded once per :meth:`ShardedKernelStencil.iterate`
(:meth:`scatter`) and stays on its device for every outer step; two padded
tensors per rank alternate, and :meth:`gather` unpads once.

One outer step of k sweeps:

- **The exchange** (:meth:`exchange`, JAX's ``_strip_bounds`` and
  ``exchange``, :320-414) refreshes the k*r-deep ghost bands of the
  sharded dims in place, one phase per sharded dim. A phase's strips span
  the launch's padded extent, ``[H - k*r, H + n + k*r)``, in the earlier
  sharded dims (their ghosts are fresh, so corners ride along) and in the
  unsharded dims, and the interior only in the later sharded dims.
  Periodic dims use the circular chain; on the open chain Neumann
  mesh-edge ranks mirror their own edge strip and Dirichlet mesh-edge
  ranks keep the ghost rows the scatter filled (a uniform face fill would
  break box stencils' corners). Unsharded periodic or Neumann leading
  dims are then refreshed locally to depth k*r
  (``ops/layout.py:refresh_dynamic_layout``, :309-318).
- **The pins** (:418-436): a rank's mesh-internal faces are live (0), its
  physical Dirichlet faces pinned (1); a dynamic sharded dim is live on
  every rank; on a 1D mesh d1's pins are 1 unless d1 is dynamic.
- **The launches** (:438-463). With ``overlap`` on a mesh with more than
  one rank, the tiled kernel's columns split into interior and edge sets
  (``ops/tiled.py:partition_tiles``, the kernel's tile subsets, B1f): on
  the compute stream the interior launch reads the pre-exchange tensor;
  the exchange writes its ghost bands in place on a side stream after an
  event that marks the previous step's edge launches; the edge launch
  waits on the exchange's event and writes the rest of the same output.
  No interior window reads a cell the exchange writes
  (``tests/test_torch_sharded_kernel.py``), so the pair is bitwise the
  fused step, JAX's ``sweep_int(cur, nxt)`` then ``sweep_edge(cur2,
  part)``. Otherwise, or when either set is empty, the step exchanges and
  then launches once.
- **The remainder** of an iteration count that k does not divide runs one
  launch of ``plan.with_sweeps(rem)`` on the same tensors: its partition
  and its exchange follow the depth ``rem * r``.

A source (3D only) is scattered with zero Dirichlet ghosts and exchanged
once per iterate, at full depth (:465-474): the ghost rows nearest the
interior are then also those of any shallower launch.

Where JAX's ``make_mesh`` refuses a mesh larger than the device count,
this one places several ranks on one card (``parallel/mesh.py``). A
sharded dim whose local extent is below k*r is refused: its strips would
reach into the ghost bands.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, dtype_name, torch_dtype,
)
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.ops.eager import round_to
from stencil_tpu_torch.ops.layout import refresh_dynamic_layout
from stencil_tpu_torch.ops.slab import make_slab_plan
from stencil_tpu_torch.ops.slab_kernel import slab_sweep
from stencil_tpu_torch.ops.sweep_kernel import launch_plans
from stencil_tpu_torch.ops.tiled import (
    MARCH_T0_CANDIDATES, make_tiled_plan, partition_tiles,
)
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep
from stencil_tpu_torch.parallel.halo import block_index
from stencil_tpu_torch.parallel.mesh import Mesh


def strip_box(plan, nsh: int, d: int, start: int) -> tuple:
    """The index of the phase-``d`` strip of a launch of ``plan`` sharded
    over its first ``nsh`` dims, whose dim-``d`` rows start at padded index
    ``start``, ``plan.halo`` (the launch's k*r) deep: the launch's padded
    extent ``[H - k*r, H + n + k*r)`` in the earlier sharded dims and in the
    unsharded dims, the interior in the later sharded dims
    (``_strip_bounds``, :320-340; the ``rma`` method's pushes have the same
    footprint, ``parallel/rma.py:strip_extent``, :385-395)."""
    kr, h = plan.halo, plan.layout.halo
    box = []
    for e, n in enumerate(plan.interior_shape):
        if e == d:
            box.append(slice(start, start + kr))
        elif d < e < nsh:
            box.append(slice(h, h + n))
        else:
            box.append(slice(h - kr, h + n + kr))
    return tuple(box)


def _cuda_devices(mesh: Mesh) -> List[torch.device]:
    return [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]


@dataclasses.dataclass(frozen=True)
class ShardedKernelStencil:
    """Distributed Jacobi iteration: leading-dim sharding over the mesh
    axes ``axis_names`` (d0, or d0 and d1 of a 3D grid), the hand-written
    kernel per rank at ``sweeps_per_call`` sweeps per launch.
    ``interior_shape`` is the global interior; ``tiles`` pins the local
    plan's tile, ``t0_fixed`` only its d0 extent (the CLI's ``-b``).
    ``overlap`` splits each outer
    step into interior and edge launches around the exchange;
    ``has_source`` makes every sweep ``u' = S(u) + source_scale *
    source`` (3D), the source given to :meth:`iterate`. ``schedule`` goes
    to the 3D local plan (``ops/tiled.py:make_tiled_plan``; None: the
    rule)."""

    spec: StencilSpec
    interior_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("x",)
    dtype: str = "float32"
    sweeps_per_call: int = 1
    tiles: Optional[Tuple[int, ...]] = None
    t0_fixed: Optional[int] = None
    overlap: bool = True
    has_source: bool = False
    schedule: Optional[str] = None

    def local_plan(self, mesh_shape):
        """The per-rank kernel plan, with JAX's gates and messages
        (``pallas_sharded.py:221-267``): the tiled kernel for a 3D grid,
        the slab kernel for a 2D one. ``mesh_shape`` is the rank count
        per sharded dim (an int means 1D)."""
        if isinstance(mesh_shape, int):
            mesh_shape = (mesh_shape,)
        nsh = len(mesh_shape)
        if nsh != len(self.axis_names):
            raise ValueError(
                f"mesh shape {tuple(mesh_shape)} does not match sharded "
                f"axes {self.axis_names}")
        if nsh > 2:
            raise ValueError(
                "mesh must be 1D or 2D over the leading grid dims")
        if nsh == 2 and len(self.interior_shape) != 3:
            raise ValueError(
                "2-axis sharding needs a 3D grid (the 2D slab kernel's "
                "minor dim is the lane dim; shard the leading dim only)")
        local = list(self.interior_shape)
        for d, n_dev in enumerate(mesh_shape):
            if local[d] % n_dev:
                raise ValueError(
                    f"grid dim {d} ({local[d]}) not divisible by mesh "
                    f"axis size {n_dev}")
            local[d] //= n_dev
        if len(self.interior_shape) == 3:
            def plan_of(t0_fixed):
                return make_tiled_plan(
                    self.spec, tuple(local), self.dtype,
                    self.sweeps_per_call, tiles=self.tiles,
                    t0_fixed=t0_fixed, has_source=self.has_source,
                    schedule=self.schedule)

            plan = plan_of(self.t0_fixed)
            if plan.schedule == "march" and self.tiles is None \
                    and self.t0_fixed is None and self.splits(mesh_shape):
                # the overlapped step needs interior columns: a chunk so
                # long that no d0 chunk clears the ghost bands leaves none,
                # so take the longest chunk that leaves some
                for t0 in sorted((t for t in MARCH_T0_CANDIDATES
                                  if t < plan.tiles[0]), reverse=True):
                    if all(partition_tiles(plan)):
                        break
                    plan = plan_of(t0)
            return plan
        if self.has_source:
            raise ValueError(
                "the fused source term is 3D-only (the 2D slab kernel "
                "has no source path); use the 'xla' source path for 2D")
        return make_slab_plan(self.spec, tuple(local), self.dtype,
                              self.sweeps_per_call, tiles=self.tiles,
                              t0_fixed=self.t0_fixed,
                              schedule=self.schedule)

    def mesh_shape(self, mesh: Mesh) -> Tuple[int, ...]:
        return tuple(mesh.axis_size(a) for a in self.axis_names)

    def splits(self, mesh_shape) -> bool:
        """Whether an outer step splits into interior and edge launches
        (``split``, :72-73, 277-290): with ``overlap``, on a mesh of more
        than one rank, for the tiled kernel (3D); a step whose partition
        leaves either set empty still runs fused (:meth:`step`)."""
        return self.overlap and any(n > 1 for n in mesh_shape) \
            and len(self.interior_shape) == 3

    def _index(self, mesh: Mesh, rank: int) -> tuple:
        names = tuple(self.axis_names) + (None,) * (
            len(self.interior_shape) - len(self.axis_names))
        return block_index(self.interior_shape, names, mesh, rank)

    @staticmethod
    def kernel(plan):
        """The plan's kernel: tiled (3D) or slab (2D)."""
        return tiled_sweep if len(plan.interior_shape) == 3 else slab_sweep

    # -- scatter, gather ----------------------------------------------------

    def scatter(self, grid: HaloGrid, mesh: Mesh) -> List[torch.Tensor]:
        """The global interior cut into one padded block per rank, on the
        rank's device, every pad cell its BC face value."""
        plan = self.local_plan(self.mesh_shape(mesh))
        interior = grid.interior()
        return [plan.layout.pad(interior[self._index(mesh, rank)].to(dev),
                                grid.bc)
                for rank, dev in enumerate(mesh.devices)]

    def gather(self, blocks: List[torch.Tensor], mesh: Mesh,
               grid: HaloGrid) -> HaloGrid:
        """The blocks' interiors as a new grid like ``grid``."""
        plan = self.local_plan(self.mesh_shape(mesh))
        out = torch.empty(tuple(self.interior_shape), dtype=grid.dtype,
                          device=grid.device)
        for rank, block in enumerate(blocks):
            out[self._index(mesh, rank)] = plan.layout.unpad(block).to(
                out.device)
        return HaloGrid.from_interior(out, halo=grid.halo, bc=grid.bc,
                                      device=grid.device)

    def _scatter_source(self, plan, mesh: Mesh, source, source_scale,
                        bc: DirichletBC) -> List[torch.Tensor]:
        """The source scaled in the plan dtype (``ops/layout.py:
        pad_source``'s rule), one padded block per rank with zero Dirichlet
        ghosts, then exchanged once at full depth."""
        scaled = torch.as_tensor(source).to(torch_dtype(plan.dtype)) \
            * round_to(source_scale, plan.dtype)
        nd = len(self.interior_shape)
        zero = DirichletBC(values=((0.0, 0.0),) * nd, periodic=bc.periodic,
                           neumann=bc.neumann)
        blocks = [plan.layout.pad(scaled[self._index(mesh, rank)].to(dev),
                                  zero)
                  for rank, dev in enumerate(mesh.devices)]
        self.exchange(mesh, blocks, plan, bc)
        return blocks

    # -- the exchange and the pins ------------------------------------------

    def strip_box(self, plan, d: int, start: int) -> tuple:
        """:func:`strip_box` on this stencil's sharded axes."""
        return strip_box(plan, len(self.axis_names), d, start)

    def exchange_bytes(self, plan) -> int:
        """Bytes one rank receives in one exchange of ``plan`` (both
        strips of every phase), as the audit counts them."""
        return sum(2 * math.prod(s.stop - s.start
                                 for s in self.strip_box(plan, d, 0))
                   for d in range(len(self.axis_names))) * plan.itemsize

    def _local_bc(self, bc: DirichletBC) -> Optional[DirichletBC]:
        """``bc`` cut to its unsharded dynamic dims, which the exchange
        refreshes locally; None if there are none among the leading
        dims."""
        nd, nsh = len(self.interior_shape), len(self.axis_names)
        if not any(bc.dynamic_mask(nd)[nsh:nd - 1]):
            return None
        per = tuple(p and d >= nsh
                    for d, p in enumerate(bc.periodic_mask(nd)))
        neu = tuple(n and d >= nsh
                    for d, n in enumerate(bc.neumann_mask(nd)))
        return dataclasses.replace(bc, periodic=per if any(per) else (),
                                   neumann=neu if any(neu) else ())

    def exchange(self, mesh: Mesh, blocks: List[torch.Tensor], plan,
                 bc: DirichletBC) -> None:
        """Refresh the ``plan.halo``-deep ghost bands of every rank's
        padded block in place: one ``ppermute`` pair per sharded dim, then
        the local refresh of unsharded dynamic leading dims (``exchange``,
        :342-414). Runs on the current stream of each block's device."""
        nd = len(self.interior_shape)
        per, neu = bc.periodic_mask(nd), bc.neumann_mask(nd)
        h, kr = plan.layout.halo, plan.halo
        for d, ax in enumerate(self.axis_names):
            n, nloc = mesh.axis_size(ax), plan.interior_shape[d]
            los = [b[self.strip_box(plan, d, h)] for b in blocks]
            his = [b[self.strip_box(plan, d, h + nloc - kr)] for b in blocks]
            if per[d]:
                # the wrap is the ring
                hi_ghost = mesh.ppermute(los, ax, [(i, (i - 1) % n)
                                                   for i in range(n)])
                lo_ghost = mesh.ppermute(his, ax, [(i, (i + 1) % n)
                                                   for i in range(n)])
            else:
                # my low rows -> previous rank's high ghosts; my high rows
                # -> next rank's low ghosts
                hi_ghost = mesh.ppermute(los, ax, [(i, i - 1)
                                                   for i in range(1, n)])
                lo_ghost = mesh.ppermute(his, ax, [(i, i + 1)
                                                   for i in range(n - 1)])
            lo_box = self.strip_box(plan, d, h - kr)
            hi_box = self.strip_box(plan, d, h + nloc)
            for rank, block in enumerate(blocks):
                idx = mesh.axis_index(rank, ax)
                lo, hi = lo_ghost[rank], hi_ghost[rank]
                # mesh-edge ranks: Neumann mirrors its own edge strip,
                # Dirichlet keeps its scatter-time ghost rows
                if not per[d] and idx == 0:
                    lo = torch.flip(los[rank], (d,)) if neu[d] else None
                if not per[d] and idx == n - 1:
                    hi = torch.flip(his[rank], (d,)) if neu[d] else None
                if lo is not None:
                    block[lo_box].copy_(lo)
                if hi is not None:
                    block[hi_box].copy_(hi)
        local = self._local_bc(bc)
        if local is not None:
            for block in blocks:
                refresh_dynamic_layout(block, plan.layout, local, kr)

    def pins(self, mesh: Mesh, rank: int, bc: DirichletBC
             ) -> Tuple[int, ...]:
        """The rank's launch pins (``_pins``, :418-436)."""
        nd = len(self.interior_shape)
        dyn = bc.dynamic_mask(nd)
        pins = []
        for d, ax in enumerate(self.axis_names):
            if dyn[d]:
                pins += [0, 0]
                continue
            idx, n = mesh.axis_index(rank, ax), mesh.axis_size(ax)
            pins += [int(idx == 0), int(idx == n - 1)]
        if nd == 3 and len(self.axis_names) == 1:
            pins += [0 if dyn[1] else 1] * 2
        return tuple(pins)

    # -- the iterate ----------------------------------------------------------

    def _check(self, grid: HaloGrid, source, plan) -> None:
        """JAX's gates of ``iterate`` (:541-581) and the port's depth
        gate."""
        if grid.dtype != torch_dtype(self.dtype):
            raise ValueError(
                f"grid dtype {dtype_name(grid.dtype)} != plan dtype "
                f"{self.dtype}; pass dtype= when constructing "
                "ShardedKernelStencil")
        if (source is not None) != self.has_source:
            raise ValueError(
                "pass source= iff the method was constructed with "
                "has_source=True")
        if source is not None \
                and tuple(np.shape(source)) != tuple(self.interior_shape):
            raise ValueError(
                f"source shape {tuple(np.shape(source))} != global "
                f"interior {tuple(self.interior_shape)}")
        if grid.interior_shape != tuple(self.interior_shape):
            raise ValueError(f"grid interior {grid.interior_shape} != "
                             f"{tuple(self.interior_shape)}")
        if grid.bc.any_dynamic:
            nd = len(self.interior_shape)
            dyn, neu = grid.bc.dynamic_mask(nd), grid.bc.neumann_mask(nd)
            problems = []
            if dyn[-1]:
                problems.append(
                    "a periodic/Neumann lane (last) dim is unsupported "
                    "(use the 'sharded' or 'xla' method)")
            if self.sweeps_per_call > 1:
                for d in range(nd - 1):
                    if neu[d] and not self.spec.symmetric_in(d):
                        problems.append(
                            f"a Neumann dim {d} at temporal depth k>1 "
                            f"needs the stencil mirror-symmetric in dim "
                            f"{d} (use sweeps_per_call=1)")
            if problems:
                raise ValueError(
                    "periodic/Neumann BCs on the 'sharded_pallas' "
                    "method: " + "; ".join(problems))
        for d in range(len(self.axis_names)):
            if plan.interior_shape[d] < plan.halo:
                raise ValueError(
                    f"sharded dim {d}: the local extent "
                    f"{plan.interior_shape[d]} is below the exchange "
                    f"depth k*r = {plan.halo}; use a smaller -k or mesh")

    def iterate(self, grid: HaloGrid, iterations: int, mesh: Mesh,
                source=None, source_scale=1.0) -> HaloGrid:
        """``iterations`` sweeps of ``grid`` over ``mesh`` (its axes
        ``axis_names``): ``iterations // k`` outer steps and one launch of
        the remainder, on blocks scattered and gathered once. ``grid`` is
        unchanged; the result lies on ``grid``'s device."""
        plan = self.local_plan(self.mesh_shape(mesh))
        self._check(grid, source, plan)
        cur = self.scatter(grid, mesh)
        src = (self._scatter_source(plan, mesh, source, source_scale,
                                    grid.bc)
               if source is not None else None)
        cur = self.run_steps(mesh, cur, [block.clone() for block in cur],
                             grid.bc, iterations, src)
        return self.gather(cur, mesh, grid)

    def run_steps(self, mesh: Mesh, cur: List[torch.Tensor],
                  nxt: List[torch.Tensor], bc: DirichletBC,
                  iterations: int, src=None) -> List[torch.Tensor]:
        """``iterations`` sweeps of the scattered blocks ``cur`` (with
        ``nxt``, blocks of the same shape, as the other buffer; both are
        written): ``iterations // k`` outer steps and one launch of the
        remainder. Returns the blocks that hold the result, ``cur`` or
        ``nxt``. The weak-scaling harness times this, between one
        :meth:`scatter` and one :meth:`gather` (``scaling.py``)."""
        mesh_shape = self.mesh_shape(mesh)
        plan = self.local_plan(mesh_shape)
        if src is None:
            src = [None] * mesh.size
        pins = [self.pins(mesh, rank, bc) for rank in range(mesh.size)]
        split = self.splits(mesh_shape)
        if split:
            for dev in _cuda_devices(mesh):
                side = mesh.side_stream(dev)
                for block in cur + nxt:
                    if block.device == dev:
                        block.record_stream(side)
        parts = {}
        for lp in launch_plans(plan, *divmod(iterations,
                                             plan.sweeps_per_call)):
            if split and lp not in parts:
                parts[lp] = partition_tiles(lp)
            self.step(mesh, lp, cur, nxt, src, pins, bc, parts.get(lp))
            cur, nxt = nxt, cur
        return cur

    def step(self, mesh: Mesh, plan, cur, nxt, src, pins, bc: DirichletBC,
             parts=None) -> None:
        """One outer step of every rank, ``cur`` into ``nxt``: split into
        interior and edge launches around the exchange when ``parts``
        holds two non-empty column sets, else the exchange and one
        launch."""
        kernel = self.kernel(plan)
        ranks = range(mesh.size)
        if parts is None or not all(parts):
            self.exchange(mesh, cur, plan, bc)
            for r in ranks:
                kernel(cur[r], nxt[r], plan, src[r], pins[r])
            return
        interior, edge = parts
        devices = _cuda_devices(mesh)
        # the previous step's edge launches, which wrote cur
        ready = {dev: torch.cuda.current_stream(dev).record_event()
                 for dev in devices}
        for r in ranks:
            kernel(cur[r], nxt[r], plan, src[r], pins[r], subset=interior)
        with mesh.exchange_streams():
            for dev in devices:
                torch.cuda.current_stream(dev).wait_event(ready[dev])
            self.exchange(mesh, cur, plan, bc)
            done = {dev: torch.cuda.current_stream(dev).record_event()
                    for dev in devices}
        for dev in devices:
            torch.cuda.current_stream(dev).wait_event(done[dev])
        for r in ranks:
            kernel(cur[r], nxt[r], plan, src[r], pins[r], subset=edge)
