"""Out-of-core streaming: grids larger than the card's memory.

Counterpart of ``stencil_tpu/streaming.py`` (``host_halo_grid``,
``_chunk_bounds``, ``auto_chunks``, ``StreamedStencil``). Host memory holds
the whole iterate, in two buffers that alternate per outer step, pinned
when the device is a card. Each outer step of k sweeps takes the grid one
d0 chunk at a time through the hand-written tiled kernel (B1,
``ops/tiled_kernel.py:tiled_sweep``), in one launch of k sweeps per chunk:

- **upload** (a copy stream): the chunk's interior planes with the k*r
  planes on each side that the previous outer iterate holds there, one
  contiguous copy out of the pinned source (and, on a periodic d0, the k*r
  planes from the far end of the grid, into the staging buffer's rows
  after them: :meth:`StreamedStencil._wrap_rows`);
- **compute** (the current stream): the chunk's padded buffer is filled
  from them as JAX's host-side ``_pad_chunk`` fills it (:226-296): face
  constants in increasing dim order, the interior and the neighbour
  planes (on a chunk-internal d0 face) or the wrapped or mirrored planes
  (on a periodic or Neumann d0 face) over the interior columns, then the
  periodic or Neumann d1/d2 rings at full depth over the whole extent of
  the other dims; then one launch of ``SweepKernel.__call__(cur, nxt, plan,
  None, pins)`` with the chunk's pins (0 on internal d0 faces and on
  dynamic dims, 1 on a physical Dirichlet face), and the interior core of
  its output copied into a contiguous staging buffer;
- **download** (a third stream): the core into the pinned destination.

CUDA events order the three: a chunk's compute waits for its upload, its
download for its compute, the upload into a staging buffer for the
download of that buffer's previous chunk, and an outer step's upload of
chunk c for the previous step's download of chunk c+1 (of the last chunk
on a periodic d0), whose planes it reads. So chunk c+1 uploads while chunk
c computes and chunk c-1 downloads (three staging buffers, so the two
copies run at once, one each way), with no host synchronisation until the
iterate returns; the device holds the three staging buffers and one
padded input and one padded output, the 5 chunk buffers
:func:`auto_chunks` provisions. The fill runs on the device (copies at
device bandwidth) rather than through a host copy of each chunk as JAX's
does; the padded buffer holds the same values.

Within one outer step every chunk reads the source buffer, so the result
is bitwise the in-core ``tiled`` method's at the same k: the same kernel,
the same per-point arithmetic, whichever schedule (march or window) and
tiles ``make_tiled_plan`` picks per chunk shape (base and tail, at most
two plans). A remainder of ``iterations % k`` sweeps runs one launch per
chunk of the base plans cut to that depth, on the same buffers.

Gates: the tiled kernel's own dynamic-wall gates
(``ops/sweep_kernel.py:check_dynamic_walls``: a dynamic lane dim needs
k=1, a Neumann dim at k>1 a mirror-symmetric spec), a dynamic dim at
least k*r deep, and JAX's chunk-depth gate (every chunk at least k*r
planes deep when there is more than one: a chunk-internal face within
k*r of a physical Dirichlet face would recompute pinned ghosts as data).
JAX's tap-mode gate has no counterpart (the port's one tap evaluator
reads the ghosts).

On a CPU device the same schedule runs with the kernel's plain version and
no streams.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, check_device, dtype_name, torch_dtype,
)
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.ops.layout import refresh_dynamic_layout
from stencil_tpu_torch.ops.sweep_kernel import check_dynamic_walls
from stencil_tpu_torch.ops.tiled import TiledPlan, make_tiled_plan
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

# staging buffers: chunk c+1 uploads into one while chunk c's input is
# filled from another and chunk c-1 downloads from the third
STAGES = 3
# device buffers of chunk size in flight (the staging buffers, one padded
# input, one padded output): what auto_chunks provisions for
CHUNK_BUFFERS = STAGES + 2
# the share of the device's memory the streamed buffers may take
MEMORY_SHARE = 0.4


def host_halo_grid(interior_shape, halo: int = 1,
                   bc: Optional[DirichletBC] = None, dtype="float32",
                   interior=None) -> HaloGrid:
    """A ``HaloGrid`` in host memory: the entry point of grids larger than
    the card's memory. Interior 0 (or ``interior``), halo the BC values."""
    ndim = len(interior_shape)
    if bc is None:
        bc = DirichletBC.reference_default(ndim)
    dt = torch_dtype(dtype)
    if interior is None:
        interior = torch.zeros(tuple(interior_shape), dtype=dt)
    else:
        interior = torch.as_tensor(interior).to(dt)
    return HaloGrid.from_interior(interior, halo=halo, bc=bc, device="cpu")


def _chunk_bounds(n0: int, chunks: int) -> Tuple[Tuple[int, int], ...]:
    """Near-equal chunk extents along d0, the first ``n0 % chunks`` one
    plane deeper."""
    base, extra = divmod(n0, chunks)
    bounds = []
    start = 0
    for c in range(chunks):
        stop = start + base + (1 if c < extra else 0)
        bounds.append((start, stop))
        start = stop
    return tuple(bounds)


def auto_chunks(spec: StencilSpec, interior_shape, dtype, sweeps_per_call,
                hbm: Optional[int] = None, device="cuda") -> int:
    """The least chunk count whose ``CHUNK_BUFFERS`` padded chunk buffers
    fit ``MEMORY_SHARE`` of the device's memory (``hbm``, default
    ``device_model.hbm_bytes(device)``). The padded chunk is the port's
    layout, k*r ghosts on every side (JAX's adds the TPU's lane rounding,
    so its count can be larger for the same memory)."""
    from stencil_tpu_torch import device_model

    n0, n1, n2 = interior_shape
    kr = sweeps_per_call * spec.radius
    itemsize = torch_dtype(dtype).itemsize
    p1, p2 = n1 + 2 * kr, n2 + 2 * kr
    memory = device_model.hbm_bytes(device) if hbm is None else hbm
    cap = int(MEMORY_SHARE * memory) // CHUNK_BUFFERS

    def chunk_bytes(c: int) -> int:
        b0 = -(-n0 // c)
        return (b0 + 2 * kr) * p1 * p2 * itemsize

    c = 1
    while chunk_bytes(c) > cap:
        c += 1
        if c > n0 or (c > 1 and n0 // c < max(kr, 1)):
            raise ValueError(
                f"grid {tuple(interior_shape)} ({dtype}) cannot be "
                f"streamed at temporal depth k={sweeps_per_call}: even "
                f"{c - 1} chunks exceed the device budget "
                f"({cap / 2**20:.2f} MiB/chunk) while chunks must stay "
                f">= k*r = {kr} planes; reduce -k or the grid")
    return c


class StreamedStencil:
    """Out-of-core d0-chunked iterate of a host-resident grid on
    ``device``. ``chunks=None`` sizes the count from the device's memory
    (:func:`auto_chunks`); ``tiles`` pins each chunk plan's tiles
    (:func:`~stencil_tpu_torch.ops.tiled.make_tiled_plan`)."""

    def __init__(self, spec: StencilSpec, interior_shape, dtype="float32",
                 sweeps_per_call: int = 1, chunks: Optional[int] = None,
                 tiles=None, device="cuda"):
        if spec.ndim != 3 or len(interior_shape) != 3:
            raise ValueError(
                "streamed method is 3D-only (it drives the tiled 3D "
                "kernel); 2D grids fit the slab path in-core")
        self.device = check_device(device)
        self.spec = spec
        self.interior_shape = tuple(int(s) for s in interior_shape)
        self.dtype = dtype_name(torch_dtype(dtype))
        self.k = int(sweeps_per_call)
        self._tiles = tiles
        n0 = self.interior_shape[0]
        if chunks is None:
            chunks = auto_chunks(spec, self.interior_shape, self.dtype,
                                 self.k, device=self.device)
        chunks = int(chunks)
        if chunks < 1 or chunks > n0:
            raise ValueError(f"chunks={chunks} out of range [1, {n0}]")
        kr = self.k * spec.radius
        if chunks > 1 and n0 // chunks < kr:
            raise ValueError(
                f"chunk depth {n0 // chunks} < k*r = {kr}: a chunk-"
                "internal face within k*r of a physical face would "
                "recompute pinned Dirichlet ghosts as data; use fewer "
                "chunks or a shallower -k")
        self.num_chunks = chunks
        self.bounds = _chunk_bounds(n0, chunks)
        self._plans = self._build_plans()
        self._buffers = None
        self._host = None

    def _build_plans(self) -> Tuple[TiledPlan, ...]:
        """One plan per distinct chunk depth (at most two: base and
        tail), mapped per chunk."""
        cache = {}
        plans = []
        for start, stop in self.bounds:
            c0 = stop - start
            if c0 not in cache:
                cache[c0] = make_tiled_plan(
                    self.spec, (c0,) + self.interior_shape[1:], self.dtype,
                    self.k, tiles=self._tiles)
            plans.append(cache[c0])
        return tuple(plans)

    @property
    def plan(self) -> TiledPlan:
        """The base chunk's plan (the CLI's ``plan_info``)."""
        return self._plans[0]

    @property
    def plans(self) -> Tuple[TiledPlan, ...]:
        """Each chunk's plan."""
        return self._plans

    @property
    def halo(self) -> int:
        """Ghost depth of every chunk buffer, k*r."""
        return self.k * self.spec.radius

    def transfer_bytes(self) -> Tuple[int, int]:
        """(bytes uploaded, bytes downloaded) per outer step on Dirichlet
        or Neumann walls: each chunk's planes with their in-grid ghost
        planes up, its interior down."""
        n0, n1, n2 = self.interior_shape
        plane = n1 * n2 * torch_dtype(self.dtype).itemsize
        up = sum(min(n0, stop + self.halo) - max(0, start - self.halo)
                 for start, stop in self.bounds)
        return up * plane, n0 * plane

    # -- gates --------------------------------------------------------------

    def _validate_bc(self, bc: DirichletBC, k: int) -> None:
        """The tiled kernel's gates at depth k, then the depth of the
        dynamic dims."""
        check_dynamic_walls(self.plan.with_sweeps(k), bc)
        dyn = bc.dynamic_mask(3)
        kr = k * self.spec.radius
        shallow = [f"dynamic dim {d} needs interior extent >= k*r "
                   f"({self.interior_shape[d]} < {kr})"
                   for d in range(3)
                   if dyn[d] and self.interior_shape[d] < kr]
        if shallow:
            raise ValueError("periodic/Neumann BCs on the streamed method: "
                             + "; ".join(shallow))

    def chunk_pins(self, ci: int, bc: DirichletBC) -> Tuple[int, ...]:
        """(d0 lo, d0 hi, d1 lo, d1 hi) of chunk ``ci``: 0 on
        chunk-internal d0 faces and on dynamic dims, 1 on physical
        Dirichlet faces."""
        dyn = bc.dynamic_mask(3)
        lo = 0 if (dyn[0] or ci > 0) else 1
        hi = 0 if (dyn[0] or ci < self.num_chunks - 1) else 1
        d1 = 0 if dyn[1] else 1
        return (lo, hi, d1, d1)

    # -- buffers --------------------------------------------------------------

    def _staged_rows(self, ci: int) -> Tuple[int, int]:
        """The global d0 rows [lo, hi) chunk ``ci`` uploads: its planes
        and the k*r planes on each side that lie within the grid."""
        start, stop = self.bounds[ci]
        return max(0, start - self.halo), min(self.interior_shape[0],
                                              stop + self.halo)

    def _wrap_rows(self, ci: int) -> Tuple[Optional[int], Optional[int]]:
        """On a periodic d0, the first staging row of the grid's last k*r
        planes (chunk 0's lo ghosts) and of its first k*r (the last chunk's
        hi ghosts), right after the chunk's staged planes; None where the
        chunk has no such face. An end chunk stages k*r planes fewer on
        its physical face, and a staging buffer holds 2*k*r planes beyond
        the deepest chunk (chunk 0), so the wraps fit."""
        lo_g, hi_g = self._staged_rows(ci)
        used = hi_g - lo_g
        lo = used if ci == 0 else None
        hi = (used + (self.halo if ci == 0 else 0)
              if ci == self.num_chunks - 1 else None)
        return lo, hi

    def _device_buffers(self):
        """``STAGES`` staging buffers of the deepest chunk with its ghost
        planes (contiguous, unpadded in d1/d2), and one padded input and
        output of the deepest chunk (a shallower chunk takes leading
        views), allocated once."""
        if self._buffers is None:
            _, n1, n2 = self.interior_shape
            h = self.halo
            c0 = max(stop - start for start, stop in self.bounds)
            dt = torch_dtype(self.dtype)
            dev = self.device
            stage = [torch.empty((c0 + 2 * h, n1, n2), dtype=dt, device=dev)
                     for _ in range(STAGES)]
            padded = (c0 + 2 * h, n1 + 2 * h, n2 + 2 * h)
            cur = torch.empty(padded, dtype=dt, device=dev)
            nxt = torch.empty(padded, dtype=dt, device=dev)
            self._buffers = (stage, cur, nxt)
        return self._buffers

    def _host_buffers(self):
        """The two host iterates, pinned on a card, allocated once."""
        if self._host is None:
            pin = self.device.type == "cuda"
            dt = torch_dtype(self.dtype)
            self._host = [torch.empty(self.interior_shape, dtype=dt,
                                      pin_memory=pin) for _ in range(2)]
        return self._host

    # -- one outer step -------------------------------------------------------

    def _fill(self, cur: torch.Tensor, plan: TiledPlan, ci: int,
              stage: torch.Tensor, bc: DirichletBC) -> None:
        """Chunk ``ci``'s padded input from its staged planes and, on a
        periodic d0, its wrapped planes: JAX's ``_pad_chunk`` on the
        device."""
        start, stop = self.bounds[ci]
        _, n1, n2 = self.interior_shape
        c0 = stop - start
        h = self.halo
        lo_g, hi_g = self._staged_rows(ci)
        wrap_lo, wrap_hi = self._wrap_rows(ci)
        # face constants per dim in increasing dim order (later dims win in
        # the corners), as PaddedLayout.pad fills them
        for d in range(3):
            lo_v, hi_v = bc.values[d]
            n = cur.shape[d]
            cur[tuple(slice(0, h) if i == d else slice(None)
                      for i in range(3))] = lo_v
            cur[tuple(slice(n - h, None) if i == d else slice(None)
                      for i in range(3))] = hi_v
        cols = (slice(h, h + n1), slice(h, h + n2))
        # the interior and the previous iterate's planes within the grid
        cur[(slice(h - (start - lo_g), h + c0 + (hi_g - stop)),) + cols] = \
            stage[:hi_g - lo_g]
        per, neu = bc.periodic_mask(3), bc.neumann_mask(3)
        if ci == 0 and (per[0] or neu[0]):
            cur[(slice(0, h),) + cols] = (
                stage[wrap_lo:wrap_lo + h] if per[0] else torch.flip(cur[(slice(h, 2 * h),)
                                                      + cols], dims=(0,)))
        last = h + c0
        if ci == self.num_chunks - 1 and (per[0] or neu[0]):
            cur[(slice(last, last + h),) + cols] = (
                stage[wrap_hi:wrap_hi + h] if per[0] else torch.flip(
                    cur[(slice(last - h, last),) + cols], dims=(0,)))
        # the d1/d2 rings at full depth, after the d0 planes
        if any(bc.dynamic_mask(3)[1:]):
            ring_bc = DirichletBC(values=bc.values,
                                  periodic=(False,) + tuple(per[1:]),
                                  neumann=(False,) + tuple(neu[1:]))
            refresh_dynamic_layout(cur, plan.layout, ring_bc, h)

    def _outer_steps(self, src: torch.Tensor, dst: torch.Tensor,
                     plans, bc: DirichletBC, steps: int,
                     rem: int = 0) -> torch.Tensor:
        """``steps`` outer steps of the plans' depth, then one of ``rem``
        sweeps, ping-ponging the host buffers ``src`` and ``dst``; returns
        the buffer holding the result (synchronised)."""
        stage, cur_buf, nxt_buf = self._device_buffers()
        n0 = self.interior_shape[0]
        h = self.halo
        per0 = bc.periodic_mask(3)[0]
        cuda = self.device.type == "cuda"
        if cuda:
            compute = torch.cuda.current_stream(self.device)
            up = torch.cuda.Stream(self.device)
            down = torch.cuda.Stream(self.device)
        C = self.num_chunks
        pins = [self.chunk_pins(ci, bc) for ci in range(C)]
        freed = [None] * STAGES  # each staging buffer's last download
        prev_down = None       # the previous outer step's download events
        count = 0
        step_plans = [plans] * steps
        if rem:
            step_plans.append([p.with_sweeps(rem) for p in plans])
        for sp in step_plans:
            down_events = []
            for ci, plan in enumerate(sp):
                start, stop = self.bounds[ci]
                c0 = stop - start
                slot = count % STAGES
                count += 1
                lo_g, hi_g = self._staged_rows(ci)
                wrap_lo, wrap_hi = self._wrap_rows(ci)
                with (torch.cuda.stream(up) if cuda
                      else contextlib.nullcontext()):
                    if cuda:
                        if freed[slot] is not None:
                            up.wait_event(freed[slot])
                        if prev_down is not None:
                            # the planes this chunk reads were written by
                            # the previous step's downloads up to chunk
                            # ci + 1 (the last, for a periodic wrap)
                            up.wait_event(prev_down[
                                C - 1 if per0 else min(ci + 1, C - 1)])
                    stage[slot][:hi_g - lo_g].copy_(src[lo_g:hi_g],
                                                    non_blocking=cuda)
                    if per0 and wrap_lo is not None:
                        stage[slot][wrap_lo:wrap_lo + h].copy_(
                            src[n0 - h:], non_blocking=cuda)
                    if per0 and wrap_hi is not None:
                        stage[slot][wrap_hi:wrap_hi + h].copy_(
                            src[:h], non_blocking=cuda)
                    uploaded = up.record_event() if cuda else None
                if cuda:
                    compute.wait_event(uploaded)
                p0 = c0 + 2 * h
                cur, nxt = cur_buf[:p0], nxt_buf[:p0]
                self._fill(cur, plan, ci, stage[slot], bc)
                tiled_sweep(cur, nxt, plan, None, pins[ci])
                core = stage[slot][:c0]
                core.copy_(nxt[h:h + c0, h:-h, h:-h])
                with (torch.cuda.stream(down) if cuda
                      else contextlib.nullcontext()):
                    if cuda:
                        down.wait_event(compute.record_event())
                    dst[start:stop].copy_(core, non_blocking=cuda)
                    if cuda:
                        freed[slot] = down.record_event()
                        down_events.append(freed[slot])
            prev_down = down_events
            src, dst = dst, src
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(down)
            torch.cuda.synchronize(self.device)
        return src

    # -- iteration ------------------------------------------------------------

    def _run(self, x0, iterations: int, bc: DirichletBC) -> torch.Tensor:
        """The result in one of the host buffers (overwritten by the next
        run)."""
        x0 = torch.as_tensor(x0)
        if tuple(x0.shape) != self.interior_shape:
            raise ValueError(
                f"interior shape {tuple(x0.shape)} != plan shape "
                f"{self.interior_shape}")
        steps, rem = divmod(int(iterations), self.k)
        self._validate_bc(bc, self.k)
        if rem:
            self._validate_bc(bc, rem)
        src, dst = self._host_buffers()
        src.copy_(x0)
        return self._outer_steps(src, dst, self._plans, bc, steps, rem)

    def iterate_host(self, x0, iterations: int,
                     bc: Optional[DirichletBC] = None) -> torch.Tensor:
        """``iterations`` sweeps of the host interior ``x0`` (array or
        tensor); returns the new interior as a CPU tensor. A remainder of
        ``iterations % k`` sweeps runs as one shallower outer step."""
        if bc is None:
            bc = DirichletBC.reference_default(3)
        return self._run(x0, iterations, bc).clone()

    def iterate(self, grid: HaloGrid, iterations: int) -> HaloGrid:
        """The registry's iterate: a grid in (host or device), a host grid
        out; the whole grid never lies on the device."""
        if grid.dtype != torch_dtype(self.dtype):
            raise ValueError(
                f"grid dtype {grid.dtype} != plan dtype {self.dtype}")
        out = self._run(grid.interior(), iterations, grid.bc)
        return host_halo_grid(self.interior_shape, halo=grid.halo,
                              bc=grid.bc, dtype=self.dtype, interior=out)
