"""The single-controller device mesh and its ``ppermute``.

Counterpart of ``jax.sharding.Mesh`` with ``stencil_tpu/parallel/halo.py:
make_mesh`` (:85-101) and of ``lax.ppermute``/``axis_index``/``axis_size``
inside ``shard_map``. As JAX's ``shard_map`` does, one process drives every
rank of the mesh: each rank's block is a tensor of its own, rank ``i`` on
``devices[i % len(devices)]``.

- On one H100 every rank sits on ``cuda:0``, and a ``ppermute`` becomes a
  device-to-device copy of a strip view into the neighbour's ghost band.
  Such a mesh measures the exchange and the interior/edge phase split, not
  a speed-up: the ranks share the card's SMs and HBM (PERF.md §7).
- On several cards of one host the same copies are peer copies.
- On the CPU they are plain copies, so the tests compare the port with
  JAX's CPU mesh in one process.

A mesh may hold more ranks than there are devices, where JAX's
``make_mesh`` refuses: several ranks per card is what lets one H100 run a
(2, 2) mesh.

The exchange runs on a side stream per device (:meth:`Mesh.side_stream`,
entered together by :meth:`Mesh.exchange_streams`), ordered against the
kernels by events, so that it can overlap the interior launches of the
sharded kernel step (``parallel/sharded_kernel.py``). ``torch.distributed``
is not used: a multi-host backend for the same interface is later work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from stencil_tpu_torch.core.grid import check_device
from stencil_tpu_torch.parallel import comm_audit


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A row-major mesh of ``math.prod(shape)`` ranks with named axes; rank
    ``i`` on ``devices[i]``. Build one with :func:`make_mesh`."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]
    _streams: Dict[torch.device, object] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def coords(self, rank: int) -> Tuple[int, ...]:
        """The rank's index along each axis (row-major, as JAX's mesh)."""
        out = []
        for n in reversed(self.shape):
            rank, i = divmod(rank, n)
            out.append(i)
        return tuple(reversed(out))

    def rank(self, coords: Sequence[int]) -> int:
        r = 0
        for i, n in zip(coords, self.shape):
            r = r * n + i
        return r

    def axis_index(self, rank: int, name: str) -> int:
        return self.coords(rank)[self.axis_names.index(name)]

    def ppermute(self, strips: Sequence[torch.Tensor], axis: str,
                 perm: Sequence[Tuple[int, int]]
                 ) -> List[Optional[torch.Tensor]]:
        """``lax.ppermute`` over ``axis``: ``strips[rank]`` is what each
        rank sends; ``perm`` holds (source, destination) indices along the
        axis. Returns what each rank receives, the sender's own tensor (on
        the sender's device: the caller copies it where it belongs), or
        None where no pair names the rank, which JAX's open chain fills
        with zeros. With a :func:`~stencil_tpu_torch.parallel.comm_audit.
        audit` active, the call records one rank's strip."""
        a = self.axis_names.index(axis)
        source_of = {dst: src for src, dst in perm}
        comm_audit.record(axis, strips[0])
        received = []
        for rank in range(self.size):
            coords = list(self.coords(rank))
            src = source_of.get(coords[a])
            if src is None:
                received.append(None)
                continue
            coords[a] = src
            received.append(strips[self.rank(coords)])
        return received

    def side_stream(self, device: torch.device):
        """The exchange's stream on a CUDA ``device``, made on first use."""
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    @contextlib.contextmanager
    def exchange_streams(self) -> Iterator[None]:
        """Make each CUDA device's side stream current inside the block (a
        cross-device copy then orders itself on both ends); nothing on the
        CPU."""
        with contextlib.ExitStack() as stack:
            for dev in dict.fromkeys(self.devices):
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.stream(
                        self.side_stream(dev)))
            yield


def default_mesh_shape(device) -> Tuple[int]:
    """A method's mesh when ``--mesh`` is not given: one rank per visible
    CUDA device, as JAX's is one per device (``stencil_tpu/registry.py:
    296-299``); (1,) on one H100 and on the CPU."""
    dev = torch.device(device)
    return (max(1, torch.cuda.device_count()) if dev.type == "cuda"
            else 1,)


def make_mesh(axis_sizes: Sequence[int],
              axis_names: Optional[Sequence[str]] = None,
              device="cuda") -> Mesh:
    """A mesh of ``axis_sizes`` (names default ``d0``, ``d1``, ...) over
    every visible CUDA device when ``device`` is a CUDA one, else over
    ``device`` alone; rank i on device i modulo their count."""
    sizes = tuple(int(n) for n in axis_sizes)
    if axis_names is None:
        axis_names = tuple(f"d{i}" for i in range(len(sizes)))
    axis_names = tuple(axis_names)
    if len(axis_names) != len(sizes):
        raise ValueError(f"mesh shape {sizes} does not match axis names "
                         f"{axis_names}")
    if any(n < 1 for n in sizes):
        raise ValueError(f"mesh shape {sizes}: every axis needs >= 1 rank")
    dev = check_device(device)
    pool = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    n = math.prod(sizes)
    return Mesh(shape=sizes, axis_names=axis_names,
                devices=tuple(pool[i % len(pool)] for i in range(n)))
