"""Communication audit: what the halo exchange moves, counted as it runs.

Counterpart of ``stencil_tpu/parallel/comm_audit.py``. JAX walks the jaxpr
of a jitted step and lists its collectives; PyTorch runs eagerly and has no
such graph, so the port counts instead: while an :func:`audit` is active,
every ``Mesh.ppermute`` (``parallel/mesh.py``) records its axis, the shape
and dtype of one rank's strip and its bytes, the per-rank payload the JAX
audit reads from a ``ppermute``'s aval. The property the weak-scaling
claim rests on can then be asserted exactly: one outer step of the sharded
kernel path moves ``2 * k * r`` ghost planes per sharded dim, bytes of the
local block's geometry only, whatever the mesh size
(``tests/test_torch_comm_volume.py``).

The distributed solvers (``parallel/sharded_field.py``) also gather a
level into its replicated copies and sum dot products over the ranks: each
such call records an all-gather or an all-reduce, the counterparts of the
``all-gather`` and ``all-reduce`` counts of JAX's ``audit_gspmd``
(``stencil_tpu/parallel/comm_audit.py:88``). JAX reads them from the
compiled graph, once per program; here they are counted as the code runs,
once per call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One ``ppermute``: the mesh axis, and one rank's strip."""

    axis: str
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


@dataclasses.dataclass(frozen=True)
class Collective:
    """One all-gather or all-reduce: its kind, the mesh axes it spans and
    one rank's result."""

    kind: str
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass
class CommAudit:
    """The transfers (``ppermute`` strips) and the other collectives
    recorded while the audit was active, in order."""

    transfers: List[Transfer] = dataclasses.field(default_factory=list)
    collectives: List[Collective] = dataclasses.field(default_factory=list)

    def count(self, kind: str) -> int:
        """The recorded collectives of ``kind`` (``all-gather``,
        ``all-reduce``)."""
        return sum(c.kind == kind for c in self.collectives)

    @property
    def all_gather_count(self) -> int:
        return self.count("all-gather")

    @property
    def all_reduce_count(self) -> int:
        return self.count("all-reduce")

    @property
    def ppermute_count(self) -> int:
        return len(self.transfers)

    @property
    def ppermute_bytes(self) -> int:
        """Per-rank payload bytes of every recorded ``ppermute``."""
        return sum(t.nbytes for t in self.transfers)


_ACTIVE: List[CommAudit] = []


@contextlib.contextmanager
def audit() -> Iterator[CommAudit]:
    """Record every ``ppermute`` and collective run inside the block
    (nesting allowed)."""
    rec = CommAudit()
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)


def record(axis: str, strip: torch.Tensor) -> None:
    """Called by ``Mesh.ppermute`` with one rank's strip."""
    for rec in _ACTIVE:
        rec.transfers.append(Transfer(axis, tuple(strip.shape), strip.dtype))


def record_collective(kind: str, axes, result: torch.Tensor) -> None:
    """Called by ``parallel/sharded_field.py`` with one rank's result of an
    all-gather or all-reduce over the mesh ``axes``."""
    for rec in _ACTIVE:
        rec.collectives.append(Collective(kind, tuple(axes),
                                          tuple(result.shape), result.dtype))
