"""The port's spans and counters: where its own layers spend host time, and
what they count, for a traced run to read.

A span names one piece of work at a layer's boundary, ``<layer>.<what>``:
``runner.*`` in ``ops/sweep_kernel.py:KernelStencil.iterate``, ``cg.*`` in
``krylov.py:ConjugateGradient.solve``, ``mg.*`` in the multigrid cycle
(``mg.level<n>`` for each coarse level, holding every deeper one) and
``plan.make`` in ``ops/tiled.py:make_tiled_plan`` and
``ops/slab.py:make_slab_plan``. A counter counts events at the same
boundaries: ``host_syncs`` (every device-to-host read on those paths),
``cg_passes`` (CG's loop passes that run a matvec and a preconditioning
cycle; less the iterations, the masked ones) and ``plans_made``.

Tracing is off by default. Then :func:`span` returns one shared context
that does nothing (it reads no clock and allocates nothing) and
:func:`count` is one dict add, so the counters are exact either way, as the
kernels' launch counters are. :func:`enable` turns recording on: each span
keeps its name, its start and end on ``time.perf_counter_ns``, the index
of its parent and a call id that every span under one top-level span
shares (a solve or an iterate), in memory until :func:`drain`. While a
``torch.profiler`` is active a recorded span also enters
``torch.profiler.record_function``, so it lies in the profiler's trace on
the clock of the device's kernels, copies and fills.

The state is the process's, like the launch counters on the kernel
objects: one thread records at a time.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List


@dataclasses.dataclass
class Span:
    """One recorded span: nanoseconds on ``time.perf_counter_ns``,
    ``parent`` the index of the enclosing span in the same drain (-1 at the
    top), ``call`` the id its top-level span opened."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    call: int


class _NoSpan:
    """The span of a tracer that is off: enters and leaves, nothing else."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Recording:
    __slots__ = ("tracer", "name", "index", "annotation")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        t = self.tracer
        parent = t.open[-1] if t.open else -1
        if parent < 0:
            t.calls += 1
            call = t.calls
        else:
            call = t.spans[parent].call
        self.index = len(t.spans)
        t.open.append(self.index)
        self.annotation = None
        if _profiler_active():
            from torch.profiler import record_function

            self.annotation = record_function(self.name)
            self.annotation.__enter__()
        t.spans.append(Span(self.name, time.perf_counter_ns(), 0, parent,
                            call))
        return None

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        t = self.tracer
        t.spans[self.index].end_ns = end
        t.open.pop()
        return False


def _profiler_active() -> bool:
    import torch

    return torch.autograd._profiler_enabled()


class Tracer:
    """Counters, always counted, and spans, recorded while enabled."""

    def __init__(self):
        self.enabled = False
        self.counters: Dict[str, int] = defaultdict(int)
        self.spans: List[Span] = []
        self.open: List[int] = []
        self.calls = 0

    def drain(self) -> List[Span]:
        """The recorded spans, forgotten here; refused while a span is
        open, so that every parent index stays valid."""
        if self.open:
            raise RuntimeError(f"drain() inside {len(self.open)} open "
                               "span(s)")
        spans, self.spans = self.spans, []
        return spans


TRACER = Tracer()


def span(name: str):
    """A context that records the span ``name`` while tracing is on."""
    if not TRACER.enabled:
        return NO_SPAN
    return _Recording(TRACER, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, tracing on or off."""
    TRACER.counters[name] += n


def enable() -> None:
    TRACER.enabled = True


def disable() -> None:
    TRACER.enabled = False


def enabled() -> bool:
    return TRACER.enabled


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(TRACER.counters)


def drain() -> List[Span]:
    """Return the recorded spans and clear them."""
    return TRACER.drain()


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's own nanoseconds: its length less what its children
    cover (children of one span follow one another on one thread)."""
    own = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def totals(spans: List[Span]) -> Dict[str, Dict[str, int]]:
    """Per span name: its ``count``, inclusive ``ns`` and ``self_ns``."""
    out: Dict[str, Dict[str, int]] = {}
    for s, own in zip(spans, self_ns(spans)):
        row = out.setdefault(s.name, {"count": 0, "ns": 0, "self_ns": 0})
        row["count"] += 1
        row["ns"] += s.end_ns - s.start_ns
        row["self_ns"] += own
    return out
