"""The device timeline of a traced slice, with its launches accounted for.

A fixed number of calls runs under ``torch.profiler`` with device activity
alone, bracketed by CUDA events: the host's operators are not profiled, so
a host-paced call is not slowed by the profiler's cost on each of them. The
profiler's Chrome trace is read whole: every kernel, memcpy and memset event
is a device interval. Two checks hold the timeline to what else is known,
and a failed check ends the run (:class:`TraceMismatch`), never a small
number:

- the events of the port's stencil kernels number exactly the launches its
  own counters saw over the slice, in total and on the march schedule;
- the device span of the events lies within the CUDA events' elapsed time
  around the slice, short of it only by the host's latency at its ends.

Busy time is the union of the device intervals. A second, shorter slice
runs with the host's activity too, each call in a harness span
(``record_function``); it only names the idle gaps by what the host was
doing when each opened, and its gaps are as long as they were under that
profiler.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset", "memcpy",
                     "memset")
HOST_SPAN_CATEGORY = "user_annotation"
HOST_OP_CATEGORY = "cpu_op"
# the device span may fall short of the CUDA events' elapsed time by the
# host's latency at the slice's two ends: at most this share of it, or
# SPAN_SLACK_MS, whichever is larger; it may exceed it by clock rounding
SPAN_SHORT_SHARE = 0.03
SPAN_SLACK_MS = 2.0
SPAN_OVER_MS = 0.05
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 96


class TraceMismatch(RuntimeError):
    """The trace disagrees with the program's counters or the CUDA
    events: the run gives no per-layer number."""


@dataclasses.dataclass(frozen=True)
class Interval:
    name: str
    start: float   # microseconds, the trace's clock
    end: float
    cat: str = ""


@dataclasses.dataclass
class Timeline:
    """A traced slice read from its Chrome trace."""

    device: List[Interval]
    spans: List[Interval]      # the harness's record_function spans
    host_ops: List[Interval]   # the host's operators

    @staticmethod
    def from_chrome(trace: dict) -> "Timeline":
        device, spans, host_ops = [], [], []
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = str(ev.get("cat", "")).lower()
            iv = Interval(str(ev.get("name", "")), float(ev["ts"]),
                          float(ev["ts"]) + float(ev["dur"]), cat)
            if cat in DEVICE_CATEGORIES:
                device.append(iv)
            elif cat == HOST_SPAN_CATEGORY:
                spans.append(iv)
            elif cat == HOST_OP_CATEGORY:
                host_ops.append(iv)
        device.sort(key=lambda iv: iv.start)
        return Timeline(device, spans, host_ops)

    def kernels_named(self, names: Sequence[str]) -> List[Interval]:
        return [iv for iv in self.device
                if any(n in iv.name for n in names)]


def union(intervals: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The merged (start, end) pairs covering ``intervals``."""
    merged: List[List[float]] = []
    for iv in sorted(intervals, key=lambda iv: iv.start):
        if merged and iv.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], iv.end)
        else:
            merged.append([iv.start, iv.end])
    return [(a, b) for a, b in merged]


class Outermost:
    """The outermost of a set of host intervals open at a time: those not
    inside another, which follow one another, found by bisection."""

    def __init__(self, intervals: Sequence[Interval]):
        self.top: List[Interval] = []
        for iv in sorted(intervals, key=lambda iv: (iv.start, -iv.end)):
            if not self.top or iv.start >= self.top[-1].end:
                self.top.append(iv)
        self.starts = [iv.start for iv in self.top]

    def at(self, t: float) -> Optional[Interval]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.top[i].end:
            return self.top[i]
        return None


def short_name(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name[:NAME_CHARS]


def idle_gaps(tl: Timeline) -> Dict[str, float]:
    """Seconds of device idle between the slice's first and last device
    event, summed by what the host was doing when each gap opened: the
    harness span open then and the outermost host operator inside it."""
    busy = union(tl.device)
    spans, ops = Outermost(tl.spans), Outermost(tl.host_ops)
    out: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        span, op = spans.at(end), ops.at(end)
        label = (span.name if span else "harness") \
            + (f": {op.name}" if op else "")
        out[label[:NAME_CHARS]] += (nxt - end) * 1e-6
    return out


def top(items: Dict[str, float]) -> List[list]:
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])
            [:BREAKDOWN_ENTRIES]]


@dataclasses.dataclass
class SliceTrace:
    """What a traced slice gave, in seconds."""

    calls: int
    slice_s: float          # CUDA events around the slice
    span_s: float           # first device event's start to last's end
    busy_s: float           # union of every device interval
    stencil_s: float        # summed time of the stencil kernels' events
    nonstencil_s: float     # summed time of every other device event
    stencil_events: int
    kernel_events: int      # device events that are kernels
    launches: Dict[str, int]  # the program's counters over the slice
    breakdown: dict
    labelled_calls: int = 0   # the slice that names the idle gaps
    labelled_s: float = 0.0   # its CUDA events, under the host's profiler

    def as_record(self) -> dict:
        return dataclasses.asdict(self)


def account(tl: Timeline, slice_ms: float, launches: Dict[str, int],
            stencil_names: Sequence[str], march_name: str,
            calls: int, labels: Optional[Timeline] = None) -> SliceTrace:
    """Check the timeline against the counters and the CUDA events and
    read it; the idle gaps are named from ``labels`` (a slice traced with
    the host's spans and operators), or from ``tl`` itself. Raises
    :class:`TraceMismatch` naming what disagrees."""
    stencil = tl.kernels_named(stencil_names)
    march = [iv for iv in stencil if march_name in iv.name]
    problems = []
    if len(stencil) != launches["launches"]:
        problems.append(
            f"{len(stencil)} stencil-kernel events ({', '.join(stencil_names)}"
            f") in the trace, {launches['launches']} launches counted by "
            "the program")
    if len(march) != launches["march_launches"]:
        problems.append(
            f"{len(march)} {march_name} events in the trace, "
            f"{launches['march_launches']} march launches counted")
    if not tl.device:
        problems.append("no device event in the trace")
        span_ms = 0.0
    else:
        span_ms = (max(iv.end for iv in tl.device)
                   - tl.device[0].start) * 1e-3
        short = max(SPAN_SHORT_SHARE * slice_ms, SPAN_SLACK_MS)
        if span_ms > slice_ms + SPAN_OVER_MS or span_ms < slice_ms - short:
            problems.append(
                f"the trace's device span {span_ms:.4f} ms against "
                f"{slice_ms:.4f} ms of CUDA events around the slice")
    if problems:
        raise TraceMismatch("the trace does not account for the slice: "
                            + "; ".join(problems))
    busy = sum(b - a for a, b in union(tl.device)) * 1e-6
    by_name: Dict[str, float] = defaultdict(float)
    for iv in tl.device:
        by_name[short_name(iv.name)] += (iv.end - iv.start) * 1e-6
    stencil_s = sum(iv.end - iv.start for iv in stencil) * 1e-6
    all_s = sum(iv.end - iv.start for iv in tl.device) * 1e-6
    return SliceTrace(
        calls=calls, slice_s=slice_ms * 1e-3, span_s=span_ms * 1e-3,
        busy_s=busy, stencil_s=stencil_s, nonstencil_s=all_s - stencil_s,
        stencil_events=len(stencil),
        kernel_events=sum(1 for iv in tl.device if iv.cat == "kernel"),
        launches=dict(launches),
        breakdown={"device_ops": top(by_name),
                   "idle_gaps": top(idle_gaps(labels or tl))})


def _chrome(prof) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slice.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


def trace_slice(call: Callable[[int], object], calls: int, label: str,
                device, counts: Callable[[], Dict[str, int]],
                stencil_names: Sequence[str], march_name: str,
                done: Callable[[int, object], None] = lambda i, out: None,
                label_calls: int = 1) -> SliceTrace:
    """Run ``call(i)`` for ``calls`` calls under the profiler with device
    activity alone, each followed by a synchronize, between two CUDA
    events; read and check the trace. One call is profiled first and
    thrown away, so that the profiler's own start does not fall into the
    slice. Then ``label_calls`` more calls run with the host's activity
    too, each in the harness span ``label`` and its synchronize in the
    span ``sync``, to name the idle gaps. ``done(i, out)`` follows each
    call; the calls outside the slice pass ``i = -1``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import counts_delta, synchronize

    device_only = [ProfilerActivity.CUDA]
    with profile(activities=device_only):
        done(-1, call(-1))
        synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    synchronize(device)
    before = counts()
    with profile(activities=device_only) as prof:
        start.record()
        for i in range(calls):
            out = call(i)
            synchronize(device)
            done(i, out)
        stop.record()
        synchronize(device)
    launches = counts_delta(before, counts())
    timeline = Timeline.from_chrome(_chrome(prof))

    lstart = torch.cuda.Event(enable_timing=True)
    lstop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, *device_only]) as lprof:
        lstart.record()
        for _ in range(label_calls):
            with record_function(label):
                out = call(-1)
            with record_function("sync"):
                synchronize(device)
            done(-1, out)
        lstop.record()
        synchronize(device)
    got = account(timeline, start.elapsed_time(stop), launches,
                  stencil_names, march_name, calls,
                  labels=Timeline.from_chrome(_chrome(lprof)))
    got.labelled_calls = label_calls
    got.labelled_s = lstart.elapsed_time(lstop) * 1e-3
    return got
