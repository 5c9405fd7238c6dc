"""The program's own spans and counters in a traced run.

The program records spans and counters of its layers
(``stencil_tpu_torch/utils/tracing.py``: ``runner.*``, ``cg.*``, ``mg.*``,
``plan.make``; ``host_syncs``, ``plans_made``). Tracing is off in the
window and in the harness's slices (``trace.py``), which do not turn it
on. The metrics that read spans share two passes of their own, run once
per traced run by the first of them to be read, after everything else, on
a fresh set-up of the cell from the run's seed:

- a spans pass: as many calls as the traced slice (``trace_calls`` or
  ``trace_solves``) with tracing on, each after one with it off, no
  profiler. Per call: each span name's count, inclusive and self host ms,
  and the counters' deltas; the median span on CUDA events of the calls
  with tracing on (``spans_call_ms``) and off, whose difference is what
  tracing costs when on;
- a naming pass: ``trace_label_calls`` calls under the profiler with host
  and device activity, tracing on, each call in the harness's span and its
  synchronize in ``sync``, as in the harness's naming slice. Each device
  event is put down to the innermost program span open at its launch (the
  host's runtime call with the same ``correlation``), and each idle gap is
  named by the harness span, the innermost program span and the outermost
  host operator open when it opened. In a relaxation cell the kernels put
  down to ``runner.launch`` must be exactly the stencil-kernel launches the
  program counted over the pass (:class:`trace.TraceMismatch` otherwise).

Both passes print what they found on standard error (``# spans ...``);
each reader returns one number. Where the program has no tracing module,
or the run is not ``benchmark/run.py``'s, there is nothing to read.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from benchmark import harness
from benchmark.trace import (
    DEVICE_CATEGORIES, HOST_OP_CATEGORY, HOST_SPAN_CATEGORY, NAME_CHARS,
    Interval, Outermost, TraceMismatch, _chrome, top, union,
)

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
LEVEL_PREFIX = "mg.level"
RUNNER_COPIES = ("runner.pad", "runner.clone", "runner.refresh",
                 "runner.unpad", "runner.from_interior")
HARNESS_LABELS = {"relax": "iterate", "solve": "solve"}
SEP = " › "


def is_program_span(name: str) -> bool:
    """The program names its spans ``<layer>.<what>``; the harness's
    (``solve``, ``iterate``, ``sync``) have no dot."""
    return "." in name


# ---- the naming pass's Chrome trace ----

@dataclasses.dataclass
class ProgramTrace:
    """A Chrome trace read for the program's spans: the harness's spans,
    the program's (with each one's parent), the host's operators, the
    device's events and the host time of each launch by correlation id."""

    harness: List[Interval]
    spans: List[Interval]          # sorted by start, outer first
    parents: List[int]
    host_ops: List[Interval]
    device: List[Interval]
    correlation: List[Optional[int]]   # of each device event
    launched: Dict[int, float]         # correlation -> the launch's start

    @staticmethod
    def from_chrome(trace: dict) -> "ProgramTrace":
        harness_spans, spans, host_ops, device, corr = [], [], [], [], []
        launched: Dict[int, float] = {}
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = str(ev.get("cat", "")).lower()
            iv = Interval(str(ev.get("name", "")), float(ev["ts"]),
                          float(ev["ts"]) + float(ev["dur"]), cat)
            c = (ev.get("args") or {}).get("correlation")
            if cat in DEVICE_CATEGORIES:
                device.append(iv)
                corr.append(None if c is None else int(c))
            elif cat in LAUNCH_CATEGORIES and c is not None:
                launched[int(c)] = iv.start
            elif cat == HOST_SPAN_CATEGORY:
                (spans if is_program_span(iv.name)
                 else harness_spans).append(iv)
            elif cat == HOST_OP_CATEGORY:
                host_ops.append(iv)
        spans.sort(key=lambda iv: (iv.start, -iv.end))
        order = sorted(range(len(device)), key=lambda i: device[i].start)
        return ProgramTrace(harness_spans, spans, nest(spans), host_ops,
                            [device[i] for i in order],
                            [corr[i] for i in order], launched)

    def __post_init__(self):
        self.starts = [s.start for s in self.spans]

    def innermost(self, t: Optional[float]) -> int:
        """The index of the innermost program span open at ``t``, or -1
        (also for ``t`` None)."""
        if t is None:
            return -1
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and not t < self.spans[i].end:
            i = self.parents[i]
        return i

    def chain(self, i: int) -> List[int]:
        """Span ``i`` and its ancestors, innermost first."""
        out = []
        while i >= 0:
            out.append(i)
            i = self.parents[i]
        return out

    def owners(self) -> List[int]:
        """The program span each device event is put down to: the
        innermost one open at its launch; -1 where none was open or the
        trace holds no launch of its correlation id."""
        return [self.innermost(self.launched.get(c)) for c in
                self.correlation]


def nest(spans: Sequence[Interval]) -> List[int]:
    """The parent index of each of ``spans`` (sorted by start, outer
    first; one thread's spans, which nest), -1 at the top."""
    parents, open_ = [], []
    for i, s in enumerate(spans):
        while open_ and not s.start < spans[open_[-1]].end:
            open_.pop()
        parents.append(open_[-1] if open_ else -1)
        open_.append(i)
    return parents


def device_by_span(pt: ProgramTrace, calls: int) -> Dict[str, list]:
    """Per program span name, the device ms per call and the events per
    call put down to it (``(none)``: to no program span)."""
    ms: Dict[str, float] = defaultdict(float)
    n: Dict[str, int] = defaultdict(int)
    for ev, i in zip(pt.device, pt.owners()):
        name = pt.spans[i].name if i >= 0 else "(none)"
        ms[name] += (ev.end - ev.start) * 1e-3
        n[name] += 1
    return {k: [ms[k] / calls, n[k] / calls]
            for k in sorted(ms, key=lambda k: -ms[k])}


def device_ms_under(pt: ProgramTrace, prefix: str, calls: int
                    ) -> Optional[float]:
    """Device ms per call of the events put down to a span named
    ``prefix...`` or to one of its children (the union of their
    intervals); None where the trace holds no such span."""
    if not any(s.name.startswith(prefix) for s in pt.spans):
        return None
    mine = [ev for ev, i in zip(pt.device, pt.owners())
            if any(pt.spans[j].name.startswith(prefix)
                   for j in pt.chain(i))]
    return sum(b - a for a, b in union(mine)) * 1e-3 / calls


def span_label(pt: ProgramTrace, i: int) -> str:
    """The innermost program span ``i``, after the multigrid level that
    holds it where it lies inside one."""
    if i < 0:
        return ""
    name = pt.spans[i].name
    if not name.startswith(LEVEL_PREFIX):
        for j in pt.chain(i)[1:]:
            if pt.spans[j].name.startswith(LEVEL_PREFIX):
                return pt.spans[j].name + SEP + name
    return name


def named_gaps(pt: ProgramTrace) -> Dict[str, float]:
    """Seconds of device idle between the first and last device event,
    summed by what the host was doing when each gap opened: the harness
    span, the innermost program span and the outermost host operator."""
    busy = union(pt.device)
    outer, ops = Outermost(pt.harness), Outermost(pt.host_ops)
    out: Dict[str, float] = defaultdict(float)
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        h, op = outer.at(end), ops.at(end)
        parts = [h.name if h else "harness",
                 span_label(pt, pt.innermost(end))]
        label = SEP.join(p for p in parts if p) + (f": {op.name}" if op
                                                   else "")
        out[label[:NAME_CHARS]] += (nxt - end) * 1e-6
    return out


def check_launch_spans(pt: ProgramTrace, launches: int,
                       stencil_names: Sequence[str]) -> None:
    """The kernels put down to ``runner.launch`` are the stencil kernels,
    as many as the program counted; raises :class:`TraceMismatch`."""
    stencil = [any(n in ev.name for n in stencil_names) for ev in pt.device]
    owned = [i >= 0 and pt.spans[i].name == "runner.launch"
             for i in pt.owners()]
    under = sum(o for o, ev in zip(owned, pt.device) if ev.cat == "kernel")
    problems = []
    if under != launches:
        problems.append(f"{under} kernels put down to runner.launch, "
                        f"{launches} launches counted by the program")
    strays = sum(s != o for s, o in zip(stencil, owned))
    if strays:
        problems.append(f"{strays} device events are stencil kernels "
                        "outside runner.launch or other events inside it")
    if problems:
        raise TraceMismatch("the program's spans do not account for the "
                            "launches: " + "; ".join(problems))


# ---- the passes ----

def tracing_module():
    """The program's tracing module, or None where it has none."""
    try:
        from stencil_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def host_table(tracing, spans, calls: int) -> Dict[str, dict]:
    """Per span name, per call: count, inclusive ms, self ms."""
    return {name: {"count": row["count"] / calls,
                   "ms": row["ns"] * 1e-6 / calls,
                   "self_ms": row["self_ns"] * 1e-6 / calls}
            for name, row in tracing.totals(spans).items()}


def _relax_call(drv, ctx) -> Callable[[], object]:
    state = drv.prepare(ctx)
    cur = {"grid": state.grid0}

    def call():
        cur["grid"] = drv.advance(state, cur["grid"])
        return cur["grid"]

    return call


def _solve_call(drv, ctx) -> Callable[[], object]:
    state = drv.prepare(ctx)
    picks = itertools.cycle(range(state.pool.shape[0]))
    return lambda: drv.solve(state, next(picks))


def measure(ctx: harness.Context, window_call_ms: Optional[float] = None
            ) -> Optional[dict]:
    """Both passes on the cell of ``ctx``; None where the program has no
    tracing module."""
    tracing = tracing_module()
    if tracing is None:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if tracing.enabled() or tracing.drain():
        raise harness.BenchmarkError(
            "the program recorded spans before the spans pass: tracing "
            "was on in the window")
    tr = ctx.cell.traffic
    kind = tr["driver"]
    drv = harness.load_driver(ctx.cell)
    call = {"relax": _relax_call, "solve": _solve_call}[kind](drv, ctx)
    calls = int(tr.get("trace_calls", tr.get("trace_solves", 1)))
    label_calls = int(tr.get("trace_label_calls", 1))
    device = ctx.device
    cuda = getattr(device, "type", str(device)) == "cuda"
    call()                                   # steady state
    harness.synchronize(device)

    timer = harness.CallTimer(device)

    def timed():
        timer.start()
        call()
        timer.stop()
        harness.synchronize(device)
        return timer.ms()

    off_ms, on_ms = [], []
    before = tracing.counters()
    for _ in range(calls):          # in turns: tracing off, then on
        off_ms.append(timed())
        tracing.enable()
        try:
            on_ms.append(timed())
        finally:
            tracing.disable()
    after = tracing.counters()
    spans = tracing.drain()
    got = {"calls": calls, "host": host_table(tracing, spans, calls),
           "counters": {k: (v - before.get(k, 0)) / (2 * calls)
                        for k, v in after.items()
                        if v != before.get(k, 0)},
           "spans_call_ms": statistics.median(on_ms),
           "off_call_ms": statistics.median(off_ms),
           "window_call_ms": window_call_ms, "label_calls": label_calls}

    if cuda:
        from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

        launches0 = tiled_sweep.launches
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        tracing.enable()
        try:
            with profile(activities=acts) as prof:
                start.record()
                for _ in range(label_calls):
                    with record_function(HARNESS_LABELS[kind]):
                        call()
                    with record_function("sync"):
                        harness.synchronize(device)
                stop.record()
                harness.synchronize(device)
        finally:
            tracing.disable()
            tracing.drain()
        launches = tiled_sweep.launches - launches0
        pt = ProgramTrace.from_chrome(_chrome(prof))
        got["labelled_call_ms"] = start.elapsed_time(stop) / label_calls
        got["device"] = device_by_span(pt, label_calls)
        got["level_device_ms"] = device_ms_under(pt, LEVEL_PREFIX,
                                                 label_calls)
        gaps = named_gaps(pt)
        got["idle_gaps"] = top(gaps)
        got["idle_ms"] = sum(gaps.values()) * 1e3 / label_calls
        got["harness_alone_ms"] = gaps.get(HARNESS_LABELS[kind], 0.0) \
            * 1e3 / label_calls
        got["busy_ms"] = sum(b - a for a, b in union(pt.device)) * 1e-3 \
            / label_calls
        if kind == "relax":
            check_launch_spans(pt, launches, harness.kernel_names(
                tiled_sweep))
    del call
    harness.release(device)
    return got


def report(got: dict, file=None) -> None:
    """What the passes found, on ``file`` (standard error) as ``# spans``
    lines."""
    file = file or sys.stderr

    def r(x):
        return round(x, 4) if isinstance(x, float) else x

    print(f"# spans: {got['calls']} calls in turns, median ms per call "
          f"tracing on (spans_call_ms) {got['spans_call_ms']!r}, off "
          f"{got['off_call_ms']!r}; the window's median "
          f"{got['window_call_ms']!r}", file=file)
    if "labelled_call_ms" in got:
        print(f"# spans naming pass: {got['label_calls']} calls, ms per "
              f"call {got['labelled_call_ms']!r}, busy {got['busy_ms']!r},"
              f" idle {got['idle_ms']!r} of which named by the harness "
              f"span alone {got['harness_alone_ms']!r}", file=file)
    host = sorted(got["host"].items(), key=lambda kv: -kv[1]["self_ms"])
    print("# spans host per call [name, count, ms, self ms]: "
          + str([[k, r(v["count"]), r(v["ms"]), r(v["self_ms"])]
                 for k, v in host]), file=file)
    print(f"# spans counters per call: {got['counters']}", file=file)
    if "device" in got:
        print("# spans device per call [name, ms, events]: "
              + str([[k, r(ms), r(n)] for k, (ms, n)
                     in got["device"].items()]), file=file)
        print("# spans idle gaps [label, s]: "
              + str([[k, r(v)] for k, v in got["idle_gaps"]]), file=file)


# ---- what the readers call ----

_LAST: list = []   # [(record, what the passes gave)]


def run_context() -> Optional[harness.Context]:
    """The context of this process's ``benchmark/run.py`` run, from its
    arguments; None in any other process."""
    main = sys.modules.get("__main__")
    path = getattr(main, "__file__", None)
    if path is None or Path(path).resolve() != \
            harness.bench_dir(harness.ROOT) / "run.py":
        return None
    args = main.parse_args(sys.argv[1:])
    import torch

    return harness.Context(cell=harness.find_cell(args.workload),
                           seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace),
                           device=torch.device("cuda", 0),
                           t_origin=time.perf_counter())


def reading(record: dict) -> Optional[dict]:
    """What the passes gave in this run, run once for ``record``; None
    where the program records no spans or this is no benchmark run."""
    if _LAST and _LAST[0][0] is record:
        return _LAST[0][1]
    ctx = run_context() if tracing_module() is not None else None
    got = None
    if ctx is not None:
        median = statistics.median(record["window"]["call_ms"])
        try:
            got = measure(ctx, median)
        except TraceMismatch as e:
            raise harness.BenchmarkError(str(e)) from e
        report(got)
    _LAST[:] = [(record, got)]
    return got
