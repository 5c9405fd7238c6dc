"""The benchmark's catalogue, its measured window and its result line.

Everything that belongs to one cell, configuration, traffic mix or metric
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``benchmark/cells/<cell>.json`` names the cell's configuration file and
  traffic file and holds the limits of its correctness checks;
- ``configs/<config>.json`` holds a configuration as it is run;
- ``traffic/<traffic>.json`` holds a traffic mix's parameters and names
  its driver, ``drivers/<driver>.py``, which sets the cell up, runs its
  window and checks its answers;
- ``metrics/<metric>.py`` reads one metric from the run's record.

A new cell, configuration, traffic mix or metric is therefore new files and
new ``BENCHMARK.json`` entries; no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from (compared whole: the port's own name
# begins with it)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stencil_tpu")


class BenchmarkError(RuntimeError):
    """A run that cannot give a result: a missing file, a cell that does
    not fit its entry, a metric that cannot be read."""


def bench_dir(root: Path) -> Path:
    return Path(root) / "benchmark"


def load_json(path: Path) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except (OSError, ValueError) as e:
        raise BenchmarkError(f"cannot read {path}: {e}") from e


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchmarkError(f"no {what} named {name!r} in BENCHMARK.json; "
                         f"there are {sorted(e['name'] for e in entries)}")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: Tuple[dict, ...]
    per_layer: Tuple[dict, ...]
    root: Path

    def with_config(self, **changes) -> "Cell":
        """This cell with some configuration keys replaced (the tests run
        a cell at a small size on the CPU)."""
        return dataclasses.replace(self, config={**self.config, **changes})


def find_cell(name: str, root: Path = ROOT,
              bench: Optional[dict] = None) -> Cell:
    """The workload ``name`` of ``root``'s ``BENCHMARK.json`` with its cell,
    configuration and traffic files read and checked against the entry."""
    bench = load_benchmark(root) if bench is None else bench
    entry = _by_name(bench["workloads"], name, "workload")
    config_entry = _by_name(bench["configs"], entry["config"],
                            "configuration")
    cell_file = bench_dir(root) / "cells" / f"{name}.json"
    cell = load_json(cell_file)
    traffic_file = f"benchmark/traffic/{entry['traffic']}.json"
    if cell.get("config") != config_entry["file"]:
        raise BenchmarkError(
            f"{cell_file} names configuration file {cell.get('config')!r}, "
            f"BENCHMARK.json {config_entry['file']!r}")
    if cell.get("traffic") != traffic_file:
        raise BenchmarkError(
            f"{cell_file} names traffic file {cell.get('traffic')!r}, "
            f"BENCHMARK.json's traffic {entry['traffic']!r} is "
            f"{traffic_file!r}")
    return Cell(
        name=name, chips=int(entry["chips"]),
        config_name=entry["config"],
        config=load_json(Path(root) / config_entry["file"]),
        traffic_name=entry["traffic"],
        traffic=load_json(Path(root) / traffic_file),
        limits=dict(cell.get("limits", {})),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)),
        root=Path(root))


def _load_file(path: Path, module_name: str):
    if not path.is_file():
        raise BenchmarkError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[module_name] = module
    spec.loader.exec_module(module)
    return module


def load_driver(cell: Cell):
    """The module ``drivers/<driver>.py`` that the cell's traffic names."""
    driver = cell.traffic.get("driver")
    if not isinstance(driver, str) or not driver.isidentifier():
        raise BenchmarkError(f"traffic {cell.traffic_name!r} names no "
                             f"driver (got {driver!r})")
    return _load_file(bench_dir(cell.root) / "drivers" / f"{driver}.py",
                      f"_bench_driver_{driver}")


def load_metric(root: Path, name: str):
    """The reader ``metrics/<name>.py`` of metric ``name``: a module with
    ``read(record) -> float or None``."""
    module = _load_file(bench_dir(root) / "metrics" / f"{name}.py",
                        "_bench_metric_" + name.replace(".", "_")
                        .replace("-", "_"))
    if not callable(getattr(module, "read", None)):
        raise BenchmarkError(f"metrics/{name}.py has no read(record)")
    return module


# ---- the run's context and its measured window ----

@dataclasses.dataclass
class Context:
    """What a driver is given: the cell, the seed, the window's length,
    whether to trace, the device, and the process's start on the
    ``time.perf_counter`` clock (set-up is counted from it)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t_origin: float

    def generator(self, stream: int = 0):
        """A ``torch.Generator`` on the device seeded from ``--seed`` and
        ``stream`` (so a driver's data streams are independent)."""
        import torch

        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) % (2 ** 63))
        return g

    def rng(self, stream: int = 0):
        """A NumPy generator for host-side draws (call order, samples)."""
        import numpy as np

        return np.random.default_rng([self.seed % (2 ** 63), stream])


def synchronize(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)


class CallTimer:
    """One call's span: CUDA events on the current stream on a card (the
    device's clock, from the call's start until its last operation is
    done), the host clock on the CPU. Read after a synchronize."""

    def __init__(self, device):
        import torch

        self.cuda = getattr(device, "type", str(device)) == "cuda"
        if self.cuda:
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))

    def start(self) -> None:
        if self.cuda:
            self._ev[0].record()
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            self._ev[1].record()
        else:
            self._t1 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            return self._ev[0].elapsed_time(self._ev[1])
        return (self._t1 - self._t0) * 1e3


@dataclasses.dataclass
class Window:
    """The measured window: its seconds on the host clock (from the first
    call's start to the end of the last call's synchronize), the calls
    completed, each call's span in ms (:class:`CallTimer`) and its host
    seconds until the call returned, before the synchronize."""

    t_start: float = 0.0
    seconds: float = 0.0
    calls: int = 0
    call_ms: List[float] = dataclasses.field(default_factory=list)
    host_s: List[float] = dataclasses.field(default_factory=list)


def run_window(call: Callable[[int], object], seconds: float, device,
               done: Callable[[int, object], None]) -> Window:
    """Closed loop, one caller: ``call(i)`` back to back, each followed by
    a synchronize and ``done(i, result)``, until ``seconds`` have passed;
    the last call started before then is finished and counted."""
    timer = CallTimer(device)
    win = Window()
    synchronize(device)
    win.t_start = t = time.perf_counter()
    while True:
        timer.start()
        h0 = time.perf_counter()
        out = call(win.calls)
        h1 = time.perf_counter()
        timer.stop()
        synchronize(device)
        win.call_ms.append(timer.ms())
        win.host_s.append(h1 - h0)
        done(win.calls, out)
        win.calls += 1
        t = time.perf_counter()
        if t - win.t_start >= seconds:
            break
    win.seconds = t - win.t_start
    return win


def memory_peak_bytes(device) -> int:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def release(device) -> None:
    """Hand the freed program state back to the card before the
    reference runs."""
    import gc

    import torch

    gc.collect()
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.empty_cache()


def launch_counts(kernel) -> Dict[str, int]:
    """The program's launch counters of a stencil kernel (the window
    schedule's ``SweepKernel``, which counts its march launches too)."""
    names = ["launches", *kernel.MODE_COUNTS]
    return {n: int(getattr(kernel, n)) for n in names}


def counts_delta(before: Dict[str, int],
                 after: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def kernel_names(kernel) -> Tuple[str, ...]:
    """The device names of a ``SweepKernel``'s launches: ``<name>_kernel``
    for it and its march twin."""
    names = [f"{kernel.name}_kernel"]
    if getattr(kernel, "march", None) is not None:
        names.append(f"{kernel.march.name}_kernel")
    return tuple(names)


# ---- reading metrics and printing the result ----

def quantile(values, q: float) -> float:
    """The ``q`` quantile (0 < q < 1) of ``values``, by
    ``statistics.quantiles`` with the inclusive method."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    cut = statistics.quantiles(values, n=1000, method="inclusive")
    return float(cut[round(q * 1000) - 1])


def read_metrics(cell: Cell, record: dict, trace: bool) -> dict:
    """The cell's ``end_to_end`` metrics (``trace`` false) or its
    ``per_layer`` metrics (``trace`` true), each by its reader. An
    end-to-end metric that cannot be read is an error; a per-layer reader
    that finds nothing to read leaves its metric out."""
    out = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(cell.root, entry["name"]).read(record)
        if value is None:
            if not trace:
                raise BenchmarkError(f"end-to-end metric {entry['name']} "
                                     "has nothing to read")
            print(f"# {entry['name']}: nothing to read in this run",
                  file=sys.stderr)
            continue
        out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def card_line() -> str:
    """The card's name, power limit and SM clock, read with nvidia-smi."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: not available ({e})"
    text = proc.stdout.strip() or proc.stderr.strip()
    return f"nvidia-smi: name, power.limit, clocks.sm, clocks.max.sm: {text}"


def pin_to_one_cpu() -> None:
    """Keep this process, and the threads it starts later, on one CPU: the
    last of those it may use. The program's host path is one Python thread;
    a run that the scheduler places on another core each time reads that
    core's load, and a one-step cell's rate follows the host's speed."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cpus[-1]})
    except (AttributeError, OSError):
        pass


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock, from the
    kernel's record of it (10 ms ticks); now, where that is unreadable."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


def result_line(cell: Cell, record: dict, trace: bool, device_info: dict
                ) -> dict:
    """The result object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, with a trace ``breakdown``, a summary of the
    window (its calls' spans; with a trace, the traced slices' ms per call
    beside them, so the profiler's cost shows), and last the checks, each
    number beside its limit."""
    checks = record["checks"]
    correct = bool(checks) and all(c["value"] <= c["limit"]
                                   for c in checks.values()) \
        and record["failed"] == 0
    out = {"correct": correct, "attempted": int(record["attempted"]),
           "failed": int(record["failed"]),
           "metrics": read_metrics(cell, record, trace),
           "device": dict(device_info)}
    if trace:
        t = record["trace"]
        out["device"]["busy_s"] = t["busy_s"]
        out["device"]["window_s"] = t["slice_s"]
        out["breakdown"] = t["breakdown"]
    w = record["window"]
    out["window"] = {"seconds": w["s"], "calls": w["calls"],
                     "call_ms_median": statistics.median(w["call_ms"]),
                     "call_ms_max": max(w["call_ms"]),
                     "host_ms_median": 1e3 * statistics.median(w["host_s"])}
    if trace:
        out["window"]["traced_call_ms"] = 1e3 * t["slice_s"] / t["calls"]
        out["window"]["labelled_call_ms"] = \
            1e3 * t["labelled_s"] / t["labelled_calls"]
    out["checks"] = checks
    return out


def check(name: str, value: float, limit: float) -> Tuple[str, dict]:
    """A compared number beside its limit; a NaN or an infinity reads as
    1e300, far past any limit (a control that gives no number has
    failed), so that the line stays plain JSON."""
    value = float(value)
    if not math.isfinite(value):
        value = 1e300
    return name, {"value": value, "limit": float(limit)}
