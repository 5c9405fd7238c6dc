"""step_ms_p95: the 95th percentile of the window's per-call spans, each
from the call into the program to the end of its last device operation,
on the device's clock (CUDA events)."""

from benchmark.harness import quantile


def read(record):
    return quantile(record["window"]["call_ms"], 0.95)
