"""runner_host_us.step: the host's us per call inside the runner's copies,
``runner.pad``, ``.clone``, ``.refresh``, ``.unpad`` and
``.from_interior`` together, tracing on, no profiler (the spans pass,
``benchmark/spans.py``)."""

from benchmark import spans


def read(record):
    got = spans.reading(record)
    rows = [got["host"][n] for n in spans.RUNNER_COPIES
            if got and n in got["host"]]
    return sum(r["ms"] for r in rows) * 1e3 if rows else None
