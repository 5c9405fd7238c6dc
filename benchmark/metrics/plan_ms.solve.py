"""plan_ms.solve: the host's ms per solve inside ``plan.make`` spans (the
tiled plans each solve builds for its preconditioner; 0 where a solve
builds none), tracing on, no profiler (the spans pass,
``benchmark/spans.py``)."""

from benchmark import spans


def read(record):
    got = spans.reading(record)
    if got is None:
        return None
    row = got["host"].get("plan.make")
    return row["ms"] if row else 0.0
