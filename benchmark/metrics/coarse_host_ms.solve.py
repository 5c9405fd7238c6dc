"""coarse_host_ms.solve: the host's ms per solve inside the ``mg.level1``
spans, which hold every deeper level: the time the host takes to issue
the multigrid's eager coarse levels, tracing on, no profiler (the spans
pass, ``benchmark/spans.py``)."""

from benchmark import spans


def read(record):
    got = spans.reading(record)
    row = got and got["host"].get(spans.LEVEL_PREFIX + "1")
    return row["ms"] if row else None
