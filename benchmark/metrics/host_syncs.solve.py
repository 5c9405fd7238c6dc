"""host_syncs.solve: the program's device-to-host reads per solve (its
``host_syncs`` counter: CG's flag checks and its stats copy), over the
spans pass's solves (``benchmark/spans.py``)."""

from benchmark import spans


def read(record):
    got = spans.reading(record)
    if got is None:
        return None
    return got["counters"].get("host_syncs")
