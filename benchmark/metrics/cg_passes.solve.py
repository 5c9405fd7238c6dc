"""cg_passes.solve: CG's loop passes per solve (the program's ``cg_passes``
counter: each pass runs a matvec and a preconditioning cycle; less
``cg_iterations.solve``, the masked passes after convergence), over the
spans pass's solves (``benchmark/spans.py``)."""

from benchmark import spans


def read(record):
    got = spans.reading(record)
    if got is None:
        return None
    return got["counters"].get("cg_passes")
