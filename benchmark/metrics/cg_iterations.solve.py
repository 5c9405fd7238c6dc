"""cg_iterations.solve: ``CGResult.iterations``, averaged over the traced
solves."""


def read(record):
    its = record["trace"].get("cg_iterations")
    return sum(its) / len(its) if its else None
