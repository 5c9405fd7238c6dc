"""launches_per_solve.solve: the kernels on the device in the traced
slice / the solves traced (the coarse levels' eager operations, the
fine level's kernels, the Krylov recurrence's operations)."""


def read(record):
    t = record["trace"]
    return t["kernel_events"] / t["calls"] if t["calls"] else None
