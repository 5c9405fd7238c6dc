"""solve_ms: the window's seconds / the solves it completed, in ms: the
time to a solution at the configuration's tolerance."""


def read(record):
    w = record["window"]
    if "solves" not in w:
        return None
    return w["s"] / w["solves"] * 1e3
