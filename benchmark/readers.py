"""The arithmetic of the metric readers that more than one metric shares
(each metric's own file under ``metrics/`` names which it reads)."""

from __future__ import annotations

from benchmark.roofline import share_percent


def glups(record):
    """Interior points x steps completed in the window / the window's
    seconds on the host clock, in 1e9 per second."""
    w = record["window"]
    if "point_updates" not in w:
        return None
    return w["point_updates"] / w["s"] / 1e9


def kernel_roofline(record):
    """The stencil kernels' share of their roofline in the traced slice,
    in %: the least time of the slice's launches by the frozen count
    (``roofline.py``) / the summed time of their events in the trace."""
    t = record["trace"]
    return share_percent(t["launch_work"], t["stencil_s"])


def copy_share(record):
    """Device time in operations other than the stencil kernels / the
    device's busy time, in the traced slice."""
    t = record["trace"]
    return t["nonstencil_s"] / t["busy_s"] if t["busy_s"] > 0 else None


def idle_share(record):
    """1 - the union of the device's intervals / the traced slice's length
    on the CUDA events around it."""
    t = record["trace"]
    return 1.0 - t["busy_s"] / t["slice_s"] if t["slice_s"] > 0 else None
