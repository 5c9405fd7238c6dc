"""kernel_roofline.solve: the multigrid fine level's kernels' share of
their roofline in the traced slice, in %: the least time of the slice's
launches by the frozen count (``benchmark/roofline.py``: input read
once, outputs written once, at 3.35 TB/s and 67 TFLOP/s fp32) / the
summed time of their events in the trace. The launches are counted by
the program's counters, each mode by its own; the trace's events are
checked against those counts first."""

from benchmark.readers import kernel_roofline as read  # noqa: F401
