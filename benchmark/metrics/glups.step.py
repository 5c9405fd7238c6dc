"""glups.step: the same rate in the one-step cell, a metric of its own so
that the long cell's rate keeps a bound of its own: the one-step cell's
rate follows the host's speed from run to run, the long cell's does not."""

from benchmark.readers import glups as read  # noqa: F401
