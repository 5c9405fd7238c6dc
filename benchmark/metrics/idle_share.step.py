"""idle_share.step: 1 - the union of the device's intervals (kernels,
memcpy, memset) / the traced slice's length on the CUDA events around
it."""

from benchmark.readers import idle_share as read  # noqa: F401
