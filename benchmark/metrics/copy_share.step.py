"""copy_share.step: device time in operations other than the port's
stencil kernels (each call's pad, zero fill, clone, interior copies and
halo fill) / the device's busy time, in the traced slice."""

from benchmark.readers import copy_share as read  # noqa: F401
