"""glups: the long relaxation's interior points x steps completed in the
window / the window's seconds on the host clock, in 1e9 per second. Every
call ends in a synchronize."""

from benchmark.readers import glups as read  # noqa: F401
