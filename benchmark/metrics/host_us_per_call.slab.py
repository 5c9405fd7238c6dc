"""host_us_per_call.slab: the host's microseconds from the call into
``iterate`` until it returns, before the synchronize, averaged over the
window's calls (the harness's own span, the profiler off), in the long 2D
relaxation: how much host time a call's 256 launches take, against the
call's ~79 ms of device time."""


def read(record):
    host = record["window"]["host_s"]
    return sum(host) / len(host) * 1e6 if host else None
