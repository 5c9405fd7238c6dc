"""host_us_per_call.step: the host's microseconds from the call into
``iterate`` until it returns, before the synchronize, averaged over the
window's calls (the harness's own span, the profiler off)."""


def read(record):
    host = record["window"]["host_s"]
    return sum(host) / len(host) * 1e6 if host else None
