"""setup_s: seconds from the process's start to the first timed call (the
import, the card's context, the seeded inputs, the kernels' build or load,
the warm-up calls)."""


def read(record):
    return record["setup_s"]
