"""coarse_device_ms.solve: the device's ms per solve in the events whose
launch lay inside an ``mg.level<n>`` span or its children (the union of
their intervals): the coarse levels' device time, from the naming pass's
trace, each event put down to its launch by ``correlation``
(``benchmark/spans.py``)."""

from benchmark import spans


def read(record):
    got = spans.reading(record)
    return got.get("level_device_ms") if got else None
