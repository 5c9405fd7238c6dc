"""march_share.slab: the long 2D relaxation's launches that ran the march
schedule (``csrc/slab_march.cu``), as a share of all its launches in the
traced slice (the program's counters of ``slab_sweep``,
``march_launches`` / ``launches``): 1.0 while the plan takes the march."""


def read(record):
    launches = (record.get("trace") or {}).get("launches") or {}
    if "march_launches" not in launches or not launches.get("launches"):
        return None
    return launches["march_launches"] / launches["launches"]
