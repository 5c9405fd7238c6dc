"""table_share.step: the one-step cell's march launches that ran the march's
point-table kernel, as a share of its march launches in the traced slice
(the program's counters ``march_table_launches`` / ``march_launches``);
nothing to read where the program has no such counter or launched no
march."""


def read(record):
    launches = (record.get("trace") or {}).get("launches") or {}
    if "march_table_launches" not in launches \
            or not launches.get("march_launches"):
        return None
    return launches["march_table_launches"] / launches["march_launches"]
