"""Readings for the limits of a cell's correctness check.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \\
        --control-seeds 101 102 103 [--out FILE]

In one process on the card, at the cell's own size: for each seed, one
call of the timed path on the seeded input (or the last of ``--calls``)
and the number its check compares (the driver's ``reading``); for each
control seed the same with the program's lower-precision path (the
configuration's ``control_dtype``), which the limit has to fail. Prints one JSON line per
reading and a summary: the largest sound reading (the lower end of the
limit) and the smallest control reading (the upper end).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def readings(cell: harness.Cell, seeds, dtype, device, calls: int = 1):
    driver = harness.load_driver(cell)
    out = []
    for seed in seeds:
        ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                              device=device, t_origin=time.perf_counter())
        t0 = time.perf_counter()
        value = float(driver.reading(ctx, dtype, calls))
        out.append({"cell": cell.name, "seed": seed, "calls": calls,
                    "dtype": dtype or cell.config["dtype"], "value": value,
                    "seconds": time.perf_counter() - t0})
        harness.release(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--calls", type=int, default=1,
                   help="read the last of this many calls from the seeded "
                   "input (a relaxation's later calls start from smoother "
                   "fields)")
    p.add_argument("--out", help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(harness.card_line(), file=sys.stderr)
    device = torch.device("cuda", 0)
    cell = harness.find_cell(args.workload)
    rows = readings(cell, args.seeds, None, device, args.calls)
    rows += readings(cell, args.control_seeds, cell.config["control_dtype"],
                     device, args.calls)
    sound = [r["value"] for r in rows if r["dtype"] == cell.config["dtype"]]
    control = [r["value"] for r in rows
               if r["dtype"] != cell.config["dtype"]]
    summary = {"cell": cell.name, "sound_max": max(sound),
               "sound_n": len(sound),
               "control_min": min(control) if control else None,
               "control_n": len(control)}
    lines = [json.dumps(r) for r in rows] + [json.dumps(summary)]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
