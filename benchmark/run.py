"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the program, ``stencil_tpu_torch``. ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a traced slice
after the window. The last line on standard output is one JSON object; the
last lines on standard error are the numbers compared, each beside its
limit. Exits 1 with no result where there is no CUDA card (or fewer than
the cell asks for), where the program is missing, where JAX or the JAX
package was loaded, or where the trace does not account for every launch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

T_ORIGIN = harness.process_start()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str) -> int:
    print(f"benchmark: {message}", file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        cell = harness.find_cell(args.workload)
    except (harness.BenchmarkError, KeyError) as e:
        return fail(str(e))
    harness.pin_to_one_cpu()
    import torch

    if not torch.cuda.is_available():
        return fail("torch sees no CUDA device; the benchmark runs on the "
                    "card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, torch sees "
                    f"{torch.cuda.device_count()}")
    print(harness.card_line(), file=sys.stderr)
    try:
        import stencil_tpu_torch
    except ImportError as e:
        return fail(f"the program is missing: {e}")
    where = Path(stencil_tpu_torch.__file__).resolve().parents[1]
    if where != ROOT:
        return fail(f"imported {stencil_tpu_torch.__file__}, not this "
                    "checkout's program")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from benchmark.trace import TraceMismatch

    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device,
                          t_origin=T_ORIGIN)
    try:
        record = harness.load_driver(cell).run(ctx)
    except TraceMismatch as e:
        return fail(str(e))
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": cell.chips,
            "memory_peak_bytes": record["memory_peak_bytes"]}
    return emit(cell, record, bool(args.trace), info)


def emit(cell, record: dict, trace: bool, info: dict) -> int:
    """Read the cell's metrics from the run's record and print the result:
    the checks on standard error, the result line last on standard output.
    No result where a metric cannot be read, or where JAX or the JAX
    package was loaded by then: the metric readers load last, so the look
    comes after them."""
    try:
        result = harness.result_line(cell, record, trace, info)
    except harness.BenchmarkError as e:
        return fail(str(e))
    loaded = harness.forbidden_modules()
    if loaded:
        return fail(f"modules of JAX or the JAX package were loaded: "
                    f"{loaded}")
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
