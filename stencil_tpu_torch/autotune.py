"""On-card plan tuner with a persistent cache (``--autotune``).

Counterpart of ``stencil_tpu/autotune.py``. The default 3D plans come from
two cost models fitted on an H100 (``ops/tiled.py``: the march chooser,
``_march_cost``, and the window chooser, ``_cost``), which can pick a tile
slower than the best (PERF.md). ``--autotune`` measures the head of both
rankings for the requested configuration on the attached card, caches the
winner keyed by (card, spec, shape, dtype, k), and falls back to the
chooser's plan on the CPU or when every candidate fails.

JAX's plan space is its tiles crossed with tap modes and ``slide``, which
have no counterpart here; the port's is the tile and the schedule, so the
candidates are :func:`ops.tiled.rank_march_tiles`' head and
:func:`ops.tiled.rank_tiles`' head, the limit split over the two schedules
as JAX splits it over tap modes. A tile or a schedule changes no value (a
second schedule is bitwise the first), so an autotuned run is bitwise the
chooser's run.

The committed cache, ``data/autotune_h100.json``, holds the winners measured
on an NVIDIA H100 80GB HBM3 (PERF.md, Findings); JAX's v5e entries do not
transfer.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import torch

DEFAULT_CACHE = str(Path(__file__).resolve().parent / "data"
                    / "autotune_h100.json")
# measure at a reduced signal threshold: candidates differ by >= 5% when
# they differ at all, and each extra candidate costs its measurement
TUNE_SIGNAL_SECONDS = 0.4
MAX_CANDIDATES = 4
# the card the cost models were fitted on (their head of 4 holds the
# measured winners there); on any other card the tuner measures twice as
# many, so that a mis-ranking model does not prune the winner unmeasured
FITTED_DEVICE_KINDS = ("cuda:NVIDIA H100 80GB HBM3",)
# fraction of GLUPS movement against the cached winner that
# ``--autotune force`` reports as drift
DRIFT_FRACTION = 0.05

Candidate = Tuple[Tuple[int, int, int], str]  # (tiles, schedule)


def _device_kind(device=None) -> str:
    """``cuda:<name>`` of ``device`` (None: the current card), or
    ``cpu:cpu`` where there is no card: the cache key's first field."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return "cpu:cpu"


def tunes_on(device) -> bool:
    """Whether the search measures on ``device``: on a card. On the CPU
    the chooser's plan applies (JAX's fallback off the TPU)."""
    return torch.device(device).type == "cuda"


def _default_limit(device_kind: Optional[str] = None) -> int:
    kind = _device_kind() if device_kind is None else device_kind
    if kind.startswith("cuda:") and kind not in FITTED_DEVICE_KINDS:
        return 2 * MAX_CANDIDATES
    return MAX_CANDIDATES


def cache_key(spec, shape, dtype: str, k: int, device_kind: str,
              has_source: bool = False) -> str:
    """JAX's key: ``kind|spec|r<radius>|<shape>|<dtype>|k<k>``, with
    ``|src`` for a source plan, which tunes on its own."""
    key = "|".join([
        device_kind, spec.name or "custom", f"r{spec.radius}",
        "x".join(map(str, shape)), str(dtype), f"k{k}",
    ])
    return key + "|src" if has_source else key


def load_cache(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def save_cache(path: str, cache: dict) -> None:
    """Write ``cache`` to ``path`` through a rename, so that a reader never
    sees half a file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def lookup(spec, shape, dtype: str, k: int,
           cache_path: Optional[str] = None, has_source: bool = False,
           device=None) -> Optional[dict]:
    """The cached winner for this card and configuration, or None."""
    cache = load_cache(cache_path or DEFAULT_CACHE)
    return cache.get(cache_key(spec, shape, dtype, k, _device_kind(device),
                               has_source))


def candidates(spec, shape, dtype: str, k: int,
               limit: Optional[int] = None) -> List[Candidate]:
    """The (tiles, schedule) pairs to measure: the head of the march
    chooser's ranking, then the head of the window chooser's, each
    ``limit // 2`` long (at least 1) and led by the tile its chooser picks;
    a schedule with no tile that fits is skipped. The first candidate is
    the plan ``make_tiled_plan`` makes without tuning. A source plan has
    the same candidates: the port's plans give a source no shared memory
    (it is measured and cached on its own).

    ``limit`` defaults per card: 4 on the card the cost models were fitted
    on, twice that on any other (:data:`FITTED_DEVICE_KINDS`)."""
    from stencil_tpu_torch.ops.tiled import rank_march_tiles, rank_tiles

    if limit is None:
        limit = _default_limit()
    rankings = {
        "march": rank_march_tiles(spec, shape, k, dtype=dtype),
        "window": rank_tiles(spec, shape, k, dtype=dtype),
    }
    per = max(1, limit // len(rankings))
    return [(tiles, schedule) for schedule, ranked in rankings.items()
            for tiles in ranked[:per]]


def autotune(spec, shape, dtype: str, k: int,
             cache_path: Optional[str] = None,
             measure_fn: Optional[Callable] = None,
             force: bool = False, has_source: bool = False,
             device=None) -> Optional[dict]:
    """Measure the candidates on ``device`` (None: the current card);
    return and cache the winner as ``{"tiles": [t0, t1, t2], "schedule":
    "march"|"window", "glups": float}``.

    ``measure_fn(tiles, schedule) -> glups`` may be injected for testing;
    by default a ``TiledStencil`` per candidate, timed by the marginal
    protocol. A candidate that raises is skipped with a line on stderr;
    None (the chooser's plan applies) when nothing could be measured.
    ``cache_path`` None is :data:`DEFAULT_CACHE`, read when called.

    ``force`` measures even on a cache hit, and warns when the fresh winner
    drifts from the cached one (another plan, or GLUPS moved by more than
    :data:`DRIFT_FRACTION`)."""
    cache_path = cache_path or DEFAULT_CACHE
    key = cache_key(spec, shape, dtype, k, _device_kind(device), has_source)
    cache = load_cache(cache_path)
    cached = cache.get(key)
    if not force and cached is not None:
        return cached

    if measure_fn is None:
        measure_fn = _measure_glups_factory(spec, shape, dtype, k,
                                            has_source, device)

    best = None
    for tiles, schedule in candidates(spec, shape, dtype, k):
        try:
            glups = float(measure_fn(tiles, schedule))
        except Exception as e:  # an infeasible candidate is skipped
            print(f"# autotune: {tiles} {schedule} failed: {e}",
                  file=sys.stderr)
            continue
        print(f"# autotune: tiles={tiles} schedule={schedule} -> "
              f"{glups:.1f} GLUPS", file=sys.stderr)
        if best is None or glups > best["glups"]:
            best = {"tiles": list(tiles), "schedule": schedule,
                    "glups": round(glups, 2)}
    if best is not None:
        if cached is not None:
            same_plan = (list(cached.get("tiles", ())) == best["tiles"]
                         and cached.get("schedule") == best["schedule"])
            moved = abs(best["glups"] - float(cached.get("glups", 0.0)))
            if not same_plan or moved > DRIFT_FRACTION * best["glups"]:
                print(f"# autotune: CACHE DRIFT for {key}: cached "
                      f"{cached} -> measured {best} (cache updated)",
                      file=sys.stderr)
        cache[key] = best
        try:
            save_cache(cache_path, cache)
        except OSError:
            pass  # a read-only install: the winner still applies this run
    return best


def _measure_glups_factory(spec, shape, dtype, k, has_source=False,
                           device=None):
    """``measure(tiles, schedule) -> GLUPS``: a ``TiledStencil`` at the
    candidate's plan on ``device``, timed by ``measure_marginal`` at
    :data:`TUNE_SIGNAL_SECONDS`."""
    import math

    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.ops.tiled import TiledStencil
    from stencil_tpu_torch.utils.timing import measure_marginal

    dev = torch.device("cuda" if device is None else device)
    grid = HaloGrid.create(tuple(shape), halo=spec.radius, dtype=dtype,
                           device=dev)
    points = math.prod(shape)
    # the rate does not depend on the values: any interior-shaped source
    src = (torch.ones(tuple(shape), dtype=grid.dtype, device=dev)
           if has_source else None)

    def measure(tiles, schedule):
        m = TiledStencil(spec, tuple(shape), dtype, sweeps_per_call=k,
                         tiles=tuple(tiles), schedule=schedule, device=dev,
                         source=src, source_scale=1e-6)

        def run_n(n):
            return m.iterate(grid, n).data

        meas = measure_marginal(run_n, dev, warmup_iters=k, granularity=k,
                                min_signal_seconds=TUNE_SIGNAL_SECONDS)
        return points / meas.seconds_per_iteration / 1e9

    return measure


# the configurations the committed cache holds: bench.py's cfg4 pair
# (laplace3d_ho 384^3 k=4, :84-86), the headline jacobi7 256^3 k=8 (:60-63)
# and its Poisson source row (star3d_r1 256^3 k=8, :161)
COMMITTED = (("laplace3d_ho", (384, 384, 384), 4, False),
             ("jacobi7", (256, 256, 256), 8, False),
             ("star3d_r1", (256, 256, 256), 8, True))


def main(argv=None) -> int:
    """Tune :data:`COMMITTED` on the card into ``--cache`` (default
    :data:`DEFAULT_CACHE`), measuring again with ``--force``; prints each
    winner."""
    import argparse

    from stencil_tpu_torch.core.spec import get_spec, star

    p = argparse.ArgumentParser(prog="stencil-tpu-torch-autotune")
    p.add_argument("--cache", type=str, default=None)
    p.add_argument("--force", action="store_true")
    ns = p.parse_args(argv)
    for name, shape, k, src in COMMITTED:
        spec = star(3, 1) if name == "star3d_r1" else get_spec(name)
        won = autotune(spec, shape, "float32", k, cache_path=ns.cache,
                       force=ns.force, has_source=src)
        print(f"{cache_key(spec, shape, 'float32', k, _device_kind(), src)}"
              f": {won}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
