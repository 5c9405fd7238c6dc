"""Tile sweeps of the sweep kernels, and the score and fit of the 2D
chooser.

Measure, on a card: for each case of ``CASES`` one launch of
``csrc/slab_sweep.cu`` is timed (CUDA events) at every tile of a grid of
(t0, t1) that fits, and at the tile the chooser (``ops/slab.py``) picks;
one CSV row per tile, the card's name and power limit in the first line:

    python -m stencil_tpu_torch.tile_sweep --out rows.csv

Score and refit, anywhere (no card needed): per case, the time of the tile
the chooser picks over the best measured tile's, and the geometric mean
over the cases. ``--fit`` searches a grid of the cost model's three
constants (``ops/slab.py:COST_CONSTANTS``) for the least geometric mean,
each case picking among its measured tiles as the chooser would:

    python -m stencil_tpu_torch.tile_sweep --score rows.csv [--fit]

``data/slab_tiles_h100_fit.csv`` holds the rows the constants were fitted
to; ``data/slab_tiles_h100_check.csv`` a later sweep with the fitted
chooser.

``--dtype bfloat16`` times the kernels' bf16 entries, whose windows take 2
bytes per point. ``--dims 3`` times the 3D tiled kernel instead, at the
cases of ``CASES_3D`` (cfg3's and cfg4's shapes), every tile of its
chooser's candidates (``ops/tiled.py``) that fits, and prints per case the
chooser's pick against the fastest tile (its cost model was fitted in
float32; this checks it at 2-byte windows):

    python -m stencil_tpu_torch.tile_sweep --dims 3 --dtype bfloat16 \
        --out rows3d.csv

``--march`` does the same for the 3D kernel's march schedule
(``csrc/tiled_march.cu``): ``--out`` times every tile of ``MARCH_TILES``
that fits at each case of ``MARCH_CASES`` (each with its own dtype) and
the march chooser's pick; ``--score`` scores the march chooser
(``ops/tiled.py:choose_march_tiles``) against such rows, and ``--fit``
refits its three constants (``ops/tiled.py:MARCH_COST_CONSTANTS``). ``data/march_tiles_h100_fit.csv`` holds the rows
they were fitted to:

    python -m stencil_tpu_torch.tile_sweep --march --out rows.csv
    python -m stencil_tpu_torch.tile_sweep --march --score \
        stencil_tpu_torch/data/march_tiles_h100_fit.csv --fit

``--march --coeff`` times the march's coefficient mode instead, at
``MARCH_COEFF_CASES`` (cfg16's FTCS launch and cfg18's k=1 matvec, the
two-material field of contrast 100, the weights formed once per case);
``data/march_coeff_tiles_h100.csv`` holds such a sweep, which ``--score``
reads like any other:

    python -m stencil_tpu_torch.tile_sweep --march --coeff --out rows.csv

``--march --two-level`` times the march's two-level mode (the wave
equation's leapfrog, its rings 2r+3 planes deep) at ``TWO_LEVEL_CASES``
(cfg9's wave at 256^3, k = 1, 4 and 8 in fp32, k=8 in bf16 and with
periodic d0 and Neumann d1), every tile of the march chooser's candidates
that fits, and the window at its own chooser's tile in the same run
(``schedule`` column); ``--score`` then scores the chooser
(``choose_march_tiles`` with ``deep`` and the two-level constants) and
the schedule rule on such rows, and ``--fit`` ranks the constants of
``MARCH_FIT_GRID`` for it (``ops/tiled.py:MARCH_TWO_LEVEL_COST_CONSTANTS``).
``data/march_two_level_tiles_h100.csv`` holds the rows they were fitted
to; ``--held-out`` times ``TWO_LEVEL_HELD_OUT`` instead (the ragged 257^3
at k=8, never fitted; ``data/march_two_level_tiles_h100_held_out.csv``):

    python -m stencil_tpu_torch.tile_sweep --march --two-level --out rows.csv
    python -m stencil_tpu_torch.tile_sweep --march --two-level --score \
        stencil_tpu_torch/data/march_two_level_tiles_h100.csv --fit

``--march --cheby`` times the march's Chebyshev and dual modes (the
multigrid fine level's smoother and fused smooth+residual, nbsum3d, rings
2r+3 planes deep) at ``CHEBY_CASES`` (cfg13's two launches, Chebyshev k=2
and dual k=3 at 255^3, the other depths of V(1,1) and V(3,3), and cfg13's
Chebyshev launch in bf16), every tile of the march chooser's candidates
that fits, and the window at its own chooser's tile in the same run
(``schedule`` column); ``--score`` scores the chooser
(``choose_march_tiles`` with ``deep``, as ``make_tiled_plan`` calls it)
and the schedule rule of ``make_tiled_plan`` on such rows, and ``--fit``
ranks the constants of ``MARCH_FIT_GRID`` for it (the modes keep
``MARCH_COST_CONSTANTS``, which the fit reproduces).
``data/march_cheby_tiles_h100_fit.csv`` holds the rows they were fitted to; ``--held-out`` times
``CHEBY_HELD_OUT`` instead (cfg17's Chebyshev k=4 and dual k=5, cfg10's
weighted-Jacobi dual k=5, the FMG path's dual k=3 at 63^3 and the bf16
Chebyshev V(2,2)'s dual k=3, never fitted;
``data/march_cheby_tiles_h100_held_out.csv``):

    python -m stencil_tpu_torch.tile_sweep --march --cheby --out rows.csv
    python -m stencil_tpu_torch.tile_sweep --march --cheby --score \
        stencil_tpu_torch/data/march_cheby_tiles_h100_fit.csv --fit

``--dims 2 --march`` does it for the 2D kernel's march schedule
(``csrc/slab_march.cu``): ``--out`` times every march tile of the chooser's
candidates (``ops/slab.py:march_candidates``) at each case of
``SLAB_MARCH_CASES`` (each with its dtype, source and ``-b``), and the
window at its own chooser's tile, in the same run (``schedule`` column);
``--score`` scores the march chooser (``choose_slab_march_tiles``) and the
schedule rule of ``make_slab_plan`` against such rows, and ``--fit``
refits ``SLAB_MARCH_COST_CONSTANTS`` (least log error of the march's
estimated ms over its rows) and ``WINDOW_MS_CONSTANTS`` (the same over the
window's rows). ``data/slab_march_tiles_h100_fit.csv`` holds the rows
they were fitted to:

    python -m stencil_tpu_torch.tile_sweep --dims 2 --march --out rows.csv
    python -m stencil_tpu_torch.tile_sweep --dims 2 --march --score \
        stencil_tpu_torch/data/slab_march_tiles_h100_fit.csv --fit

``--held-out`` times ``SLAB_MARCH_HELD_OUT`` instead: shapes, specs and
bf16 cases the fit never saw, on which ``--score`` checks the fitted
constants (``data/slab_march_tiles_h100_held_out.csv``; never passed to
``--fit``):

    python -m stencil_tpu_torch.tile_sweep --dims 2 --march --held-out \
        --out held_out.csv

``--rma`` times the in-kernel exchange (``csrc/rma_iterate.cu``): per case
of ``RMA_CASES`` the step (the marginal of two launches) at 20 tiles, the
ten its rule (``parallel/rma.py:choose_rma_tile``) ranks first and ten
spread over the rest; ``--score`` scores the rule on such rows and
``--fit`` refits its constants (``RMA_TILE_CONSTANTS``, a least-squares
fit of the estimate to the rows' times). ``data/rma_tiles_h100_fit.csv``
holds the rows they were fitted to; ``--held-out`` times ``RMA_HELD_OUT``
(``data/rma_tiles_h100_held_out.csv``, never passed to ``--fit``):

    python -m stencil_tpu_torch.tile_sweep --rma --out rows.csv
    python -m stencil_tpu_torch.tile_sweep --rma --score \
        stencil_tpu_torch/data/rma_tiles_h100_fit.csv --fit
"""

from __future__ import annotations

import argparse
import csv
import itertools
import math
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from stencil_tpu_torch.core.grid import torch_dtype
from stencil_tpu_torch.core.spec import get_spec, star
from stencil_tpu_torch.ops import slab, tiled
from stencil_tpu_torch.ops.slab import (
    COST_CONSTANTS, SMEM_LIMIT, _t1_candidates, candidate_tiles,
    choose_tiles, make_slab_plan, tile_key,
)
from stencil_tpu_torch.ops.tiled import _smem_bytes

DATA_DIR = Path(__file__).resolve().parent / "data"
# (spec, interior shape, k, t0 pinned by -b or None)
CASES = (
    ("jacobi5", (512, 512), 16, None), ("jacobi9", (4096, 4096), 4, 256),
    ("jacobi9", (4096, 4096), 4, None), ("jacobi5", (4096, 4096), 16, None),
    ("jacobi5", (512, 512), 4, None), ("jacobi5", (4096, 4096), 1, None),
    ("star2d_r2", (2048, 2048), 4, None), ("jacobi5", (1024, 1024), 8, None),
    ("jacobi5", (512, 512), 1, None), ("jacobi9", (2048, 2048), 1, None),
    ("jacobi5", (2048, 2048), 2, None), ("jacobi9", (4096, 4096), 8, None),
    ("jacobi5", (8192, 8192), 4, None), ("jacobi9", (512, 512), 4, None),
    ("jacobi5", (256, 256), 16, None),
    ("laplace2d_ho", (2048, 2048), 2, None),
)
T0_GRID = (4, 8, 16, 32, 64, 128, 256)
T1_GRID = (16, 24, 32, 48, 56, 64, 88, 96, 120, 128, 184, 192, 248, 256)
# the constants --fit tries: block cost, load cost, row cost
FIT_GRID = ((0, 50, 100, 200, 300, 400, 600), (0, 0.25, 0.5, 1, 2),
            (0, 2, 4, 6, 8, 12, 16))
FIELDS = ("spec", "n0", "n1", "k", "t0_fixed", "t0", "t1", "ms")
# the 3D cases: cfg3 (bench.py:80-81) and cfg4 (:82-83, :91-92)
CASES_3D = (("jacobi7", (256, 256, 256), 8, None),
            ("laplace3d_ho", (384, 384, 384), 4, None))
FIELDS_3D = ("spec", "n0", "n1", "n2", "k", "dtype", "t0", "t1", "t2", "ms")

# the march cases (spec, shape, k, dtype): the headline at the depths
# chip_smoke.py times, and cfg3
MARCH_CASES = (("jacobi7", (256, 256, 256), 8, "float32"),
               ("jacobi7", (256, 256, 256), 8, "bfloat16"),
               ("jacobi7", (256, 256, 256), 4, "float32"),
               ("jacobi7", (256, 256, 256), 2, "float32"),
               ("jacobi7", (256, 256, 256), 1, "float32"))
# the march's coefficient mode (spec, shape, k, dtype): cfg16's FTCS
# launch and cfg18's k=1 matvec (bench.py:435-463)
MARCH_COEFF_CASES = (("jacobi7", (256, 256, 256), 8, "float32"),
                     ("jacobi7", (255, 255, 255), 1, "float32"))
# the march's two-level mode (spec, shape, k, dtype, walls): cfg9's wave
# (bench.py's wave cell) at the depths of its runs and at k=2, where the
# schedules cross, in bf16 and on the wave main path's dynamic walls; and
# the held-out case, ragged
TWO_LEVEL_CASES = (("wave3d", (256, 256, 256), 8, "float32", "dirichlet"),
                   ("wave3d", (256, 256, 256), 4, "float32", "dirichlet"),
                   ("wave3d", (256, 256, 256), 2, "float32", "dirichlet"),
                   ("wave3d", (256, 256, 256), 1, "float32", "dirichlet"),
                   ("wave3d", (256, 256, 256), 8, "bfloat16", "dirichlet"),
                   ("wave3d", (256, 256, 256), 8, "float32",
                    "periodic 0, neumann 1"))
TWO_LEVEL_HELD_OUT = (("wave3d", (257, 257, 257), 8, "float32",
                       "dirichlet"),)
FIELDS_TWO_LEVEL = ("spec", "n0", "n1", "n2", "k", "dtype", "walls",
                    "schedule", "t0", "t1", "t2", "ms")
# the march's Chebyshev and dual modes (mode, shape, k, dtype, smoother):
# cfg13's two launches (bench.py:247-258, Chebyshev V(2,2) in PCG: the
# smoother k=2 and the fused smooth+residual k=3) at 255^3, the depths of
# V(1,1) and V(3,3) beside them, and cfg13's Chebyshev launch in bf16; the
# held-out cases, never fitted: cfg17's two launches (Chebyshev V(4,4),
# :234-243), cfg10's fused launch (weighted Jacobi V(4,4)), the FMG path's
# at 63^3 (weighted Jacobi V(2,2)) and the bf16 Chebyshev V(2,2)'s
CHEBY_CASES = (("cheby", (255, 255, 255), 2, "float32", "chebyshev"),
               ("dual", (255, 255, 255), 3, "float32", "chebyshev"),
               ("cheby", (255, 255, 255), 1, "float32", "chebyshev"),
               ("dual", (255, 255, 255), 2, "float32", "chebyshev"),
               ("cheby", (255, 255, 255), 3, "float32", "chebyshev"),
               ("dual", (255, 255, 255), 4, "float32", "chebyshev"),
               ("cheby", (255, 255, 255), 2, "bfloat16", "chebyshev"))
CHEBY_HELD_OUT = (("cheby", (255, 255, 255), 4, "float32", "chebyshev"),
                  ("dual", (255, 255, 255), 5, "float32", "chebyshev"),
                  ("dual", (255, 255, 255), 5, "float32", "wjacobi"),
                  ("dual", (63, 63, 63), 3, "float32", "wjacobi"),
                  ("dual", (255, 255, 255), 3, "bfloat16", "chebyshev"))
FIELDS_CHEBY = ("mode", "n0", "n1", "n2", "k", "dtype", "smoother",
                "schedule", "t0", "t1", "t2", "ms")
# their scales (nb, c0, cs): FTCS at the stable step of max a = 1
COEFF_SCALES = (1.0 / 6.0, 1.0, -1.0 / 6.0)
MARCH_TILES = tuple((t0, t1, t2) for t0 in (16, 32, 64, 128, 256)
                    for t1, t2 in ((16, 16), (16, 32), (16, 64), (24, 24),
                                   (32, 32), (32, 64), (48, 48), (64, 64)))
# the march constants --fit tries: point, load and step costs
MARCH_FIT_GRID = ((4, 6, 8, 10, 14, 20, 30), (2, 4, 8, 16, 32, 64),
                  (0, 512, 1024, 2048, 4096, 8192))

# the 2D march cases (spec, shape, k, dtype, source, t0 pinned by -b or
# None): cfg1 at k = 1, 4, 16 and in bf16, cfg2 (bench.py:76-79) free and
# at its -b 256, the Poisson source mode at 4096^2 k=8, the ragged
# star2d_r2 of the CPU smoke
SLAB_MARCH_CASES = (
    ("jacobi5", (512, 512), 16, "float32", False, None),
    ("jacobi5", (512, 512), 4, "float32", False, None),
    ("jacobi5", (512, 512), 1, "float32", False, None),
    ("jacobi5", (512, 512), 16, "bfloat16", False, None),
    ("jacobi9", (4096, 4096), 4, "float32", False, 256),
    ("jacobi9", (4096, 4096), 4, "float32", False, None),
    ("star2d_r1", (4096, 4096), 8, "float32", True, None),
    ("star2d_r2", (250, 333), 3, "float32", False, None))
# cases kept out of the fit, to check it: cfg2 in bf16, the 63^2 Poisson
# solve in both dtypes, 2D sharded_pallas's (1024, 4096) block of 4096^2
# over --mesh 4, and two shapes and specs no fitted case has
SLAB_MARCH_HELD_OUT = (
    ("jacobi9", (4096, 4096), 4, "bfloat16", False, 256),
    ("star2d_r1", (63, 63), 8, "float32", True, None),
    ("star2d_r1", (63, 63), 8, "bfloat16", True, None),
    ("jacobi5", (1024, 4096), 8, "float32", False, None),
    ("laplace2d_ho", (1024, 1024), 4, "float32", False, None),
    ("jacobi9", (2048, 2048), 2, "float32", False, None))
FIELDS_MARCH_2D = ("spec", "n0", "n1", "k", "dtype", "source", "t0_fixed",
                   "schedule", "t0", "t1", "ms")
# the constants --fit tries: the march's point cost, ns per step, ns per
# chain slot, ns per warp slot, launch ms; the window's ms per cost unit
# (x 1e-6) and its floor in ms
SLAB_MARCH_FIT_GRID = ((8, 16, 24, 32, 48), (100, 200, 300, 400, 500),
                       (1, 2, 3, 4, 8), (0.1, 0.2, 0.3, 0.4, 0.5, 0.6),
                       (0.01, 0.015, 0.02, 0.025))
WINDOW_FIT_GRID = (tuple(x / 10 for x in range(5, 31)),
                   tuple(x / 1000 for x in range(10, 51)))

Case = Tuple[str, Tuple[int, int], int, Optional[int]]
MarchCase = Tuple[str, Tuple[int, int, int], int, str]
TwoLevelCase = Tuple[str, Tuple[int, int, int], int, str, str]
ChebyCase = Tuple[str, Tuple[int, int, int], int, str, str]
SlabMarchCase = Tuple[str, Tuple[int, int], int, str, bool, Optional[int]]


def spec_of(name: str):
    """A spec by name; ``star2d_r1`` is the Poisson runner's (``star(2,
    1)``) and ``wave3d`` the 3D wave equation's at its CFL limit
    (``models/wave.py``), which the spec table does not name."""
    if name == "wave3d":
        from stencil_tpu_torch.models.wave import WaveEquation

        return WaveEquation(shape=(1, 1, 1), device="cpu").spec
    return star(2, 1) if name == "star2d_r1" else get_spec(name)


def walls_of(name: str):
    """The walls of a two-level case: the wave's zero walls, periodic and
    Neumann dims as ``"periodic 0, neumann 1"`` names them."""
    from stencil_tpu_torch.core.grid import DirichletBC

    bc = DirichletBC.zero(3)
    for part in name.split(", "):
        kind, *dims = part.split()
        dims = tuple(int(d) for d in dims)
        if kind == "periodic":
            bc = bc.with_periodic(dims)
        elif kind == "neumann":
            bc = bc.with_neumann(dims)
    return bc


def sweep_tiles(spec_name: str, shape, k: int, t0_fixed: Optional[int],
                dtype="float32") -> List[Tuple[int, ...]]:
    """The tiles one case times, those that fit at ``dtype``'s item size.
    2D: the grid (t0 pinned when ``t0_fixed``), the chooser's t1
    candidates and its pick, clamped. 3D: the 3D chooser's candidates
    and its pick, clamped."""
    spec = get_spec(spec_name)
    itemsize = torch_dtype(dtype).itemsize
    if len(shape) == 3:
        tiles = {tuple(min(t, n) for t, n in zip(cand, shape))
                 for cand in itertools.product(
                     tiled._T0_CANDIDATES, tiled._T1_CANDIDATES,
                     tiled._t2_candidates(k * spec.radius))}
        tiles.add(tiled.choose_tiles(spec, shape, k, t0_fixed, dtype))
    else:
        t0s = (t0_fixed,) if t0_fixed is not None else T0_GRID
        t1s = set(T1_GRID) | set(_t1_candidates(k * spec.radius))
        tiles = {(min(t0, shape[0]), min(t1, shape[1]))
                 for t0, t1 in itertools.product(t0s, t1s)}
        tiles.add(choose_tiles(spec, shape, k, t0_fixed, dtype))
    return sorted(t for t in tiles
                  if _smem_bytes(t, k, spec.radius, itemsize) <= SMEM_LIMIT)


def gpu_label() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def measure(out: Path, cases: Sequence[Case] = CASES, seed: int = 0,
            dtype="float32") -> None:
    """Time one launch at every tile of every case on the current CUDA
    device, the grid in ``dtype``; writes the rows to ``out`` (2D cases as
    ``FIELDS``, 3D cases as ``FIELDS_3D``). A 3D case prints the chooser's
    pick against the fastest tile."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.ops.slab_kernel import slab_sweep
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep
    from stencil_tpu_torch.utils.timing import timed

    if not torch.cuda.is_available():
        raise RuntimeError("the tile sweep times the CUDA kernel: it needs "
                           "a card (score and fit need none)")
    device = torch.device("cuda")
    label = gpu_label()
    print(label)
    rng = np.random.default_rng(seed)
    three_d = len(cases[0][1]) == 3
    with open(out, "w", newline="") as fh:
        fh.write(f"# {label}, {dtype}\n")
        writer = csv.writer(fh)
        writer.writerow(FIELDS_3D if three_d else FIELDS)
        for name, shape, k, t0_fixed in cases:
            spec = get_spec(name)
            x = torch.from_numpy(rng.random(shape, dtype=np.float32))
            grid = HaloGrid.from_interior(x.to(torch_dtype(dtype)),
                                          halo=spec.radius, device=device)
            reps = max(5, min(200, int(2e8 / (math.prod(shape) * k))))
            make, kernel = ((tiled.make_tiled_plan, tiled_sweep) if three_d
                            else (make_slab_plan, slab_sweep))
            times = {}
            for tiles in sweep_tiles(name, shape, k, t0_fixed, dtype):
                plan = make(spec, shape, dtype, k, tiles=tiles)
                cur = plan.layout.pad_grid(grid)
                nxt = cur.clone()
                kernel(cur, nxt, plan)
                ms = timed(lambda: [kernel(cur, nxt, plan)
                                    for _ in range(reps)], device) \
                    / reps * 1e3
                times[tiles] = ms
                if three_d:
                    writer.writerow((name, *shape, k, dtype, *tiles,
                                     repr(ms)))
                else:
                    writer.writerow((name, *shape, k,
                                     "" if t0_fixed is None else t0_fixed,
                                     *tiles, repr(ms)))
            fh.flush()
            pick = make(spec, shape, dtype, k, t0_fixed=t0_fixed).tiles
            best = min(times, key=times.get)
            print(f"{name} {shape} k={k} t0_fixed={t0_fixed} {dtype}: "
                  f"{len(times)} tiles; chooser {pick} {times[pick]:.4f} "
                  f"ms, fastest {best} {times[best]:.4f} ms, "
                  f"{times[pick] / times[best]:.3f}x [{label}]")
            sys.stdout.flush()


def measure_march(out: Path, cases: Sequence[MarchCase] = MARCH_CASES,
                  seed: int = 0, coeff: bool = False) -> None:
    """Time one march launch at every tile of ``MARCH_TILES`` that fits,
    and at the march chooser's pick, for every case on the current CUDA
    device; writes ``FIELDS_3D`` rows to ``out`` and prints per case the
    pick against the fastest tile. ``coeff``: the coefficient mode
    (``COEFF_SCALES``, cfg16's two-material field), its weights formed
    once per case."""
    import torch

    from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
    from stencil_tpu_torch.models.diffusion import two_material
    from stencil_tpu_torch.ops.tiled_kernel import coeff_weights, tiled_sweep
    from stencil_tpu_torch.utils.timing import timed

    if not torch.cuda.is_available():
        raise RuntimeError("the tile sweep times the CUDA kernel: it needs "
                           "a card (score and fit need none)")
    device = torch.device("cuda")
    label = gpu_label()
    print(label)
    rng = np.random.default_rng(seed)
    with open(out, "w", newline="") as fh:
        fh.write(f"# {label}, march{' coeff' if coeff else ''}\n")
        writer = csv.writer(fh)
        writer.writerow(FIELDS_3D)
        for name, shape, k, dtype in cases:
            spec = get_spec(name)
            x = torch.from_numpy(rng.random(shape, dtype=np.float32))
            grid = HaloGrid.from_interior(x.to(torch_dtype(dtype)),
                                          halo=spec.radius, device=device)
            reps = max(5, min(50, int(4e8 / (math.prod(shape) * k))))
            itemsize = torch_dtype(dtype).itemsize
            pick = tiled.choose_march_tiles(spec, shape, k, dtype=dtype)
            scales = COEFF_SCALES if coeff else None
            weights = None
            times = {}
            for tiles in sorted({*MARCH_TILES, pick}):
                tiles = tuple(min(t, n) for t, n in zip(tiles, shape))
                if tiles in times or not tiled.march_fits(
                        tiles, k, spec.radius, itemsize):
                    continue
                plan = tiled.make_tiled_plan(spec, shape, dtype, k,
                                             tiles=tiles, schedule="march",
                                             coeff_scales=scales)
                if coeff and weights is None:  # one layout for every tile
                    weights = coeff_weights(tiled.pad_coeff(
                        plan, two_material(shape, lo=0.01, hi=1.0, seed=0),
                        DirichletBC.zero(3)).to(device), plan)
                cur = plan.layout.pad_grid(grid)
                nxt = cur.clone()
                tiled_sweep(cur, nxt, plan, coeff=weights)
                ms = timed(lambda: [tiled_sweep(cur, nxt, plan,
                                                coeff=weights)
                                    for _ in range(reps)], device) \
                    / reps * 1e3
                times[tiles] = ms
                writer.writerow((name, *shape, k, dtype, *tiles, repr(ms)))
            fh.flush()
            best = min(times, key=times.get)
            print(f"march{' coeff' if coeff else ''} {name} {shape} k={k} "
                  f"{dtype}: {len(times)} tiles; "
                  f"chooser {pick} {times[pick]:.4f} ms, fastest {best} "
                  f"{times[best]:.4f} ms, {times[pick] / times[best]:.3f}x "
                  f"[{label}]")
            sys.stdout.flush()


def measure_two_level(out: Path,
                      cases: Sequence[TwoLevelCase] = TWO_LEVEL_CASES,
                      seed: int = 0) -> None:
    """Time one two-level march launch at every tile of the march
    chooser's candidates that fits the mode's rings, and one window launch
    at its chooser's tile, for every case on the current CUDA device, the
    two levels random and refreshed for the case's walls; writes
    ``FIELDS_TWO_LEVEL`` rows to ``out`` and prints per case the chooser's
    pick against the fastest march tile, and the window's time."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.ops.layout import refresh_dynamic_layout
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep
    from stencil_tpu_torch.utils.timing import timed

    if not torch.cuda.is_available():
        raise RuntimeError("the tile sweep times the CUDA kernel: it needs "
                           "a card (score and fit need none)")
    device = torch.device("cuda")
    label = gpu_label()
    print(label)
    rng = np.random.default_rng(seed)
    with open(out, "w", newline="") as fh:
        fh.write(f"# {label}, march two-level\n")
        writer = csv.writer(fh)
        writer.writerow(FIELDS_TWO_LEVEL)
        for name, shape, k, dtype, walls in cases:
            spec, bc = spec_of(name), walls_of(walls)
            pins = tiled.dynamic_pins(bc, 3)
            levels = [HaloGrid.from_interior(torch.from_numpy(
                rng.random(shape, dtype=np.float32)).to(torch_dtype(dtype)),
                halo=spec.radius, bc=bc, device=device) for _ in range(2)]
            reps = max(10, min(50, int(4e8 / (math.prod(shape) * k))))
            pick = tiled.choose_march_tiles(
                spec, shape, k, dtype=dtype, deep=True,
                constants=tiled.MARCH_TWO_LEVEL_COST_CONSTANTS)
            window = tiled.make_tiled_plan(spec, shape, dtype, k,
                                           two_level=True, schedule="window")
            times = {}
            for sched, t in [("march", t) for t in march_candidates(
                    shape, k, dtype, True)] + [("window", window.tiles)]:
                plan = tiled.make_tiled_plan(spec, shape, dtype, k, tiles=t,
                                             two_level=True, schedule=sched)
                cur, prev = (refresh_dynamic_layout(
                    plan.layout.pad_grid(g), plan.layout, bc, plan.halo)
                    for g in levels)
                nxt, out2 = cur.clone(), prev.clone()

                def launch():
                    tiled_sweep(cur, nxt, plan, pins=pins, prev=prev,
                                out2=out2)

                launch()
                ms = timed(lambda: [launch() for _ in range(reps)],
                           device) / reps * 1e3
                times[(sched, t)] = ms
                writer.writerow((name, *shape, k, dtype, walls, sched, *t,
                                 repr(ms)))
            fh.flush()
            march = {t: ms for (sched, t), ms in times.items()
                     if sched == "march"}
            best = min(march, key=march.get)
            wms = times[("window", window.tiles)]
            print(f"march two-level {name} {shape} k={k} {dtype} {walls}: "
                  f"{len(march)} tiles; chooser {pick} {march[pick]:.4f} "
                  f"ms, fastest {best} {march[best]:.4f} ms, "
                  f"{march[pick] / march[best]:.3f}x; window "
                  f"{window.tiles} {wms:.4f} ms [{label}]")
            sys.stdout.flush()


def _read_schedule_rows(path: Path, first: str, last: str) -> Dict:
    """Rows of a sweep with a ``schedule`` column, grouped by case
    (row[first], shape, k, dtype, row[last]): {case: {"march": {tiles:
    ms}, "window": (tiles, ms)}}."""
    cases: Dict[tuple, Dict] = {}
    with open(path, newline="") as fh:
        lines = (line for line in fh if not line.startswith("#"))
        for row in csv.DictReader(lines):
            case = (row[first], tuple(int(row[f"n{d}"]) for d in range(3)),
                    int(row["k"]), row["dtype"], row[last])
            tiles = tuple(int(row[f"t{d}"]) for d in range(3))
            rec = cases.setdefault(case, {"march": {}})
            if row["schedule"] == "march":
                rec["march"][tiles] = float(row["ms"])
            else:
                rec["window"] = (tiles, float(row["ms"]))
    return cases


def read_two_level_rows(path: Path) -> Dict[TwoLevelCase, Dict]:
    """Rows of a two-level sweep, grouped by case: {case: {"march":
    {tiles: ms}, "window": (tiles, ms)}}."""
    return _read_schedule_rows(path, "spec", "walls")


def read_cheby_rows(path: Path) -> Dict[ChebyCase, Dict]:
    """Rows of a Chebyshev sweep, grouped by case, as
    :func:`read_two_level_rows`."""
    return _read_schedule_rows(path, "mode", "smoother")


def score_two_level(cases) -> List[dict]:
    """Per two-level case: the chooser's pick
    (``choose_march_tiles``, deep, the two-level constants), its
    measured ms, the fastest measured march tile, their ratio, the
    window's ms and the schedule ``make_tiled_plan`` gives the case."""
    out = []
    for (name, shape, k, dtype, walls), rec in cases.items():
        spec = spec_of(name)
        measured = rec["march"]
        pick = tiled.choose_march_tiles(
            spec, shape, k, dtype=dtype, deep=True,
            constants=tiled.MARCH_TWO_LEVEL_COST_CONSTANTS)
        best = min(measured, key=measured.get)
        out.append({
            "case": (name, shape, k, dtype, walls), "pick": pick,
            "pick_ms": measured[pick], "best": best,
            "best_ms": measured[best],
            "ratio": measured[pick] / measured[best],
            "window": rec["window"],
            "schedule": tiled.make_tiled_plan(spec, shape, dtype, k,
                                              two_level=True).schedule})
    return out


def fit_two_level(cases) -> List[Tuple[float, tuple]]:
    """Constants of ``MARCH_FIT_GRID`` ranked for the two-level mode
    (:func:`rank_march_constants`)."""
    return rank_march_constants(cases, lambda case: spec_of(case[0]))


def rank_march_constants(cases, spec_of_case) -> List[Tuple[float, tuple]]:
    """Constants of ``MARCH_FIT_GRID`` ranked by the geometric mean of the
    pick's time over the fastest tile's (each case picking among its
    measured tiles, the spec ``spec_of_case(case)``), then by the
    distance, in logs, from the homogeneous mode's
    ``MARCH_COST_CONSTANTS``."""
    def geo(constants):
        ratios = []
        for case, rec in cases.items():
            _, shape, k, _, _ = case
            spec, measured = spec_of_case(case), rec["march"]
            pick = min(measured, key=lambda t: (
                tiled._march_cost(t, shape, k, spec, constants), -t[2],
                -math.prod(t)))
            ratios.append(measured[pick] / min(measured.values()))
        return math.exp(sum(map(math.log, ratios)) / len(ratios))

    def distance(constants):
        return sum(abs(math.log(max(c, 1) / b)) for c, b in
                   zip(constants, tiled.MARCH_COST_CONSTANTS))

    return sorted(((geo(c), c) for c in itertools.product(*MARCH_FIT_GRID)),
                  key=lambda gc: (gc[0], distance(gc[1])))


def cheby_plan(case: ChebyCase, tiles=None, schedule=None):
    """The plan of a Chebyshev case: nbsum3d with the multigrid fine
    level's tuples (``smoother`` sweeps at h = 1/(n0+1), then in the dual
    mode the residual's), at ``tiles`` and ``schedule`` or the rule's."""
    from stencil_tpu_torch.multigrid import _cheby_sweep_coeffs, nbsum_spec

    mode, shape, k, dtype, smoother = case
    dual = mode == "dual"
    h = 1.0 / (shape[0] + 1)
    nu = k - 1 if dual else k
    if smoother == "chebyshev":
        co = _cheby_sweep_coeffs(nu, 4.0, 3, h)
    else:
        w = 2.0 / 3.0
        co = ((1.0 - w, w / 6, 0.0, -(w / 6) * h * h),) * nu
    if dual:
        co += ((6.0 / h ** 2, -1.0 / h ** 2, 0.0, 1.0),)
    return tiled.make_tiled_plan(nbsum_spec(3), shape, dtype, k,
                                 tiles=tiles, has_source=True,
                                 cheby_coeffs=co, cheby_dual=dual,
                                 schedule=schedule)


def march_candidates(shape, k: int, dtype: str, deep: bool):
    """Every tile of the march chooser's candidates, clamped to ``shape``,
    whose rings (``deep``: 2r+3 planes) fit at radius 1 (the two-level
    cases' wave3d and the Chebyshev cases' nbsum3d)."""
    tiles = {tuple(min(t, n) for t, n in zip(c, shape))
             for c in itertools.product(tiled.MARCH_T0_CANDIDATES,
                                        tiled._MARCH_T_CANDIDATES,
                                        tiled._MARCH_T_CANDIDATES)}
    return sorted(t for t in tiles if tiled.march_fits(
        t, k, 1, torch_dtype(dtype).itemsize, deep))


def measure_cheby(out: Path, cases: Sequence[ChebyCase] = CHEBY_CASES,
                  seed: int = 0) -> None:
    """Time one Chebyshev or dual march launch at every tile of the march
    chooser's candidates that fits the deep rings, and one window launch
    at its chooser's tile, for every case on the current CUDA device (u and
    f random, the reference walls); writes ``FIELDS_CHEBY`` rows to
    ``out`` and prints per case the chooser's pick against the fastest
    march tile, and the window's time."""
    import torch

    from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep
    from stencil_tpu_torch.utils.timing import timed

    if not torch.cuda.is_available():
        raise RuntimeError("the tile sweep times the CUDA kernel: it needs "
                           "a card (score and fit need none)")
    device = torch.device("cuda")
    label = gpu_label()
    print(label)
    rng = np.random.default_rng(seed)
    bc = DirichletBC(values=((0.5, -1.0), (2.0, 0.25), (1.0, 1.5)))
    with open(out, "w", newline="") as fh:
        fh.write(f"# {label}, march cheby\n")
        writer = csv.writer(fh)
        writer.writerow(FIELDS_CHEBY)
        for case in cases:
            mode, shape, k, dtype, smoother = case
            grid = HaloGrid.from_interior(torch.from_numpy(
                rng.random(shape, dtype=np.float32)).to(torch_dtype(dtype)),
                halo=1, bc=bc, device=device)
            f = rng.normal(size=shape)
            reps = max(10, min(50, int(4e8 / (math.prod(shape) * k))))
            pick = cheby_plan(case, schedule="march").tiles
            window = cheby_plan(case, schedule="window")
            cur = window.layout.pad_grid(grid)  # one layout for every tile
            src = pad_source(window, f, 1.0, bc).to(device)
            nxt, out2 = cur.clone(), cur.clone() if mode == "dual" else None
            times = {}
            for sched, t in [("march", t) for t in march_candidates(
                    shape, k, dtype, True)] + [("window", window.tiles)]:
                plan = cheby_plan(case, t, sched)

                def launch():
                    tiled_sweep(cur, nxt, plan, src, out2=out2)

                launch()
                ms = timed(lambda: [launch() for _ in range(reps)],
                           device) / reps * 1e3
                times[(sched, t)] = ms
                writer.writerow((mode, *shape, k, dtype, smoother, sched,
                                 *t, repr(ms)))
            fh.flush()
            march = {t: ms for (sched, t), ms in times.items()
                     if sched == "march"}
            best = min(march, key=march.get)
            wms = times[("window", window.tiles)]
            print(f"march {mode} {smoother} {shape} k={k} {dtype}: "
                  f"{len(march)} tiles; chooser {pick} {march[pick]:.4f} "
                  f"ms, fastest {best} {march[best]:.4f} ms, "
                  f"{march[pick] / march[best]:.3f}x; window "
                  f"{window.tiles} {wms:.4f} ms [{label}]")
            sys.stdout.flush()


def score_cheby(cases) -> List[dict]:
    """Per Chebyshev case: the chooser's pick
    (``make_tiled_plan``'s march tiles), its measured ms, the fastest
    measured march tile, their ratio, the window's ms and the schedule
    ``make_tiled_plan`` gives the case."""
    out = []
    for case, rec in cases.items():
        measured = rec["march"]
        pick = cheby_plan(case, schedule="march").tiles
        best = min(measured, key=measured.get)
        out.append({
            "case": case, "pick": pick, "pick_ms": measured[pick],
            "best": best, "best_ms": measured[best],
            "ratio": measured[pick] / measured[best],
            "window": rec["window"], "schedule": cheby_plan(case).schedule})
    return out


def fit_cheby(cases) -> List[Tuple[float, tuple]]:
    """Constants of ``MARCH_FIT_GRID`` ranked for the Chebyshev and dual
    modes (:func:`rank_march_constants`, the spec nbsum3d)."""
    from stencil_tpu_torch.multigrid import nbsum_spec

    return rank_march_constants(cases, lambda case: nbsum_spec(3))


def report_schedule_rows(kind: str, results) -> None:
    """Print a scored sweep with a ``schedule`` column, case by case."""
    for r in results:
        wt, wms = r["window"]
        print(f"march {kind} {r['case']}: pick {r['pick']} "
              f"{r['pick_ms']:.4f} ms, best {r['best']} "
              f"{r['best_ms']:.4f} ms, {r['ratio']:.3f}x; window "
              f"{wt} {wms:.4f} ms; the plan takes the {r['schedule']}")
    print(f"geometric mean {geomean(results):.4f}x the best tile, worst "
          f"{max(r['ratio'] for r in results):.4f}x")


def measure_slab_march(out: Path,
                       cases: Sequence[SlabMarchCase] = SLAB_MARCH_CASES,
                       seed: int = 0) -> None:
    """Time one launch of the 2D march at every tile of its chooser's
    candidates, and one of the window at its chooser's tile, for every
    case on the current CUDA device; writes ``FIELDS_MARCH_2D`` rows to
    ``out`` and prints per case the march chooser's pick against the
    fastest march tile, and the window's time."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.ops.slab_kernel import slab_sweep
    from stencil_tpu_torch.utils.timing import timed

    if not torch.cuda.is_available():
        raise RuntimeError("the tile sweep times the CUDA kernel: it needs "
                           "a card (score and fit need none)")
    device = torch.device("cuda")
    label = gpu_label()
    print(label)
    rng = np.random.default_rng(seed)
    with open(out, "w", newline="") as fh:
        fh.write(f"# {label}, 2D march\n")
        writer = csv.writer(fh)
        writer.writerow(FIELDS_MARCH_2D)
        for name, shape, k, dtype, source, t0_fixed in cases:
            spec = spec_of(name)
            tdt = torch_dtype(dtype)
            x = torch.from_numpy(rng.random(shape, dtype=np.float32))
            grid = HaloGrid.from_interior(x.to(tdt), halo=spec.radius,
                                          device=device)
            reps = max(5, min(100, int(4e8 / (math.prod(shape) * k))))
            pick = slab.choose_slab_march_tiles(spec, shape, k, t0_fixed,
                                                dtype)
            tiles = slab.march_candidates(spec, shape, k, t0_fixed,
                                          tdt.itemsize)
            window = make_slab_plan(spec, shape, dtype, k, t0_fixed=t0_fixed,
                                    schedule="window")
            times = {}
            for sched, t in [("march", t) for t in tiles] \
                    + [("window", window.tiles)]:
                plan = make_slab_plan(spec, shape, dtype, k, tiles=t,
                                      schedule=sched)
                cur = plan.layout.pad_grid(grid)
                nxt = cur.clone()
                src = torch.full_like(cur, 0.01) if source else None
                slab_sweep(cur, nxt, plan, src)
                ms = timed(lambda: [slab_sweep(cur, nxt, plan, src)
                                    for _ in range(reps)], device) \
                    / reps * 1e3
                times[(sched, t)] = ms
                writer.writerow((name, *shape, k, dtype, int(source),
                                 "" if t0_fixed is None else t0_fixed,
                                 sched, *t, repr(ms)))
            fh.flush()
            march = {t: ms for (sched, t), ms in times.items()
                     if sched == "march"}
            best = min(march, key=march.get)
            wms = times[("window", window.tiles)]
            print(f"2D march {name} {shape} k={k} {dtype} source={source} "
                  f"t0_fixed={t0_fixed}: {len(march)} tiles; chooser {pick}"
                  f" {march[pick]:.4f} ms, fastest {best} {march[best]:.4f}"
                  f" ms, {march[pick] / march[best]:.3f}x; window "
                  f"{window.tiles} {wms:.4f} ms [{label}]")
            sys.stdout.flush()


def read_slab_march_rows(path: Path) -> Dict[SlabMarchCase, Dict[
        Tuple[str, Tuple[int, int]], float]]:
    """Rows of a 2D march sweep, grouped by case: {case: {(schedule,
    tiles): ms}}."""
    cases: Dict[SlabMarchCase, Dict[Tuple[str, Tuple[int, int]], float]] \
        = {}
    with open(path, newline="") as fh:
        lines = (line for line in fh if not line.startswith("#"))
        for row in csv.DictReader(lines):
            case = (row["spec"], (int(row["n0"]), int(row["n1"])),
                    int(row["k"]), row["dtype"], bool(int(row["source"])),
                    int(row["t0_fixed"]) if row["t0_fixed"] else None)
            key = (row["schedule"], (int(row["t0"]), int(row["t1"])))
            cases.setdefault(case, {})[key] = float(row["ms"])
    return cases


def score_slab_march(cases, constants=None, window=None) -> List[dict]:
    """Per 2D march case: the tile the march model (``constants``, default
    ``SLAB_MARCH_COST_CONSTANTS``) picks among the measured march tiles,
    its ms, the fastest measured march tile and its ms; the window's ms;
    the schedule the rule (``window``: ``WINDOW_MS_CONSTANTS``) gives and
    the faster measured one."""
    constants = constants or slab.SLAB_MARCH_COST_CONSTANTS
    window = window or slab.WINDOW_MS_CONSTANTS
    out = []
    for case, measured in cases.items():
        name, shape, k, dtype, _, _ = case
        spec = spec_of(name)
        item = torch_dtype(dtype).itemsize
        march = {t: ms for (sched, t), ms in measured.items()
                 if sched == "march"}
        (wtiles, wms), = ((t, ms) for (sched, t), ms in measured.items()
                          if sched == "window")
        pick = min(march, key=lambda t: slab.march_key(
            t, k, spec, shape, item, constants))
        rule = "march" if slab.march_wins(pick, wtiles, k, spec, shape,
                                          item, constants, window) \
            else "window"
        best = min(march, key=march.get)
        out.append({"case": case, "pick": pick, "pick_ms": march[pick],
                    "best": best, "best_ms": march[best],
                    "ratio": march[pick] / march[best],
                    "window_ms": wms, "rule": rule,
                    "faster": "march" if march[pick] < wms else "window"})
    return out


def fit_slab_march(cases) -> Tuple[tuple, tuple]:
    """The march's constants of least squared log error over its rows;
    then the window's (ms per cost unit, floor ms) under which the rule
    takes the faster measured schedule in the most cases, and of those
    the least squared log error over the window rows."""
    def log_err(pairs):
        return sum(math.log(p / m) ** 2 for p, m in pairs)

    rows = [(case, sched, t, ms) for case, measured in cases.items()
            for (sched, t), ms in measured.items()]

    def args(case):
        name, shape, k, dtype, _, _ = case
        return spec_of(name), shape, k, torch_dtype(dtype).itemsize

    marches = [(args(c), t, ms) for c, sched, t, ms in rows
               if sched == "march"]
    march = min(itertools.product(*SLAB_MARCH_FIT_GRID),
                key=lambda cst: log_err(
                    (slab._slab_march_cost(t, a[1], a[2], a[0], a[3], cst),
                     ms) for a, t, ms in marches))
    costs = [(slab._cost(t, a[2], a[0], a[1], itemsize=a[3]), ms)
             for a, t, ms in ((args(c), t, ms) for c, sched, t, ms in rows
                              if sched == "window")]

    def key(w):
        agree = sum(r["rule"] == r["faster"]
                    for r in score_slab_march(cases, march, w))
        return -agree, log_err((max(w[1], w[0] * c), ms) for c, ms in costs)

    window = min(((scale * 1e-6, launch)
                  for scale, launch in itertools.product(*WINDOW_FIT_GRID)),
                 key=key)
    return march, window


def read_march_rows(path: Path) -> Dict[MarchCase,
                                        Dict[Tuple[int, int, int], float]]:
    """Rows of a march sweep, grouped by case: {case: {tiles: ms}}."""
    cases: Dict[MarchCase, Dict[Tuple[int, int, int], float]] = {}
    with open(path, newline="") as fh:
        lines = (line for line in fh if not line.startswith("#"))
        for row in csv.DictReader(lines):
            case = (row["spec"], tuple(int(row[f"n{d}"]) for d in range(3)),
                    int(row["k"]), row["dtype"])
            tiles = tuple(int(row[f"t{d}"]) for d in range(3))
            cases.setdefault(case, {})[tiles] = float(row["ms"])
    return cases


def score_march(cases, constants=tiled.MARCH_COST_CONSTANTS) -> List[dict]:
    """Per march case: the tile the march cost model with ``constants``
    (point, load, step) picks among the measured tiles, its ms, the best
    measured tile and its ms."""
    out = []
    for (name, shape, k, dtype), measured in cases.items():
        spec = get_spec(name)
        pick = min(measured, key=lambda t: (
            tiled._march_cost(t, shape, k, spec, constants), -t[2],
            -math.prod(t)))
        best = min(measured, key=measured.get)
        out.append({"case": (name, shape, k, dtype), "pick": pick,
                    "pick_ms": measured[pick], "best": best,
                    "best_ms": measured[best],
                    "ratio": measured[pick] / measured[best]})
    return out


def read_rows(path: Path) -> Dict[Case, Dict[Tuple[int, int], float]]:
    """Rows of a sweep, grouped by case: {case: {tiles: ms}}."""
    cases: Dict[Case, Dict[Tuple[int, int], float]] = {}
    with open(path, newline="") as fh:
        lines = (line for line in fh if not line.startswith("#"))
        for row in csv.DictReader(lines):
            case = (row["spec"], (int(row["n0"]), int(row["n1"])),
                    int(row["k"]),
                    int(row["t0_fixed"]) if row["t0_fixed"] else None)
            cases.setdefault(case, {})[(int(row["t0"]), int(row["t1"]))] = \
                float(row["ms"])
    return cases


def score(cases: Dict[Case, Dict[Tuple[int, int], float]],
          constants=COST_CONSTANTS) -> List[dict]:
    """Per case: the tile the chooser with ``constants`` picks among the
    measured tiles it weighs, its ms, the best measured tile and its ms."""
    out = []
    for (name, shape, k, t0_fixed), measured in cases.items():
        spec = get_spec(name)
        weighed = [t for t in candidate_tiles(spec, shape, k, t0_fixed)
                   if t in measured]
        pick = min(weighed, key=lambda t: tile_key(t, k, spec, shape,
                                                   constants))
        best = min(measured, key=measured.get)
        out.append({"case": (name, shape, k, t0_fixed), "pick": pick,
                    "pick_ms": measured[pick], "best": best,
                    "best_ms": measured[best],
                    "ratio": measured[pick] / measured[best]})
    return out


def report_slab_march(cases, constants, window) -> None:
    """Print :func:`score_slab_march` per case and in sum."""
    results = score_slab_march(cases, constants, window)
    for r in results:
        print(f"2D march {r['case']}: pick {r['pick']} {r['pick_ms']:.4f} "
              f"ms, best {r['best']} {r['best_ms']:.4f} ms, "
              f"{r['ratio']:.3f}x; window {r['window_ms']:.4f} ms; rule "
              f"{r['rule']}, faster {r['faster']}")
    print(f"march constants {constants}, window constants {window}: "
          f"geometric mean {geomean(results):.4f}x the best tile, worst "
          f"{max(r['ratio'] for r in results):.4f}x; the rule takes the "
          f"faster schedule in "
          f"{sum(r['rule'] == r['faster'] for r in results)} of "
          f"{len(results)} cases")


def geomean(results: List[dict]) -> float:
    return math.exp(sum(math.log(r["ratio"]) for r in results)
                    / len(results))


def fit(cases, grid=FIT_GRID) -> List[Tuple[float, tuple]]:
    """(geometric mean, constants) for every point of ``grid``, best
    first."""
    return sorted((geomean(score(cases, c)), c)
                  for c in itertools.product(*grid))


# the in-kernel exchange's tile rule (parallel/rma.py:choose_rma_tile):
# the cases its constants are fitted to (spec, global shape, mesh, k,
# dtype), and the cases held out of the fit
RMA_CASES = (
    ("jacobi7", (64, 64, 128), (1,), 2, "float32"),
    ("jacobi7", (64, 64, 128), (2, 2), 2, "float32"),
    ("jacobi7", (128, 128, 128), (1,), 2, "float32"),
    ("jacobi7", (8, 8, 16), (1,), 2, "float32"),
    ("star3d_r2", (32, 32, 20), (2, 2), 2, "float32"),
    ("jacobi27", (32, 64, 40), (2,), 3, "float32"),
    ("jacobi5", (64, 40), (4,), 4, "float32"),
    ("jacobi7", (64, 64, 128), (1,), 2, "bfloat16"),
)
RMA_HELD_OUT = (
    ("jacobi7", (64, 64, 128), (2,), 2, "float32"),
    ("jacobi7", (160, 160, 160), (1,), 2, "bfloat16"),
    ("jacobi7", (128, 128, 128), (2, 2), 2, "float32"),
    ("jacobi5", (32, 256), (2, 2), 2, "float32"),
    ("jacobi27", (32, 64, 40), (2, 4), 2, "float32"),
)
RMA_FIELDS = ("spec", "shape", "mesh", "k", "dtype", "tile", "tiles",
              "us_per_step")
RMA_STEPS = (64, 256)   # the two launches whose marginal is the step
RmaCase = Tuple[str, Tuple[int, ...], Tuple[int, ...], int, str]


def _dims(text: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in text.split("x"))


def _rma_plan(case: RmaCase):
    from stencil_tpu_torch.parallel.rma import RmaStencil

    name, shape, mesh, k, dtype = case
    return RmaStencil(get_spec(name), shape, dtype, k).local_plan(mesh)


def rma_tiles_to_time(case: RmaCase, count: int = 20) -> List[tuple]:
    """The tiles one case times: the ``count`` // 2 the rule ranks first
    (its pick first), then as many spread over the rest of its ranking."""
    from stencil_tpu_torch.parallel.rma import tile_candidates, tile_cost

    plan = _rma_plan(case)
    ranked = sorted(
        (c, t) for t in itertools.product(*map(tile_candidates,
                                              plan.local_shape))
        if (c := tile_cost(plan.local_shape, t, plan.ranks,
                           plan.sweeps_per_call, plan.spec.radius,
                           plan.itemsize)) is not None)
    tiles = [t for _, t in ranked]
    head, rest = tiles[:count // 2], tiles[count // 2:]
    step = max(1, len(rest) // (count - len(head)))
    return head + rest[::step][:count - len(head)]


def measure_rma(out: Path, cases: Sequence[RmaCase] = RMA_CASES,
                seed: int = 0) -> None:
    """Time the rma kernel's step (the marginal of launches of the two
    RMA_STEPS, each the mean of 5 launches back to back between CUDA
    events, so the host's enqueue hides behind the device, the least of 3)
    at :func:`rma_tiles_to_time` of every case on the current CUDA device;
    writes ``RMA_FIELDS`` rows to ``out`` and prints per case the rule's
    pick against the fastest tile."""
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, make_rma_plan, rma_iterate, rma_tiles,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("the tile sweep times the CUDA kernel: it needs "
                           "a card (score and fit need none)")
    device = torch.device("cuda")
    label = gpu_label()
    print(label)
    rng = np.random.default_rng(seed)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def ms(run):
        run()
        best = math.inf
        for _ in range(3):
            events[0].record()
            for _ in range(5):
                run()
            events[1].record()
            torch.cuda.synchronize()
            best = min(best, events[0].elapsed_time(events[1]) / 5)
        return best

    with open(out, "w", newline="") as fh:
        fh.write(f"# {label}\n")
        writer = csv.writer(fh)
        writer.writerow(RMA_FIELDS)
        for case in cases:
            name, shape, mesh_shape, k, dtype = case
            spec = get_spec(name)
            x = torch.from_numpy(rng.random(shape, dtype=np.float32))
            grid = HaloGrid.from_interior(x.to(torch_dtype(dtype)),
                                          halo=spec.radius, device=device)
            mesh = make_mesh(mesh_shape, ("x", "y")[:len(mesh_shape)],
                             device=device)
            method = RmaStencil(spec, shape, dtype, k)
            pick = method.plan_for(mesh)
            times = {}
            for tile in rma_tiles_to_time(case):
                plan = make_rma_plan(spec, pick.local_shape, dtype,
                                     mesh_shape, k, tile=tile,
                                     cards=pick.cards, virtual=pick.virtual)
                bufs = method.scatter(grid, mesh, plan)
                one, two = (ms(lambda n=n: rma_iterate(bufs, plan, n))
                            for n in RMA_STEPS)
                times[tile] = (two - one) / (RMA_STEPS[1] - RMA_STEPS[0]) \
                    * 1e3
                writer.writerow((name, "x".join(map(str, shape)),
                                 "x".join(map(str, mesh_shape)), k, dtype,
                                 "x".join(map(str, tile)),
                                 rma_tiles(plan).ntiles,
                                 repr(times[tile])))
                del bufs
            fh.flush()
            best = min(times, key=times.get)
            print(f"rma {name} {shape} mesh {mesh_shape} k={k} {dtype}: "
                  f"{len(times)} tiles; rule {pick.tile} "
                  f"{times[pick.tile]:.2f} us per step, fastest {best} "
                  f"{times[best]:.2f}, {times[pick.tile] / times[best]:.3f}x"
                  f" [{label}]")
            sys.stdout.flush()


def read_rma_rows(path: Path) -> Dict[RmaCase, Dict[tuple, float]]:
    cases: Dict[RmaCase, Dict[tuple, float]] = {}
    with open(path) as fh:
        for row in csv.DictReader(line for line in fh
                                  if not line.startswith("#")):
            case = (row["spec"], _dims(row["shape"]), _dims(row["mesh"]),
                    int(row["k"]), row["dtype"])
            cases.setdefault(case, {})[_dims(row["tile"])] = float(
                row["us_per_step"])
    return cases


def _rma_features(case: RmaCase, tile) -> Tuple[int, int, int]:
    from stencil_tpu_torch.parallel.rma import tile_features

    plan = _rma_plan(case)
    return tile_features(plan.local_shape, tile, plan.ranks,
                         plan.sweeps_per_call, plan.spec.radius,
                         plan.itemsize)


def score_rma(cases, constants=None) -> List[dict]:
    """Per case, the rule's pick among the measured tiles (with
    ``constants``, else the committed ones) against the fastest."""
    from stencil_tpu_torch.parallel.rma import RMA_TILE_CONSTANTS

    a, b, c = RMA_TILE_CONSTANTS if constants is None else constants
    results = []
    for case, times in cases.items():
        est = {t: c * f[0] + a * f[1] + b * f[2]
               for t in times for f in (_rma_features(case, t),)}
        pick = min(times, key=lambda t: (est[t], -math.prod(t)))
        best = min(times, key=times.get)
        results.append({"case": case, "pick": pick, "pick_ms": times[pick],
                        "best": best, "best_ms": times[best],
                        "ratio": times[pick] / times[best]})
    return results


def fit_rma(cases) -> Tuple[float, float, float]:
    """The constants (a, b, c) >= 0 of least squared relative error of the
    estimate over every measured row: a least-squares fit of the rows'
    features to their times, each row divided by its time, a constant
    that comes out negative dropped and the rest fitted again."""
    rows = [(_rma_features(case, t), us * 1e3)
            for case, times in cases.items() for t, us in times.items()]
    x = np.asarray([[f[1], f[2], f[0]] for f, _ in rows], float)
    y = np.asarray([ns for _, ns in rows], float)
    keep = [0, 1, 2]
    while True:
        sol, *_ = np.linalg.lstsq(x[:, keep] / y[:, None], np.ones(len(y)),
                                  rcond=None)
        if (sol >= 0).all():
            break
        keep.pop(int(np.argmin(sol)))
    out = [0.0, 0.0, 0.0]
    for i, v in zip(keep, sol):
        out[i] = float(v)
    return tuple(out)


def report_rma(cases, constants=None) -> None:
    results = score_rma(cases, constants)
    for r in results:
        name, shape, mesh, k, dtype = r["case"]
        print(f"rma {name} {shape} mesh {mesh} k={k} {dtype}: pick "
              f"{r['pick']} {r['pick_ms']:.2f} us, best {r['best']} "
              f"{r['best_ms']:.2f} us, {r['ratio']:.3f}x")
    print(f"rma constants {constants or 'committed'}: geometric mean "
          f"{geomean(results):.4f}x the best tile, worst "
          f"{max(r['ratio'] for r in results):.4f}x over {len(results)} "
          "cases")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m stencil_tpu_torch.tile_sweep",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    help="time the tiles on the card, rows to this CSV")
    ap.add_argument("--score", type=Path,
                    help="score the chooser against this CSV's rows")
    ap.add_argument("--fit", action="store_true",
                    help="with --score: refit the cost constants")
    ap.add_argument("--dtype", default="float32",
                    choices=list(tiled.DTYPES),
                    help="with --out: the grid's dtype (the kernels' bf16 "
                         "entries take 2-byte windows)")
    ap.add_argument("--dims", type=int, default=None, choices=(2, 3),
                    help="2 (the slab kernel, CASES; the default) or 3 "
                         "(the tiled kernel, CASES_3D); with --march, 3 "
                         "unless 2 is given")
    ap.add_argument("--march", action="store_true",
                    help="the march schedule: time MARCH_TILES at "
                         "MARCH_CASES (--dims 3, the default with --march) "
                         "or the 2D march at SLAB_MARCH_CASES (--dims 2), "
                         "or score and refit the march chooser")
    ap.add_argument("--held-out", action="store_true",
                    help="with --dims 2 --march --out: time "
                         "SLAB_MARCH_HELD_OUT, the cases the fit never saw"
                         " (with --two-level: TWO_LEVEL_HELD_OUT)")
    ap.add_argument("--two-level", action="store_true",
                    help="with --march: the two-level mode at "
                         "TWO_LEVEL_CASES")
    ap.add_argument("--cheby", action="store_true",
                    help="with --march: the Chebyshev and dual modes at "
                         "CHEBY_CASES (with --held-out: CHEBY_HELD_OUT)")
    ap.add_argument("--coeff", action="store_true",
                    help="with --march --out: the coefficient mode at "
                         "MARCH_COEFF_CASES")
    ap.add_argument("--rma", action="store_true",
                    help="the in-kernel exchange's tiles: time RMA_CASES "
                         "(--held-out: RMA_HELD_OUT), or score and refit "
                         "its tile rule")
    args = ap.parse_args(argv)
    if args.out is None and args.score is None:
        ap.error("give --out (measure) or --score (score, fit)")
    if args.rma:
        if args.out is not None:
            measure_rma(args.out, RMA_HELD_OUT if args.held_out
                        else RMA_CASES)
        if args.score is not None:
            cases = read_rma_rows(args.score)
            report_rma(cases)
            if args.fit:
                constants = fit_rma(cases)
                print(f"fit: rma constants {constants}")
                report_rma(cases, constants)
        return 0
    if args.march and args.dims == 2:
        if args.out is not None:
            measure_slab_march(args.out, SLAB_MARCH_HELD_OUT
                               if args.held_out else SLAB_MARCH_CASES)
        if args.score is not None:
            cases = read_slab_march_rows(args.score)
            report_slab_march(cases, slab.SLAB_MARCH_COST_CONSTANTS,
                              slab.WINDOW_MS_CONSTANTS)
            if args.fit:
                march, window = fit_slab_march(cases)
                print(f"fit: march constants {march}, window constants "
                      f"{window}")
                report_slab_march(cases, march, window)
        return 0
    if args.march and (args.two_level or args.cheby):
        measure_rows, read_rows_, score_rows, fit_rows, cases_, held = (
            (measure_cheby, read_cheby_rows, score_cheby, fit_cheby,
             CHEBY_CASES, CHEBY_HELD_OUT) if args.cheby else
            (measure_two_level, read_two_level_rows, score_two_level,
             fit_two_level, TWO_LEVEL_CASES, TWO_LEVEL_HELD_OUT))
        if args.out is not None:
            measure_rows(args.out, held if args.held_out else cases_)
        if args.score is not None:
            cases = read_rows_(args.score)
            report_schedule_rows("cheby" if args.cheby else "two-level",
                                 score_rows(cases))
            if args.fit:
                for g, c in fit_rows(cases)[:5]:
                    print(f"fit: constants {c}: geometric mean {g:.4f}x")
        return 0
    if args.march:
        if args.out is not None:
            measure_march(args.out, MARCH_COEFF_CASES if args.coeff
                          else MARCH_CASES, coeff=args.coeff)
        if args.score is not None:
            cases = read_march_rows(args.score)
            results = score_march(cases)
            for r in results:
                print(f"march {r['case']}: pick {r['pick']} "
                      f"{r['pick_ms']:.4f} ms, best {r['best']} "
                      f"{r['best_ms']:.4f} ms, {r['ratio']:.3f}x")
            print(f"march constants {tiled.MARCH_COST_CONSTANTS}: geometric "
                  f"mean {geomean(results):.4f}x "
                  f"the best tile, worst "
                  f"{max(r['ratio'] for r in results):.4f}x")
            if args.fit:
                ranked = sorted((geomean(score_march(cases, c)), c)
                                for c in itertools.product(*MARCH_FIT_GRID))
                for g, c in ranked[:5]:
                    print(f"fit: constants {c}: geometric mean {g:.4f}x")
        return 0
    if args.out is not None:
        measure(args.out, CASES_3D if args.dims == 3 else CASES,
                dtype=args.dtype)
    if args.score is not None:
        cases = read_rows(args.score)
        results = score(cases)
        for r in results:
            name, shape, k, t0_fixed = r["case"]
            chooser = choose_tiles(get_spec(name), shape, k, t0_fixed)
            print(f"{name} {shape} k={k} t0_fixed={t0_fixed}: pick "
                  f"{r['pick']} {r['pick_ms']:.4f} ms, best {r['best']} "
                  f"{r['best_ms']:.4f} ms, {r['ratio']:.3f}x"
                  + ("" if chooser == r["pick"] else
                     f" (the chooser's own {chooser} was not measured)"))
        print(f"constants {COST_CONSTANTS}: geometric mean "
              f"{geomean(results):.4f}x the best tile, worst "
              f"{max(r['ratio'] for r in results):.4f}x over "
              f"{len(results)} cases, {sum(map(len, cases.values()))} rows")
        if args.fit:
            for g, c in fit(cases)[:5]:
                print(f"fit: constants {c}: geometric mean {g:.4f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
