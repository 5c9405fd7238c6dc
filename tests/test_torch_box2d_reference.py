"""The port's 2D path against the benchmark's float64 reference of the
9-point box (``benchmark/reference2d.py``), on the CPU: the
``pallas_temporal`` runner at k=4, the configuration ``jacobi9_4096``'s
depth, through the registry and ``Runner.iterate``, as the benchmark's
2D cell runs it. The box reads the Dirichlet corner ghosts, so the corner
rule (d1's walls win) is checked with every case; a reference with d0's
walls in the corners and the program's bf16 path both fail the tolerance.
The 2D plan is traced like the 3D one (``plan.make``, ``plans_made``) and a
2D iterate records the runner's copy spans."""

import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import reference2d  # noqa: E402
from benchmark.reference import max_rel_error  # noqa: E402
from stencil_tpu_torch.config import RunConfig  # noqa: E402
from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid  # noqa: E402
from stencil_tpu_torch.core.spec import NAMED_SPECS  # noqa: E402
from stencil_tpu_torch.ops.slab import (  # noqa: E402
    SlabStencil, make_slab_plan,
)
from stencil_tpu_torch.registry import get_runner  # noqa: E402
from stencil_tpu_torch.utils import tracing  # noqa: E402

K = 4
WEIGHT = 0.125
# a distinct value on each face, so that a corner taken from the wrong dim
# moves the corner cells by 1/8 of a 0.375-0.625 difference; each exact in
# float32, so that the program's ring and the reference's are equal
WALLS = ((0.875, 0.125), (0.25, 0.625))
# fp32 against float64 over at most 10 sweeps: each update rounds a sum of
# eight terms in [0, 1] and one multiply by 1/8 (exact), a few units of
# 2^-24 (6e-8) of the field's scale per sweep, so under 1e-6 after 10;
# the tolerance leaves 10x room above that (1.2-1.5e-7 read here) and sits
# far under what corners from d0 (~0.1) or bfloat16 sweeps (~8e-3) give
TOL = 1e-5
SHAPES = [(37, 53), (64, 40), (9, 300)]


def _interior(shape, seed=7):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _run(interior, steps, block=None, dtype="float32"):
    shape = tuple(interior.shape)
    grid = HaloGrid.from_interior(interior.to(getattr(torch, dtype)),
                                  halo=1, bc=DirichletBC(values=WALLS),
                                  device="cpu")
    config = RunConfig(size=shape, spec="jacobi9", dtype=dtype,
                       methods=("pallas_temporal",), temporal=K, block=block,
                       device="cpu", autotune=False)
    runner = get_runner("pallas_temporal", config, NAMED_SPECS["jacobi9"](),
                        grid)
    assert runner.granularity == K
    assert runner.plan_info["kernel"] == "slab"
    return runner.iterate(grid, steps).interior()


def _d0_wins(interior, steps):
    """The reference with d0's walls in the corners: the box is symmetric
    under a transpose, and the transposed problem's d1 is d0."""
    return reference2d.box9_steps(interior.t(), WALLS[::-1], steps,
                                  WEIGHT).t()


@pytest.mark.parametrize("block", [None, 256])
@pytest.mark.parametrize("steps", [4, 8, 10])
@pytest.mark.parametrize("shape", SHAPES)
def test_runner_matches_box9_reference(shape, steps, block):
    """k=4 launches (and at 10 steps a remainder launch of 2) agree with
    ``steps`` float64 sweeps of the box with d1's walls in the corners."""
    interior = _interior(shape)
    got = _run(interior, steps, block)
    want = reference2d.box9_steps(interior, WALLS, steps, WEIGHT)
    assert max_rel_error(got, want) < TOL


def test_d0_corner_order_breaks_the_tolerance():
    interior = _interior(SHAPES[0])
    got = _run(interior, 8)
    assert max_rel_error(got, _d0_wins(interior, 8)) > 100 * TOL


def test_bf16_path_breaks_the_tolerance():
    interior = _interior(SHAPES[0])
    got = _run(interior, 8, dtype="bfloat16")
    want = reference2d.box9_steps(interior, WALLS, 8, WEIGHT)
    assert max_rel_error(got, want) > 100 * TOL


def test_reference_single_step_by_hand():
    """One sweep on a 3x3 interior, each cell's eight neighbours summed by
    hand from the ghost ring d0 (10, 20), d1 (30, 40), d1's in the
    corners:

        30 10 10 10 40
        30  1  2  3 40
        30  4  5  6 40
        30  7  8  9 40
        30 20 20 20 40
    """
    interior = torch.arange(1.0, 10.0).reshape(3, 3)
    got = reference2d.box9_steps(interior, ((10.0, 20.0), (30.0, 40.0)), 1,
                                 WEIGHT)
    sums = [[121, 49, 153], [113, 40, 147], [147, 91, 179]]
    want = torch.tensor(sums, dtype=torch.float64) / 8
    assert got.dtype == torch.float64
    assert torch.equal(got, want)


def test_reference_ring_is_the_programs():
    """The reference's ghost ring equals the one the program's grid holds
    (``HaloGrid.from_interior``: Dirichlet faces in increasing dim order)."""
    interior = _interior((5, 7))
    grid = HaloGrid.from_interior(interior, halo=1,
                                  bc=DirichletBC(values=WALLS), device="cpu")
    assert torch.equal(reference2d.padded(interior, WALLS),
                       grid.data.to(torch.float64))


@pytest.fixture
def traced():
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def test_slab_plan_is_a_traced_plan(traced):
    before = tracing.counters().get("plans_made", 0)
    plan = make_slab_plan(NAMED_SPECS["jacobi9"](), (64, 40),
                          sweeps_per_call=K, t0_fixed=256)
    assert plan.sweeps_per_call == K
    assert tracing.counters()["plans_made"] - before == 1
    spans = tracing.drain()
    assert [s.name for s in spans] == ["plan.make"]
    assert spans[0].end_ns >= spans[0].start_ns


def test_2d_iterate_records_the_runner_spans(traced):
    shape = (37, 53)
    st = SlabStencil(NAMED_SPECS["jacobi9"](), shape, sweeps_per_call=K,
                     device="cpu")
    grid = HaloGrid.from_interior(_interior(shape), halo=1,
                                  bc=DirichletBC(values=WALLS), device="cpu")
    tracing.drain()   # the plan's span
    st.iterate(grid, 10)
    names = Counter(s.name for s in tracing.drain())
    assert names["runner.iterate"] == 1
    for copy in ("runner.pad", "runner.clone", "runner.unpad",
                 "runner.from_interior"):
        assert names[copy] == 1, copy
    assert names["runner.launch"] == 3   # 4 + 4 + a remainder of 2
