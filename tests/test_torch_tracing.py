"""The port's spans and counters (stencil_tpu_torch/utils/tracing.py) on the
CPU: off, a span is one shared context that records nothing and the
results are bitwise those of a traced run; on, a PCG solve and a runner's
iterate record the spans their layers name, each under the right parent
and call, and the counters count the solve's host reads and the plans it
makes; ``--profile`` puts the spans in the profiler's Chrome trace."""

import json
import math
from collections import Counter

import pytest
import torch

from stencil_tpu_torch import cli
from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
from stencil_tpu_torch.core.spec import NAMED_SPECS
from stencil_tpu_torch.krylov import ConjugateGradient
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.multigrid import Multigrid
from stencil_tpu_torch.ops.tiled import TiledStencil
from stencil_tpu_torch.utils import tracing

PCG_SHAPE = (31, 31, 31)   # 3 levels at min_size 7: 31, 15, 7
PCG_LEVELS = 3
PLANS_PER_SOLVE = 3        # Chebyshev pre (= post), the dual, the residual


@pytest.fixture
def traced():
    tracing.drain()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.drain()


def _pcg(shape=PCG_SHAPE):
    prob = PoissonProblem(shape=shape, device="cpu")
    mg = Multigrid(prob, nu1=2, nu2=2, smoother="chebyshev", min_size=7,
                   fine_method="pallas_tiled")
    assert mg.levels == PCG_LEVELS or shape != PCG_SHAPE
    f = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    return ConjugateGradient(prob, preconditioner=mg), f


def _relax(iterations=10, k=4, walls="dirichlet"):
    shape = (12, 10, 14)
    bc = DirichletBC(values=((0.0, 1.0), (0.5, 0.0), (0.0, 0.25)))
    if walls == "periodic":
        bc = bc.with_periodic((0, 1))
    grid = HaloGrid.from_interior(
        torch.rand(shape, generator=torch.Generator().manual_seed(3)),
        halo=1, bc=bc, device="cpu")
    st = TiledStencil(NAMED_SPECS["jacobi7"](), shape, sweeps_per_call=k,
                      device="cpu")
    return lambda: st.iterate(grid, iterations)


def _by_name(spans):
    return Counter(s.name for s in spans)


def test_off_a_span_is_the_shared_noop_and_records_nothing():
    tracing.drain()
    assert not tracing.enabled()
    assert tracing.span("runner.pad") is tracing.span("cg.solve") \
        is tracing.NO_SPAN
    with tracing.span("runner.pad"):
        pass
    _relax(iterations=4)()
    assert tracing.drain() == []


@pytest.mark.parametrize("path", ["relax", "pcg"])
def test_results_are_bitwise_the_same_on_and_off(path):
    def run():
        if path == "relax":
            return _relax()().data
        cg, f = _pcg((15, 15, 15))
        return cg.solve(f, tolerance=1e-5).grid.data

    off = run()
    tracing.enable()
    try:
        on = run()
    finally:
        tracing.disable()
        spans = tracing.drain()
    assert spans, "the traced run recorded no span"
    assert torch.equal(off, on)


@pytest.mark.parametrize("check_every", [1, 8])
def test_a_pcg_solve_records_its_iterations_and_levels(traced, check_every):
    cg, f = _pcg()
    syncs = tracing.counters().get("host_syncs", 0)
    result = cg.solve(f, tolerance=1e-5, check_every=check_every)
    spans = tracing.drain()
    assert result.converged and result.iterations > 0
    n = _by_name(spans)
    passes = check_every * math.ceil(result.iterations / check_every)
    assert n["cg.solve"] == n["cg.setup"] == n["cg.stats"] == 1
    assert n["cg.matvec"] == n["cg.precond"] == passes
    assert n["cg.update"] == 2 * passes
    # the last pass only reads the flag, and stops
    assert n["cg.iteration"] == passes + 1
    assert n["cg.check"] == passes // check_every + 1
    assert tracing.counters()["host_syncs"] - syncs == n["cg.check"] + 1
    cycles = passes + 1                 # the setup's and one per pass
    for span in ("mg.prep", "mg.fine.smooth_residual", "mg.fine.restrict",
                 "mg.fine.prolong", "mg.fine.post"):
        assert n[span] == cycles, span
    for level in range(1, PCG_LEVELS):
        assert n[f"mg.level{level}"] == cycles, level
    assert n["mg.coarsest"] == cycles
    assert n["mg.smooth"] == 2 * cycles * (PCG_LEVELS - 2)
    assert n["plan.make"] == PLANS_PER_SOLVE

    solve = next(s for s in spans if s.name == "cg.solve")
    parent = {"cg.setup": {"cg.solve"}, "cg.iteration": {"cg.solve"},
              "cg.stats": {"cg.solve"}, "cg.check": {"cg.iteration"},
              "cg.matvec": {"cg.iteration"}, "cg.update": {"cg.iteration"},
              "cg.precond": {"cg.iteration"},
              "mg.prep": {"cg.setup", "cg.precond"},
              "mg.fine.post": {"cg.setup", "cg.precond"},
              "mg.level1": {"cg.setup", "cg.precond"},
              "mg.level2": {"mg.level1"}, "mg.coarsest": {"mg.level2"},
              "mg.smooth": {"mg.level1"}, "plan.make": {"cg.setup"}}
    for s in spans:
        assert s.call == solve.call
        assert s.start_ns <= s.end_ns
        if s.name in parent:
            assert spans[s.parent].name in parent[s.name], s
    assert solve.parent == -1
    assert min(tracing.self_ns(spans)) >= 0


def test_counters_count_with_tracing_off():
    cg, f = _pcg()
    before = tracing.counters()
    result = cg.solve(f, tolerance=1e-5)
    after = tracing.counters()
    assert tracing.drain() == []
    checks = math.ceil(result.iterations / 8) + 1
    assert after["host_syncs"] - before.get("host_syncs", 0) == checks + 1
    assert after["plans_made"] - before.get("plans_made", 0) \
        == PLANS_PER_SOLVE


@pytest.mark.parametrize("iterations,k,walls", [
    (8, 4, "dirichlet"), (10, 4, "dirichlet"), (7, 2, "periodic")])
def test_the_runner_spans_each_launch(traced, iterations, k, walls):
    run = _relax(iterations, k, walls)
    assert _by_name(tracing.drain()) == {"plan.make": 1}
    run()
    spans = tracing.drain()
    n = _by_name(spans)
    launches = math.ceil(iterations / k)
    assert n["runner.launch"] == n["runner.refresh"] == launches
    for span in ("runner.iterate", "runner.pad", "runner.clone",
                 "runner.unpad", "runner.from_interior"):
        assert n[span] == 1, span
    (top,) = [i for i, s in enumerate(spans) if s.name == "runner.iterate"]
    assert all(s.parent == top for s in spans if s.name != "runner.iterate")
    assert min(tracing.self_ns(spans)) >= 0


def test_spans_nest_and_share_a_call_id(traced):
    with tracing.span("cg.solve"):
        with tracing.span("cg.setup"):
            pass
        with pytest.raises(RuntimeError, match="open"):
            tracing.drain()
    with tracing.span("runner.iterate"):
        pass
    spans = tracing.drain()
    assert [(s.name, s.parent) for s in spans] == [
        ("cg.solve", -1), ("cg.setup", 0), ("runner.iterate", -1)]
    assert spans[0].call == spans[1].call != spans[2].call
    rows = tracing.totals(spans)
    assert rows["cg.solve"]["count"] == 1
    assert rows["cg.solve"]["self_ns"] == \
        rows["cg.solve"]["ns"] - rows["cg.setup"]["ns"]


def test_profile_writes_the_runner_spans(tmp_path, capsys):
    argv = ["-s", "12", "10", "14", "-i", "8", "--spec", "jacobi7", "-m",
            "pallas_temporal", "-k", "4", "--device", "cpu", "--profile",
            str(tmp_path)]
    assert cli.main(argv) == 0
    assert not tracing.enabled()
    assert tracing.drain() == []
    trace = json.loads((tmp_path / "pallas_temporal.trace.json").read_text())
    names = Counter(e["name"] for e in trace["traceEvents"]
                    if e.get("cat") == "user_annotation")
    for span in ("runner.iterate", "runner.pad", "runner.clone",
                 "runner.refresh", "runner.launch", "runner.unpad",
                 "runner.from_interior"):
        assert names[span] > 0, (span, names)
    assert names["runner.launch"] == names["runner.refresh"] \
        >= 2 * names["runner.iterate"]
