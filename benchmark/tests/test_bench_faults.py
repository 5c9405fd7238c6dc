"""A run with the timed path broken underneath comes out not correct.

Each cell runs whole on the CPU at a small size (the kernels' plain
versions), past the harness's look for a card: set-up, the window, the
checks and the result line. Every fault the cell can have is planted in
the program's entry: a step that returns its state unchanged, half of the
grid left out of the update, one answer altered where it is produced. One
card holds every cell, so no exchange between cards can be left out.
"""

import time

import pytest
import torch

from benchmark import harness

SMALL = {"jacobi7_512.long": [12, 10, 14], "jacobi7_512.step": [12, 10, 14],
         "poisson_511.pcg": [15, 15, 15]}
RELAX = ("jacobi7_512.long", "jacobi7_512.step")


def run_small(name, seed=2 ** 31 + 77, seconds=0.3):
    cell = harness.find_cell(name).with_config(interior=SMALL[name])
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                          device=torch.device("cpu"),
                          t_origin=time.perf_counter())
    record = harness.load_driver(cell).run(ctx)
    return harness.result_line(cell, record, False, {"platform": "cpu"})


def _half(t):
    return t[: t.shape[0] // 2]


def relax_fault(kind):
    from stencil_tpu_torch.core.grid import HaloGrid
    from stencil_tpu_torch.ops.sweep_kernel import KernelStencil

    sound = KernelStencil.iterate

    def iterate(self, grid, iterations):
        if kind == "unchanged":
            return HaloGrid(data=grid.data.clone(), halo=grid.halo,
                            bc=grid.bc)
        out = sound(self, grid, iterations)
        if kind == "half":
            _half(out.interior()).copy_(_half(grid.interior()))
        elif kind == "altered":
            c = tuple(n // 2 for n in out.interior_shape)
            out.interior()[c] += 1e-3 * (1 + abs(float(out.interior()[c])))
        return out

    return KernelStencil, iterate


def solve_fault(kind):
    from stencil_tpu_torch.krylov import CGResult, ConjugateGradient

    sound = ConjugateGradient.solve

    def solve(self, f, *args, **kwargs):
        if kind == "unchanged":
            # the state it started from, reported as converged
            return CGResult(grid=self.problem.initial_grid(), iterations=1,
                            residual=0.0, residual_rel=0.0, converged=True)
        res = sound(self, f, *args, **kwargs)
        u = res.grid.interior()
        if kind == "half":
            _half(u).zero_()
        elif kind == "altered":
            c = tuple(n // 2 for n in u.shape)
            u[c] += 1e-3 * (1 + abs(float(u[c])))
        return res

    return ConjugateGradient, solve


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sound_run_is_correct(name):
    result = run_small(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_fault_is_not_correct(name, kind, monkeypatch):
    owner, broken = (relax_fault if name in RELAX else solve_fault)(kind)
    monkeypatch.setattr(owner, broken.__name__, broken)
    result = run_small(name)
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1


def test_a_wrong_grid_spacing_is_not_correct(monkeypatch):
    """The residual takes its spacing from the configuration's domain, not
    from the program: a program that solves on another spacing is caught."""
    from stencil_tpu_torch.models.poisson import PoissonProblem

    sound = PoissonProblem.__post_init__

    def post_init(self):
        object.__setattr__(self, "h", 1.0 / self.shape[0])
        sound(self)

    monkeypatch.setattr(PoissonProblem, "__post_init__", post_init)
    result = run_small("poisson_511.pcg")
    assert not result["correct"], result["checks"]
    assert result["failed"] >= 1
