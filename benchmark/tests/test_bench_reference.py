"""The plain reference against the port's own plain versions at small
sizes. The reference imports nothing of the port; this test imports
both."""

import numpy as np
import pytest
import torch

from benchmark import reference


@pytest.mark.parametrize("steps", [1, 3, 8])
def test_jacobi_steps_match_the_port(steps):
    from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
    from stencil_tpu_torch.core.spec import NAMED_SPECS
    from stencil_tpu_torch.ops import eager

    rng = np.random.default_rng(steps)
    x = torch.from_numpy(rng.random((9, 7, 11))).to(torch.float64)
    walls = ((0.25, 0.5), (0.75, 0.125), (1.0, 0.375))
    grid = HaloGrid.from_interior(x, halo=1, bc=DirichletBC(values=walls),
                                  device="cpu")
    spec = NAMED_SPECS["jacobi7"]()
    want = eager.iterate(grid, spec, steps).interior()
    got = reference.jacobi_steps(x, walls, steps, 1.0 / 6.0)
    assert torch.allclose(got, want, rtol=0, atol=1e-13)


def test_jacobi_steps_through_the_tiled_plain_version():
    from stencil_tpu_torch.config import RunConfig
    from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
    from stencil_tpu_torch.core.spec import NAMED_SPECS
    from stencil_tpu_torch.registry import get_runner

    x = torch.from_numpy(np.random.default_rng(0).random(
        (12, 10, 14))).to(torch.float32)
    walls = ((0.5, 0.25), (0.0, 1.0), (0.75, 0.5))
    grid = HaloGrid.from_interior(x, halo=1, bc=DirichletBC(values=walls),
                                  device="cpu")
    config = RunConfig(size=(12, 10, 14), spec="jacobi7",
                       methods=("pallas_temporal",), temporal=4,
                       device="cpu")
    runner = get_runner("pallas_temporal", config, NAMED_SPECS["jacobi7"](),
                        grid)
    out = runner.iterate(grid, 16).interior()
    want = reference.jacobi_steps(x, walls, 16, float(np.float32(1 / 6)))
    assert reference.max_rel_error(out, want) < 1e-6


def test_residual_matches_the_port_operator():
    from stencil_tpu_torch.models.poisson import PoissonProblem

    shape = (9, 8, 10)
    prob = PoissonProblem(shape=shape, device="cpu")
    rng = np.random.default_rng(1)
    u = rng.normal(size=shape)
    f = rng.normal(size=shape)
    r = f - prob.apply_f64(u)
    want = np.linalg.norm(r) / np.linalg.norm(f)
    got = reference.poisson_residual_rel(torch.from_numpy(u),
                                         torch.from_numpy(f), prob.h,
                                         block=3)
    assert got == pytest.approx(want, rel=1e-12)


def test_residual_of_an_exact_solution_is_zero():
    shape = (6, 5, 7)
    u = torch.from_numpy(np.random.default_rng(2).normal(size=shape))
    h = 0.125
    # f = L u, computed here directly from the definition
    p = torch.nn.functional.pad(u, (1, 1, 1, 1, 1, 1))
    nb = (p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1] + p[1:-1, :-2, 1:-1]
          + p[1:-1, 2:, 1:-1] + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:])
    f = (nb - 6 * u) / h ** 2
    assert reference.poisson_residual_rel(u, f, h, block=2) < 1e-14


def test_max_rel_error():
    a = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    b = a.clone()
    b[1, 0] += 0.04
    assert reference.max_rel_error(b, a, block=1) == pytest.approx(0.01)
