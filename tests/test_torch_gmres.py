"""The port's restarted GMRES (stencil_tpu_torch/krylov.py:GMRES) against
the JAX package's (stencil_tpu/krylov.py:GMRES), the cases of
tests/test_gmres.py on the CPU: the dense float64 solve of both schemes,
restart cycles, nonzero walls, the symmetric case against CG, the
OperatorMultigrid right preconditioner (constant-tap and field operators),
warm starts, the eigenvector right-hand side, the budget-0 certificate,
the stall guard, the basis budget and the gates; and JAX's distributed
case on the port's mesh (tests/test_torch_distributed_krylov.py holds the
rest of the distributed solves).

Tolerances: JAX's Arnoldi-step count exactly (the port runs the same
steps; only the dot products and matrix products sum in another order,
and GMRES's residual estimate is monotone, so a step count follows it),
the same ``converged``; the solution within the JAX tests' bars (2e-4 of
the dense solution's scale, 1e-3 of a manufactured one, 1e-3 relative
between solvers) and within 1e-4 of JAX's (relative to its scale; 1e-3
at 1e-6, near the fp32 floor); the certificate within 50% of JAX's
(rounding-dominated in its last digits at these tolerances)."""

import numpy as np
import pytest

from stencil_tpu.krylov import GMRES as JGMRES
from stencil_tpu.models import diffusion as jdiff
from stencil_tpu.models.advection_diffusion import (
    AdvectionDiffusionProblem as JAdvDiff,
)
from stencil_tpu.models.poisson import PoissonProblem as JPoisson
from stencil_tpu.models.poisson import manufactured_sine
from stencil_tpu.multigrid import OperatorMultigrid as JOpMG
from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu_torch import convert
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.krylov import GMRES, ConjugateGradient
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.multigrid import OperatorMultigrid

from test_bicgstab import dense_operator

CHEAP = dict(nu1=1, nu2=1, coarse_sweeps=8)


def problems(shape, velocity, nu=1.0, scheme="upwind", bc=None):
    jp = JAdvDiff(shape=shape, velocity=velocity, nu=nu, scheme=scheme,
                  bc=bc)
    tp = convert.advdiff_from_arrays(jp.shape, jp.velocity, jp.nu, jp.h,
                                     jp.bc.values, jp.dtype, jp.scheme,
                                     device="cpu")
    return jp, tp


def interior(res) -> np.ndarray:
    return res.grid.interior().double().cpu().numpy()


def assert_like_jax(got, want, rel=1e-4):
    assert got.iterations == want.iterations, (got.summary(),
                                               want.summary())
    assert got.converged == want.converged
    uj = np.asarray(want.grid.interior(), np.float64)
    assert np.max(np.abs(interior(got) - uj)) <= rel * np.max(np.abs(uj))
    np.testing.assert_allclose(got.residual_rel, want.residual_rel,
                               rtol=0.5)


def both(jp, tp, f, jkw=None, tkw=None, **solve_kw):
    want = JGMRES(jp, **(jkw or {})).solve(f, **solve_kw)
    got = GMRES(tp, **(tkw or {})).solve(f, **solve_kw)
    return got, want


@pytest.mark.parametrize("scheme", ["upwind", "central"])
def test_matches_dense_solve_3d(scheme):
    shape = (5, 6, 7)
    jp, tp = problems(shape, (1.0, -0.5, 0.25), scheme=scheme)
    f = np.random.default_rng(3).normal(size=shape)
    u_dense = np.linalg.solve(dense_operator(tp),
                              f.ravel()).reshape(shape)
    got, want = both(jp, tp, f.astype(np.float32), tolerance=1e-6,
                     max_iterations=500)
    assert got.converged, got.summary()
    assert np.max(np.abs(interior(got) - u_dense)) < \
        2e-4 * np.max(np.abs(u_dense))
    assert_like_jax(got, want, rel=1e-3)


def test_restart_cycles_converge_where_one_subspace_cannot():
    shape = (9, 8)
    jp, tp = problems(shape, (4.0, -3.0), nu=0.5)
    f = np.random.default_rng(4).normal(size=shape)
    u_dense = np.linalg.solve(dense_operator(tp),
                              f.ravel()).reshape(shape)
    got, want = both(jp, tp, f.astype(np.float32), {"restart": 5},
                     {"restart": 5}, tolerance=1e-6, max_iterations=500)
    assert got.converged and got.iterations > 5, got.summary()
    assert np.max(np.abs(interior(got) - u_dense)) < \
        2e-4 * np.max(np.abs(u_dense))
    assert_like_jax(got, want, rel=1e-3)


def test_recovers_manufactured_solution_through_walls():
    shape = (10, 11, 12)
    jp, tp = problems(shape, (0.8, -0.6, 0.4),
                      bc=JBC.reference_default(3))
    u_star = np.random.default_rng(5).normal(size=shape)
    f = tp.apply_f64(u_star)
    got, want = both(jp, tp, f.astype(np.float32), tolerance=1e-6,
                     max_iterations=500)
    assert got.converged, got.summary()
    assert np.max(np.abs(interior(got) - u_star)) < 1e-3
    assert tp.residual_f64(got.grid, f) < 1e-2 * np.max(np.abs(f))
    assert_like_jax(got, want, rel=1e-3)


def test_symmetric_case_matches_cg():
    shape = (15, 15, 15)
    jp = JPoisson(shape=shape)
    tp = convert.poisson_from_arrays(jp.shape, jp.h, jp.bc.values,
                                     device="cpu")
    f = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    cg = ConjugateGradient(tp).solve(f, tolerance=1e-5,
                                     max_iterations=2000)
    got, want = both(jp, tp, f, {"restart": 32}, {"restart": 32},
                     tolerance=1e-5, max_iterations=2000)
    assert cg.converged and got.converged
    scale = np.max(np.abs(interior(cg)))
    assert np.max(np.abs(interior(cg) - interior(got))) < 1e-3 * scale
    assert_like_jax(got, want)


def test_operator_mg_preconditioning_collapses_iterations():
    """The rediscretized cycle (a cheap one: one smoothing sweep, 8
    coarse sweeps; GMRES(4), whose JAX cycle compiles once) as right
    preconditioner at 15^3, nu 0.05: JAX's steps and solution, at least
    3x fewer steps than the plain solve (4x at JAX's 31^3 and full
    cycle), the same discrete solution."""
    shape = (15, 15, 15)
    jp, tp = problems(shape, (1.0, -0.5, 0.25), nu=0.05)
    f = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    got, want = both(jp, tp, f, {"preconditioner": JOpMG(jp, **CHEAP),
                                 "restart": 4},
                     {"preconditioner": OperatorMultigrid(tp, **CHEAP),
                      "restart": 4},
                     tolerance=1e-5, max_iterations=2000)
    plain = GMRES(tp, restart=64).solve(f, tolerance=1e-5,
                                        max_iterations=2000)
    assert got.converged and plain.converged
    assert got.iterations * 3 <= plain.iterations, (got.iterations,
                                                    plain.iterations)
    scale = np.max(np.abs(interior(plain)))
    assert np.max(np.abs(interior(plain) - interior(got))) < 1e-3 * scale
    assert_like_jax(got, want)


@pytest.mark.parametrize("precond", [False, True])
def test_field_operator_heterogeneous_poisson(precond):
    """The field operator protocol (the hetero problem's weight fields),
    with and without the coefficient-coarsened cycle, against its dense
    float64 twin and JAX."""
    from test_hetero_poisson import dense_operator as dense_field_op

    shape = (9, 9, 9)
    rng = np.random.default_rng(9)
    a = np.where(rng.uniform(size=shape) > 0.5, 10.0, 0.1)
    jp = jdiff.HeterogeneousPoissonProblem(shape=shape, a=a)
    tp = convert.hetero_from_arrays(shape, a, jp.h, jp.bc.values,
                                    device="cpu")
    f = rng.normal(size=shape)
    u_dense = np.linalg.solve(dense_field_op(jp),
                              f.ravel()).reshape(shape)
    if precond:
        kw = ({"preconditioner": JOpMG(jp, **CHEAP), "restart": 4},
              {"preconditioner": OperatorMultigrid(tp, **CHEAP),
               "restart": 4})
    else:  # GMRES(32), 64 in JAX's test: one stage fewer to compile
        kw = ({"restart": 32}, {"restart": 32})
    got, want = both(jp, tp, f.astype(np.float32), *kw, tolerance=1e-6,
                     max_iterations=2000)
    assert got.converged, got.summary()
    assert np.max(np.abs(interior(got) - u_dense)) < \
        5e-4 * np.max(np.abs(u_dense))
    assert_like_jax(got, want, rel=1e-3)


def test_warm_start():
    shape = (12, 13)
    jp, tp = problems(shape, (0.5, -0.25))
    f = np.random.default_rng(10).normal(size=shape).astype(np.float32)
    s = GMRES(tp, restart=8)
    cold = s.solve(f, tolerance=1e-2, max_iterations=300)
    warm = s.solve(f, tolerance=1e-3, max_iterations=300,
                   initial=cold.grid)
    assert warm.converged
    assert warm.residual <= 1.1e-3 * cold.residual
    js = JGMRES(jp, restart=8)
    jcold = js.solve(f, tolerance=1e-2, max_iterations=300)
    jwarm = js.solve(f, tolerance=1e-3, max_iterations=300,
                     initial=jcold.grid)
    assert (cold.iterations, warm.iterations) == (jcold.iterations,
                                                  jwarm.iterations)


def test_eigenvector_rhs_resolves_in_few_steps():
    """The manufactured sine, one eigenvector of the Laplacian, at 31^3
    (63^3 in JAX's test) with GMRES(8): resolved within 8 steps (the
    near-breakdown exit, the masked back substitution at a tiny step
    count), JAX's count; and a tolerance below the fp32 floor stops on the
    stall guard within 64 steps, as JAX's does."""
    shape = (31, 31, 31)
    jp = JPoisson(shape=shape)
    tp = PoissonProblem(shape=shape, device="cpu")
    f, u = manufactured_sine(shape)
    got, want = both(jp, tp, f, {"restart": 8}, {"restart": 8},
                     tolerance=1e-4, max_iterations=1000)
    assert got.converged and got.iterations <= 8, got.summary()
    assert_like_jax(got, want)
    err = np.max(np.abs(interior(got) - u))
    assert err < 1.2 * (1.0 / 32) ** 2, err
    floor = GMRES(tp, restart=8).solve(f, tolerance=1e-7,
                                       max_iterations=1000)
    jfloor = JGMRES(jp, restart=8).solve(f, tolerance=1e-7,
                                         max_iterations=1000)
    assert not floor.converged and floor.iterations <= 64, floor.summary()
    assert not jfloor.converged


def test_budget_zero_returns_honest_certificate():
    shape = (9, 10)
    jp, tp = problems(shape, (0.5, -0.25))
    f = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    s = GMRES(tp)
    cold = s.solve(f, tolerance=1e-5, max_iterations=0)
    jcold = JGMRES(jp).solve(f, tolerance=1e-5, max_iterations=0)
    assert cold.iterations == 0 and not cold.converged
    assert abs(cold.residual - float(np.linalg.norm(f))) \
        <= 1e-4 * cold.residual
    np.testing.assert_allclose(cold.residual, jcold.residual, rtol=1e-5)
    solved = s.solve(f, tolerance=1e-4, max_iterations=500)
    assert solved.converged
    warm = s.solve(f, tolerance=1e-2, max_iterations=0,
                   initial=solved.grid)
    assert warm.iterations == 0, warm.summary()
    assert warm.residual <= 1.01 * solved.residual


def test_stall_ratio_none_spends_budget():
    shape = (15, 15)
    jp = JPoisson(shape=shape)
    tp = PoissonProblem(shape=shape, device="cpu")
    f = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    kw = dict(tolerance=1e-12, max_iterations=64)
    guarded, jguarded = both(jp, tp, f, {"restart": 4}, {"restart": 4},
                             stall_ratio=0.5, **kw)
    free = GMRES(tp, restart=4).solve(f, stall_ratio=None, **kw)
    assert not guarded.converged and not free.converged
    assert guarded.iterations < 64 and free.iterations == 64
    assert guarded.iterations == jguarded.iterations
    assert free.residual_rel <= guarded.residual_rel * 1.5


def test_oversized_restart_fails_eagerly(monkeypatch):
    """The basis past half of the device's memory (STENCIL_TPU_HBM_MB, as
    JAX reads it) refuses before allocation, with JAX's message."""
    monkeypatch.setenv("STENCIL_TPU_HBM_MB", "1")
    f = np.zeros((63, 63, 63), np.float32)
    with pytest.raises(ValueError) as want:
        JGMRES(JPoisson(shape=(63, 63, 63)), restart=16).solve(f)
    with pytest.raises(ValueError, match="Reduce restart") as got:
        GMRES(PoissonProblem(shape=(63, 63, 63), device="cpu"),
              restart=16).solve(f)
    assert str(got.value) == str(want.value)


def test_gates_match_jax():
    jp, tp = problems((8, 8), (0.5, 0.5))
    _, other = problems((9, 9), (0.5, 0.5))
    jother = JAdvDiff(shape=(9, 9), velocity=(0.5, 0.5))
    cases = [
        (lambda: JGMRES(jp, restart=0), lambda: GMRES(tp, restart=0)),
        (lambda: JGMRES(jp, preconditioner=JOpMG(jother)),
         lambda: GMRES(tp, preconditioner=OperatorMultigrid(other))),
        (lambda: JGMRES(JPoisson(shape=(8, 8),
                                 bc=JBC.zero(2).with_periodic((0,)))),
         lambda: GMRES(PoissonProblem(
             shape=(8, 8), bc=DirichletBC.zero(2).with_periodic((0,)),
             device="cpu"))),
    ]
    for jcall, tcall in cases:
        with pytest.raises(ValueError) as want:
            jcall()
        with pytest.raises(ValueError) as got:
            tcall()
        assert str(got.value) == str(want.value)


def test_distributed_solve_is_not_ported():
    """JAX's distributed case (tests/test_gmres.py:164), once refused, now
    runs on the port's mesh of 4 ranks: converged, within JAX's bar (1e-4
    of the solution's scale) of the one-device solve."""
    from stencil_tpu_torch.parallel.mesh import make_mesh

    _, tp = problems((17, 16), (1.0, -0.5))
    f = np.random.default_rng(11).normal(size=(17, 16)).astype(np.float32)
    one = GMRES(tp).solve(f, tolerance=1e-6, max_iterations=500)
    dist = GMRES(tp).solve(f, tolerance=1e-6, max_iterations=500,
                           mesh=make_mesh((4,), ("x",), device="cpu"))
    assert one.converged and dist.converged
    scale = float(np.max(np.abs(interior(one))))
    assert float(np.max(np.abs(interior(one) - interior(dist)))) \
        < 1e-4 * scale
