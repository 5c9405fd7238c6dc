"""The steady advection-diffusion problem
(stencil_tpu_torch/models/advection_diffusion.py) and the port's BiCGStab
on it against the JAX package's, the cases of tests/test_bicgstab.py: the
taps, the operator, the dense float64 solve, the manufactured solution
through nonzero walls, the advection-dominated upwind solve, the
iteration cap, the gates, OperatorMultigrid's coarse levels (the central
scheme falling back to upwind) and its gates, the preconditioned solve.

Tolerances: the taps and the operator's weights equal to JAX's (the same
float64 arithmetic); the operator on a random ghost ring within fp32
rounding, 1e-6 of its largest entry. A solve at a tolerance above the
fp32 floor (1e-4, 1e-5): the same ``converged``, JAX's iteration count
within 1 (BiCGStab's short recurrence amplifies the order in which the
dot products sum, as in tests/test_torch_hetero.py; GMRES, in
tests/test_torch_gmres.py, gives JAX's count exactly), the solution within
10x the tolerance of JAX's (relative to its scale), the certificate
within 50% of JAX's (the last iteration's drop is erratic). At 1e-6, the
JAX tests' own tolerance, the certificate is rounding near the fp32 floor
and the drift-recovery restarts follow it, so there the port is held to
the JAX test's bars (the dense solve within 2e-4 of its scale, the
manufactured solution within 1e-3), both solves converged, and JAX's
iteration count within 15%."""

import numpy as np
import pytest
import torch

from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.krylov import BiCGStab as JBiCGStab
from stencil_tpu.models.advection_diffusion import (
    AdvectionDiffusionProblem as JAdvDiff,
)
from stencil_tpu.multigrid import OperatorMultigrid as JOpMG
from stencil_tpu_torch import convert
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.krylov import BiCGStab
from stencil_tpu_torch.models.advection_diffusion import (
    AdvectionDiffusionProblem,
)
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.multigrid import OperatorMultigrid

from test_bicgstab import dense_operator


def problems(shape, velocity, nu=1.0, scheme="upwind", bc=None):
    jp = JAdvDiff(shape=shape, velocity=velocity, nu=nu, scheme=scheme,
                  bc=bc)
    tp = convert.advdiff_from_arrays(jp.shape, jp.velocity, jp.nu, jp.h,
                                     jp.bc.values, jp.dtype, jp.scheme,
                                     device="cpu")
    return jp, tp


def interior(res) -> np.ndarray:
    return res.grid.interior().double().cpu().numpy()


def assert_like_jax(got, want, tol, floor=False):
    """``floor``: a solve at the fp32 floor (see the module docstring)."""
    assert got.converged == want.converged, (got.summary(), want.summary())
    slack = max(1, 0.15 * want.iterations) if floor else 1
    assert abs(got.iterations - want.iterations) <= slack, (
        got.summary(), want.summary())
    if floor:
        return
    uj = np.asarray(want.grid.interior(), np.float64)
    scale = np.max(np.abs(uj))
    assert np.max(np.abs(interior(got) - uj)) <= 10 * tol * scale
    np.testing.assert_allclose(got.residual_rel, want.residual_rel,
                               rtol=0.5)


@pytest.mark.parametrize("shape,velocity,scheme,h", [
    ((7, 7), (2.0, -1.0), "upwind", 0.5),
    ((5, 6, 7), (1.0, -0.5, 0.25), "central", None),
    ((5, 6, 7), (1.0, 0.0, -0.25), "upwind", None)])
def test_taps_equal_jax(shape, velocity, scheme, h):
    """The same taps in the same order, weight for weight (and the upwind
    weights of tests/test_bicgstab.py:178)."""
    jp = JAdvDiff(shape=shape, velocity=velocity, scheme=scheme, h=h)
    tp = AdvectionDiffusionProblem(shape=shape, velocity=velocity,
                                   scheme=scheme, h=h, device="cpu")
    js, ts = jp.operator_spec, tp.operator_spec
    assert ts.offsets == js.offsets and ts.name == js.name
    assert ts.weights == tuple(float(w) for w in js.weights)
    assert tp.operator_inv_diagonal() == jp.operator_inv_diagonal()
    assert tp.mesh_peclet == jp.mesh_peclet
    assert tp.is_symmetric == jp.is_symmetric is False
    if h == 0.5:
        taps = dict(zip(ts.offsets, ts.weights))
        assert taps[(0, 0)] == pytest.approx(4 * 4.0 + 3.0 / 0.5)
        assert taps[(-1, 0)] == pytest.approx(-4.0 - 2.0 / 0.5)
        assert taps[(1, 0)] == pytest.approx(-4.0)
        assert taps[(0, 1)] == pytest.approx(-4.0 - 1.0 / 0.5)


@pytest.mark.parametrize("scheme", ["upwind", "central"])
def test_operator_apply_matches_jax(rng, scheme):
    """On a halo-1 input with a random ghost ring, and the float64 twin
    through nonzero walls."""
    bc = JBC.reference_default(3)
    jp, tp = problems((6, 7, 8), (1.0, -0.5, 0.25), scheme=scheme, bc=bc)
    x = rng.normal(size=(8, 9, 10)).astype(np.float32)
    want = np.asarray(jp.operator_apply(x))
    got = tp.operator_apply(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.max(np.abs(want)))
    u = rng.normal(size=(6, 7, 8))
    np.testing.assert_array_equal(tp.apply_f64(u), jp.apply_f64(u))


@pytest.mark.parametrize("scheme", ["upwind", "central"])
def test_matches_dense_solve_3d(scheme):
    shape = (5, 6, 7)
    jp, tp = problems(shape, (1.0, -0.5, 0.25), scheme=scheme)
    f = np.random.default_rng(3).normal(size=shape)
    u_dense = np.linalg.solve(dense_operator(tp),
                              f.ravel()).reshape(shape)
    got = BiCGStab(tp).solve(f.astype(np.float32), tolerance=1e-6,
                             max_iterations=500)
    want = JBiCGStab(jp).solve(f.astype(np.float32), tolerance=1e-6,
                               max_iterations=500)
    assert got.converged, got.summary()
    assert np.max(np.abs(interior(got) - u_dense)) < \
        2e-4 * np.max(np.abs(u_dense))
    assert_like_jax(got, want, 1e-6, floor=True)


def test_dense_solve_2d_high_velocity_upwind():
    shape = (9, 8)
    jp, tp = problems(shape, (4.0, -3.0), nu=0.5)
    f = np.random.default_rng(4).normal(size=shape)
    u_dense = np.linalg.solve(dense_operator(tp),
                              f.ravel()).reshape(shape)
    got = BiCGStab(tp).solve(f.astype(np.float32), tolerance=1e-6,
                             max_iterations=500)
    want = JBiCGStab(jp).solve(f.astype(np.float32), tolerance=1e-6,
                               max_iterations=500)
    assert got.converged, got.summary()
    assert np.max(np.abs(interior(got) - u_dense)) < \
        2e-4 * np.max(np.abs(u_dense))
    assert_like_jax(got, want, 1e-6, floor=True)


def test_recovers_manufactured_solution_through_walls():
    shape = (10, 11, 12)
    jp, tp = problems(shape, (0.8, -0.6, 0.4),
                      bc=JBC.reference_default(3))
    u_star = np.random.default_rng(5).normal(size=shape)
    f = tp.apply_f64(u_star)
    got = BiCGStab(tp).solve(f.astype(np.float32), tolerance=1e-6,
                             max_iterations=500)
    want = JBiCGStab(jp).solve(f.astype(np.float32), tolerance=1e-6,
                               max_iterations=500)
    assert got.converged, got.summary()
    assert np.max(np.abs(interior(got) - u_star)) < 1e-3
    assert tp.residual_f64(got.grid, f) < 1e-2 * np.max(np.abs(f))
    assert_like_jax(got, want, 1e-6, floor=True)


def test_advection_dominated_upwind():
    """Mesh Peclet ~1.6: the central scheme refuses, the upwind solves."""
    shape = (31, 31)
    jp, tp = problems(shape, (1.0, 1.0), nu=0.01)
    assert tp.mesh_peclet > 1.0
    with pytest.raises(ValueError, match="Peclet"):
        AdvectionDiffusionProblem(shape=shape, velocity=(1.0, 1.0),
                                  nu=0.01, scheme="central", device="cpu")
    f = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    got = tp.solve(f, tolerance=1e-5, max_iterations=2000)
    want = jp.solve(f, tolerance=1e-5, max_iterations=2000)
    assert got.converged, got.summary()
    assert tp.residual_f64(got.grid, f) < 1e-2 * np.max(np.abs(f))
    assert_like_jax(got, want, 1e-5)


@pytest.mark.parametrize("shape,velocity,nu,scheme,tol", [
    ((5, 6, 7), (1.0, -0.5, 0.25), 1.0, "central", 1e-4),
    ((9, 8), (4.0, -3.0), 0.5, "upwind", 1e-4),
    ((10, 11, 12), (0.8, -0.6, 0.4), 1.0, "upwind", 1e-5),
    ((31, 31), (1.0, 1.0), 0.01, "upwind", 1e-4)])
def test_solves_match_jax_above_the_floor(shape, velocity, nu, scheme,
                                              tol):
    jp, tp = problems(shape, velocity, nu=nu, scheme=scheme,
                      bc=JBC.reference_default(len(shape)))
    f = np.random.default_rng(11).normal(size=shape).astype(np.float32)
    got = BiCGStab(tp).solve(f, tolerance=tol, max_iterations=2000)
    want = JBiCGStab(jp).solve(f, tolerance=tol, max_iterations=2000)
    assert got.converged, got.summary()
    assert_like_jax(got, want, tol)


def test_iteration_cap_reports_not_converged():
    shape = (15, 15)
    jp, tp = problems(shape, (1.0, 0.0))
    f = np.ones(shape, np.float32)
    got = BiCGStab(tp).solve(f, tolerance=1e-10, max_iterations=2)
    want = JBiCGStab(jp).solve(f, tolerance=1e-10, max_iterations=2)
    assert not got.converged and got.iterations == 2
    assert got.residual_rel > 1e-10
    np.testing.assert_allclose(got.residual_rel, want.residual_rel,
                               rtol=1e-3)


def gate_cases(mod, bc_cls, device):
    kw = {} if device is None else {"device": device}
    return [
        lambda: mod(shape=(8, 8), velocity=(1.0, 0.0), nu=0.0, **kw),
        lambda: mod(shape=(8, 8), velocity=(1.0,), **kw),
        lambda: mod(shape=(8, 8), velocity=(1.0, 0.0),
                    bc=bc_cls.zero(2).with_periodic((0,)), **kw),
        lambda: mod(shape=(8, 8), velocity=(1.0, 0.0),
                    bc=bc_cls.zero(2).with_neumann((1,)), **kw),
        lambda: mod(shape=(8, 8), velocity=(1.0, 0.0), scheme="quick",
                    **kw),
        lambda: mod(shape=(31, 31), velocity=(1.0, 1.0), nu=0.01,
                    scheme="central", **kw),
    ]


def test_gates_match_jax():
    """Each refusal with JAX's message; BiCGStab refuses a singular
    problem; the distributed solve refuses a dim out of range."""
    for jcall, tcall in zip(gate_cases(JAdvDiff, JBC, None),
                            gate_cases(AdvectionDiffusionProblem,
                                       DirichletBC, "cpu")):
        with pytest.raises(ValueError) as want:
            jcall()
        with pytest.raises(ValueError) as got:
            tcall()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="singular"):
        BiCGStab(PoissonProblem(
            shape=(8, 8), bc=DirichletBC.zero(2).with_neumann((1,)),
            device="cpu"))
    from stencil_tpu_torch.parallel.mesh import make_mesh

    _, tp = problems((8, 8, 8), (1.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="out of range"):
        BiCGStab(tp).solve(np.ones((8, 8, 8), np.float32),
                           mesh=make_mesh((2, 2), device="cpu"), dim=2)


def test_central_falls_back_to_upwind_on_coarse_levels():
    """OperatorMultigrid's levels: the central fine level keeps its
    scheme, coarse levels past Peclet 1 take upwind, level for level as
    JAX's, every tap weight equal."""
    jp, tp = problems((31, 31, 31), (1.0, 0.0, 0.0), nu=0.05,
                      scheme="central")
    assert tp.mesh_peclet <= 1.0
    jmg, tmg = JOpMG(jp), OperatorMultigrid(tp)
    names = [p.operator_spec.name for p in tmg._probs]
    assert names == [p.operator_spec.name for p in jmg._probs]
    assert "central" in names[0]
    assert any("upwind" in n for n in names[1:]), names
    for j, t in zip(jmg._probs, tmg._probs):
        assert t.shape == j.shape and t.h == j.h and t.bc == DirichletBC \
            .zero(3)
        assert t.operator_spec.weights == tuple(
            float(w) for w in j.operator_spec.weights)


def test_operator_mg_gates():
    _, tp = problems((15, 15, 15), (1.0, 0.0, 0.0))
    _, other = problems((13, 13, 13), (1.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="different problem"):
        BiCGStab(tp, preconditioner=OperatorMultigrid(other))
    with pytest.raises(ValueError, match="gamma"):
        OperatorMultigrid(tp, gamma=3)


@pytest.mark.parametrize("scheme", ["upwind", "central"])
def test_preconditioned_solve_matches_jax(scheme):
    """BiCGStab + OperatorMultigrid (a cheap cycle: one smoothing sweep,
    8 coarse sweeps) at 15^3, nu 0.05: JAX's iterations and solution, and
    far fewer iterations than the plain solve."""
    shape = (15, 15, 15)
    jp, tp = problems(shape, (1.0, -0.5, 0.25), nu=0.05, scheme=scheme)
    f = np.random.default_rng(31).normal(size=shape).astype(np.float32)
    kw = dict(nu1=1, nu2=1, coarse_sweeps=8)
    got = BiCGStab(tp, preconditioner=OperatorMultigrid(tp, **kw)).solve(
        f, tolerance=1e-5, max_iterations=200)
    want = JBiCGStab(jp, preconditioner=JOpMG(jp, **kw)).solve(
        f, tolerance=1e-5, max_iterations=200)
    plain = BiCGStab(tp).solve(f, tolerance=1e-5, max_iterations=2000)
    assert got.converged and plain.converged
    assert got.iterations * 3 <= plain.iterations, (got.iterations,
                                                    plain.iterations)
    assert_like_jax(got, want, 1e-5)
