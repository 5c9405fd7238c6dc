"""The port's conjugate gradients (stencil_tpu_torch/krylov.py) against the
JAX package's (stencil_tpu/krylov.py) on the CPU: plain CG and PCG with the
eager and the tiled-fine multigrid cycle (the kernel's plain version on the
CPU), nonzero walls, warm starts, the bf16 preconditioning cycle, the
gates, and the host check every ``check_every`` iterations changing
nothing.

Tolerances: the same iteration count as JAX (the port computes the same
operations in the same order; only the dot products sum in another order);
the relative residual within rtol 1e-3 (the residual of a converged fp32
solve is rounding-dominated in its last digits); the solution within 1e-6
absolute on values of order 1e-2 to 1 (measured ~1e-9)."""

import dataclasses

import numpy as np
import pytest
import torch

from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.krylov import ConjugateGradient as JCG
from stencil_tpu.models.poisson import PoissonProblem as JPoisson
from stencil_tpu.models.poisson import manufactured_sine
from stencil_tpu.multigrid import Multigrid as JMG
from stencil_tpu_torch import convert
from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
from stencil_tpu_torch.krylov import (
    BiCGStab, CGResult, ConjugateGradient as TCG, GMRES, _initial_or,
)
from stencil_tpu_torch.multigrid import Multigrid as TMG

TOL = 1e-6


def _problems(shape, bc=None):
    jp = JPoisson(shape=shape, bc=bc)
    tp = convert.poisson_from_arrays(jp.shape, jp.h, jp.bc.values,
                                     device="cpu")
    return jp, tp


def _pair(jp, tp, precond, **kw):
    """The same solver in both packages: precond None, 'mg' (eager/XLA
    fine level) or 'tiled' (the tiled fine level; JAX's XLA fine level,
    which the kernel path matches up to reassociation)."""
    if precond is None:
        return JCG(jp), TCG(tp)
    fine = "pallas_tiled" if precond == "tiled" else "xla"
    return (JCG(jp, preconditioner=JMG(jp, **kw)),
            TCG(tp, preconditioner=TMG(tp, fine_method=fine, **kw)))


def _assert_same(got, want, tol=TOL):
    assert got.iterations == want.iterations, (got.summary(),
                                               want.summary())
    assert got.converged == want.converged
    np.testing.assert_allclose(got.residual_rel, want.residual_rel,
                               rtol=1e-3)
    np.testing.assert_allclose(got.grid.data.numpy(),
                               np.asarray(want.grid.data), atol=tol)


@pytest.mark.parametrize("precond,smoother", [
    (None, None), ("mg", "wjacobi"), ("mg", "chebyshev"),
    ("tiled", "wjacobi"), ("tiled", "chebyshev")])
def test_cg_pcg_match_jax(rng, precond, smoother):
    shape = (15, 15, 15)
    jp, tp = _problems(shape)
    f = rng.normal(size=shape).astype(np.float32)
    kw = {} if smoother is None else {"smoother": smoother}
    jcg, tcg = _pair(jp, tp, precond, **kw)
    want = jcg.solve(f, tolerance=1e-5, max_iterations=200)
    got = tcg.solve(f, tolerance=1e-5, max_iterations=200)
    assert got.converged
    _assert_same(got, want)


@pytest.mark.parametrize("precond", [None, "mg", "tiled"])
def test_nonzero_walls_match_jax(rng, precond):
    """Nonzero walls on purpose: the correction cycle must run zero walls,
    which for the tiled fine level takes the zero-wall clone of the
    problem (its kernels hold the problem's walls in their ghosts)."""
    shape = (15, 15, 15)
    jp, tp = _problems(shape, bc=JBC.reference_default(3))
    f = rng.normal(size=shape).astype(np.float32)
    jcg, tcg = _pair(jp, tp, precond)
    want = jcg.solve(f, tolerance=1e-5, max_iterations=200)
    got = tcg.solve(f, tolerance=1e-5, max_iterations=200)
    _assert_same(got, want)


def test_constant_walls_solution_is_exact():
    jp, tp = _problems((15, 15), bc=JBC(values=((1.0, 1.0), (1.0, 1.0))))
    res = TCG(tp).solve(np.zeros((15, 15), np.float32), tolerance=1e-6,
                        max_iterations=500)
    np.testing.assert_allclose(res.grid.interior().numpy(), 1.0, atol=1e-5)


def test_warm_start_matches_jax(rng):
    shape = (15, 15, 15)
    jp, tp = _problems(shape)
    f = rng.normal(size=shape).astype(np.float32)
    jcold = JCG(jp).solve(f, tolerance=1e-2, max_iterations=500)
    tcold = TCG(tp).solve(f, tolerance=1e-2, max_iterations=500)
    _assert_same(tcold, jcold)
    jwarm = JCG(jp).solve(f, tolerance=1e-3, max_iterations=500,
                          initial=jcold.grid)
    twarm = TCG(tp).solve(f, tolerance=1e-3, max_iterations=500,
                          initial=tcold.grid)
    _assert_same(twarm, jwarm)
    assert twarm.residual <= 1.05e-3 * tcold.residual


@pytest.mark.parametrize("precond", [None, "mg", "tiled"])
def test_check_every_changes_nothing(rng, precond):
    """Iterations after convergence and before the host's check are
    masked: any ``check_every`` gives the grid, count and residual of a
    check after every iteration, and a budget cut mid-chunk stops at the
    budget."""
    shape = (15, 15, 15)
    _, tp = _problems(shape)
    f = rng.normal(size=shape).astype(np.float32)
    solver = _pair(JPoisson(shape=shape), tp, precond)[1]
    for tol, maxit in [(1e-5, 200), (1e-12, 5)]:
        every = solver.solve(f, tolerance=tol, max_iterations=maxit,
                             check_every=1)
        for n in (3, 8):
            got = solver.solve(f, tolerance=tol, max_iterations=maxit,
                               check_every=n)
            assert got.iterations == every.iterations
            assert got.residual == every.residual
            assert torch.equal(got.grid.data, every.grid.data)
    assert every.iterations == 5 and not every.converged


def test_bf16_preconditioning_cycle():
    """The eager cycle in bfloat16: at most two more iterations, the same
    solution (the JAX package's own bar)."""
    shape = (15, 15, 15)
    jp, tp = _problems(shape)
    f = np.random.default_rng(23).normal(size=shape).astype(np.float32)
    full = TCG(tp, preconditioner=TMG(tp, smoother="chebyshev")).solve(
        f, tolerance=1e-5, max_iterations=50)
    half = TCG(tp, preconditioner=TMG(tp, smoother="chebyshev"),
               precond_dtype="bfloat16").solve(f, tolerance=1e-5,
                                               max_iterations=50)
    jhalf = JCG(jp, preconditioner=JMG(jp, smoother="chebyshev"),
                precond_dtype="bfloat16").solve(f, tolerance=1e-5,
                                                max_iterations=50)
    assert full.converged and half.converged and jhalf.converged
    assert half.iterations <= full.iterations + 2
    assert abs(half.iterations - jhalf.iterations) <= 1  # bf16 rounds apart
    uf, uh = full.grid.interior().numpy(), half.grid.interior().numpy()
    assert np.max(np.abs(uf - uh)) < 1e-3 * np.max(np.abs(uf)) + 1e-6


def test_manufactured_solution_with_tiled_pcg():
    shape = (15, 15, 15)
    _, tp = _problems(shape)
    f, u = manufactured_sine(shape)
    res = TCG(tp, preconditioner=TMG(tp, nu1=4, nu2=4, smoother="chebyshev",
                                     fine_method="tiled")).solve(
        f, tolerance=1e-5, max_iterations=50)
    assert res.converged and res.iterations <= 8, res.summary()
    assert isinstance(res, CGResult) and "converged" in res.summary()
    err = np.max(np.abs(res.grid.interior().double().numpy() - u))
    assert err < 1.2 * (1.0 / 16) ** 2, err


def test_gates_match_jax():
    p31 = (31, 31)
    jp, tp = _problems(p31)
    jp3, tp3 = _problems((15, 15, 15))
    tbc = DirichletBC.zero(2).with_periodic((0,))
    cases = [
        (lambda: JCG(JPoisson(shape=p31, bc=JBC.zero(2).with_periodic((0,)))),
         lambda: TCG(dataclasses.replace(tp, bc=tbc))),
        (lambda: JCG(jp, preconditioner=JMG(JPoisson(shape=(15, 15)))),
         lambda: TCG(tp, preconditioner=TMG(_problems((15, 15))[1]))),
        (lambda: JCG(jp, preconditioner=JMG(jp, nu1=2, nu2=1)),
         lambda: TCG(tp, preconditioner=TMG(tp, nu1=2, nu2=1))),
        (lambda: JCG(jp, precond_dtype="bfloat16"),
         lambda: TCG(tp, precond_dtype="bfloat16")),
        (lambda: JCG(jp3, preconditioner=JMG(jp3, fine_method="pallas_tiled",
                                             interpret=True),
                     precond_dtype="bfloat16"),
         lambda: TCG(tp3, preconditioner=TMG(tp3, fine_method="pallas_tiled"),
                     precond_dtype="bfloat16")),
        (lambda: JCG(jp).solve(np.zeros((31, 30), np.float32)),
         lambda: TCG(tp).solve(np.zeros((31, 30), np.float32))),
    ]
    for jax_call, torch_call in cases:
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            torch_call()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="check_every"):
        TCG(tp).solve(np.zeros(p31), check_every=0)
    # the distributed solves (ported) refuse a 3-axis mesh, JAX's gate
    from stencil_tpu_torch.parallel.mesh import make_mesh

    mesh3 = make_mesh((2, 2, 2), ("x", "y", "z"), device="cpu")
    for solver in (TCG(tp), GMRES(tp), BiCGStab(tp)):
        with pytest.raises(ValueError, match="1D or 2D"):
            solver.solve(np.zeros(p31), mesh=mesh3)


def test_warm_start_gates_match_jax():
    shape = (15, 15)
    jp, tp = _problems(shape)
    bad_shape = HaloGrid.create((14, 15), halo=1, bc=DirichletBC.zero(2),
                                device="cpu")
    with pytest.raises(ValueError, match="warm-start interior"):
        _initial_or(tp, bad_shape)
    bad_bc = HaloGrid.create(shape, halo=1,
                             bc=DirichletBC.reference_default(2),
                             device="cpu")
    with pytest.raises(ValueError, match="boundary conditions"):
        TCG(tp).solve(np.zeros(shape, np.float32), initial=bad_bc)
    bad_halo = HaloGrid.create(shape, halo=2, bc=DirichletBC.zero(2),
                               device="cpu")
    with pytest.raises(ValueError, match="halo=1"):
        TCG(tp).solve(np.zeros(shape, np.float32), initial=bad_halo)
    assert _initial_or(tp, None).interior_shape == shape
