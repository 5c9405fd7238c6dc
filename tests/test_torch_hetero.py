"""The heterogeneous Poisson problem (stencil_tpu_torch/models/diffusion.py:
HeterogeneousPoissonProblem), its two matvec engines (the eager field
sweep and the tiled kernel's coefficient mode at k=1, ops/tiled.py:
coeff_apply, here its plain version), ``krylov.BiCGStab`` and
``multigrid.OperatorMultigrid`` against the JAX package, and BiCGStab on
the Poisson problem against the port's own CG.

Tolerances: the coefficient chain exactly equal (the same float64
arithmetic); a matvec 1e-5 relative to its largest entry (fp32; the JAX
fields are built in float64, the kernel forms its weights in fp32); a
solve: iteration count within 1 of JAX's (dot products reduce in another
order), the solution within the solve tolerance relative to its scale, the
same ``converged``; BiCGStab vs CG 1e-3 relative, the JAX tests' bar.
"""

import io

import numpy as np
import pytest
import torch

from stencil_tpu import cli as jcli
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu.core.spec import get_spec as jget_spec
from stencil_tpu.krylov import BiCGStab as JBiCGStab
from stencil_tpu.models import diffusion as jdiff
from stencil_tpu.multigrid import OperatorMultigrid as JOpMG
from stencil_tpu.ops import pallas_tiled as jpt
from stencil_tpu_torch import cli, convert
from stencil_tpu_torch.config import RunConfig
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.krylov import BiCGStab, ConjugateGradient
from stencil_tpu_torch.models import diffusion as tdiff
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.multigrid import Multigrid, OperatorMultigrid
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep


def _problems(shape, a, kernel="auto", jkernel="xla"):
    jp = jdiff.HeterogeneousPoissonProblem(shape=shape, a=a, kernel=jkernel,
                                           interpret=True)
    tp = convert.hetero_from_arrays(shape, a, jp.h, jp.bc.values,
                                    kernel=kernel, device="cpu")
    return jp, tp


@pytest.mark.parametrize("kernel,jkernel", [("auto", "xla"),
                                            ("pallas", "pallas")])
def test_operator_apply_matches_jax_on_a_random_ghost_ring(rng, kernel,
                                                           jkernel):
    """Both engines on a halo-1 input whose ghost ring is random and
    nonzero (the matvec must read it), against JAX's XLA matvec and its
    Pallas coefficient matvec in interpret mode."""
    shape = (9, 10, 11)
    a = rng.uniform(0.05, 2.0, size=shape)
    jp, tp = _problems(shape, a, kernel, jkernel)
    x = rng.normal(size=tuple(n + 2 for n in shape)).astype(np.float32)
    want = np.asarray(jp.operator_apply(x, jp.operator_data()))
    before = tiled_sweep.launches
    got = tp.operator_apply(torch.from_numpy(x), tp.operator_data()).numpy()
    assert tiled_sweep.launches == before  # the plain version is no launch
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)
    np.testing.assert_array_equal(
        tp.operator_inv_diagonal(tp.operator_data()).numpy(),
        np.asarray(jp.operator_inv_diagonal(jp.operator_data())))


def test_with_discretization_chain_equals_jax(rng):
    shape = (31, 31, 31)
    a = jdiff.two_material(shape, lo=0.01, hi=1.0, seed=6)
    jp, tp = _problems(shape, a)
    jmg, tmg = JOpMG(jp), OperatorMultigrid(tp)
    assert tmg.levels == jmg.levels == 4
    for j, t in zip(jmg._probs, tmg._probs):
        assert t.shape == j.shape and t.h == j.h
        assert t.bc == DirichletBC.zero(3)
        np.testing.assert_array_equal(t.a, j.a)
        np.testing.assert_array_equal(t.operator_fields()[1],
                                      j.operator_fields()[1])
    np.testing.assert_array_equal(tdiff._restrict_fw_np(a),
                                  jdiff._restrict_fw_np(a))
    # the kernel choice rides down the hierarchy
    _, kp = _problems(shape, a, kernel="pallas")
    assert all(p._use_kernel for p in OperatorMultigrid(kp)._probs)


@pytest.mark.parametrize("kernel", ["auto", "pallas"])
def test_bicgstab_opmg_matches_jax(kernel):
    """BiCGStab + OperatorMultigrid (a cheap cycle: one smoothing sweep,
    8 coarse sweeps) on the 15^3 two-material problem: the JAX iteration
    count within 1, the solution within the solve tolerance, the same
    converged; with both matvec engines."""
    shape = (15, 15, 15)
    a = jdiff.two_material(shape, lo=0.01, hi=1.0, seed=0)
    jp, tp = _problems(shape, a, kernel)
    f = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    kw = dict(nu1=1, nu2=1, coarse_sweeps=8)
    want = JBiCGStab(jp, preconditioner=JOpMG(jp, **kw)).solve(
        f, tolerance=1e-4)
    got = BiCGStab(tp, preconditioner=OperatorMultigrid(tp, **kw)).solve(
        f, tolerance=1e-4)
    assert got.converged == want.converged is True
    assert abs(got.iterations - want.iterations) <= 1
    u, uj = got.grid.interior().double().numpy(), np.asarray(
        want.grid.interior(), np.float64)
    assert np.max(np.abs(u - uj)) < 1e-4 * np.max(np.abs(uj))
    assert got.residual_rel <= 1e-4
    assert tp.residual_f64(got.grid, f) < 1e-3 * np.max(np.abs(f))


def test_bicgstab_on_poisson_lands_on_cg(rng):
    """On the symmetric Poisson operator (its operator_spec through the
    generic protocol) BiCGStab and CG reach the same discrete solution
    (tests/test_bicgstab.py:90)."""
    shape = (15, 15, 15)
    prob = PoissonProblem(shape=shape, device="cpu")
    f = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    cg = ConjugateGradient(prob).solve(f, tolerance=1e-5,
                                       max_iterations=2000)
    bi = BiCGStab(prob).solve(f, tolerance=1e-5, max_iterations=2000)
    assert cg.converged and bi.converged
    u, w = bi.grid.interior().numpy(), cg.grid.interior().numpy()
    assert np.max(np.abs(u - w)) < 1e-3 * np.max(np.abs(w))


def test_opmg_bicgstab_on_poisson_matches_pcg():
    """OperatorMultigrid on the Poisson operator preconditions BiCGStab to
    the MG-PCG solution (tests/test_bicgstab.py:304)."""
    prob = PoissonProblem(shape=(31, 31, 31), device="cpu")
    f = np.random.default_rng(33).normal(size=prob.shape).astype(np.float32)
    bi = BiCGStab(prob, preconditioner=OperatorMultigrid(prob)).solve(
        f, tolerance=1e-5, max_iterations=100)
    pcg = ConjugateGradient(prob, preconditioner=Multigrid(prob)).solve(
        f, tolerance=1e-5, max_iterations=100)
    assert bi.converged and pcg.converged
    assert bi.iterations <= pcg.iterations + 3
    u, w = bi.grid.interior().numpy(), pcg.grid.interior().numpy()
    assert np.max(np.abs(u - w)) < 1e-3 * np.max(np.abs(w)) + 1e-6


def test_restarts_keep_the_original_baseline(rng):
    """A budget cut short stops unconverged with the solution's own
    certificate; the iteration count never exceeds the budget."""
    shape = (7, 7, 7)
    _, tp = _problems(shape, jdiff.two_material(shape, lo=0.01, seed=2))
    f = rng.normal(size=shape).astype(np.float32)
    res = BiCGStab(tp).solve(f, tolerance=1e-8, max_iterations=5)
    assert not res.converged and res.iterations <= 5
    r = f - tp.apply_f64(res.grid.interior().double().numpy())
    b = np.linalg.norm(f.astype(np.float64).ravel())
    assert abs(res.residual_rel - np.linalg.norm(r.ravel()) / b) < 1e-3


def test_gates_match_jax():
    from stencil_tpu.core.grid import DirichletBC as JBC

    shape = (8, 8, 8)
    ones = np.ones(shape)
    periodic = (JBC.zero(3).with_periodic((0,)),
                DirichletBC.zero(3).with_periodic((0,)))
    for shp, kw, bcs in (
            (shape, dict(a=np.zeros(shape)), (None, None)),
            (shape, dict(a=ones), periodic),
            (shape, dict(a=ones, kernel="bogus"), (None, None)),
            ((8, 8), dict(a=np.ones((8, 8)), kernel="pallas"), (None, None))):
        with pytest.raises(ValueError) as want:
            jdiff.HeterogeneousPoissonProblem(shape=shp, bc=bcs[0], **kw)
        with pytest.raises(ValueError) as got:
            tdiff.HeterogeneousPoissonProblem(shape=shp, bc=bcs[1],
                                              device="cpu", **kw)
        assert str(got.value) == str(want.value)
    jp, tp = _problems(shape, ones)
    for call in (lambda p: p.with_discretization((3, 3, 3), 0.1),):
        with pytest.raises(ValueError) as want:
            call(jdiff.HeterogeneousPoissonProblem(shape=(8, 8, 8), a=ones))
        with pytest.raises(ValueError) as got:
            call(tp)
        assert str(got.value) == str(want.value)
    for kw in (dict(gamma=3), dict(nu1=0, nu2=0)):
        with pytest.raises(ValueError) as want:
            JOpMG(jp, **kw)
        with pytest.raises(ValueError) as got:
            OperatorMultigrid(tp, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JBiCGStab(jp, preconditioner=JOpMG(
            jdiff.HeterogeneousPoissonProblem(shape=(7, 7, 7),
                                              a=np.ones((7, 7, 7)))))
    with pytest.raises(ValueError) as got:
        BiCGStab(tp, preconditioner=OperatorMultigrid(_problems(
            (7, 7, 7), np.ones((7, 7, 7)))[1]))
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="needs data"):
        tp.operator_inv_diagonal(None)
    with pytest.raises(NotImplementedError, match="mesh"):
        BiCGStab(tp).solve(np.zeros(shape, np.float32), mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        tp.solve(np.zeros(shape, np.float32), mesh=object())


def test_solve_hetero_record_matches_jax(monkeypatch):
    """``--solve hetero -s 15 15 15 --nu-smooth 1 1 --tol 1e-4 -c``
    (BiCGStab + opmg): the record equals JAX's on its keys, iterations
    (within 1), converged and plan. Both packages' OperatorMultigrid run 8
    coarse sweeps here, not 32, so that the JAX solve compiles in about a
    second."""
    import functools

    import stencil_tpu.multigrid as jmg
    import stencil_tpu_torch.multigrid as tmg

    for mod in (jmg, tmg):
        monkeypatch.setattr(mod, "OperatorMultigrid", functools.partial(
            mod.OperatorMultigrid, coarse_sweeps=8))
    args = ["--solve", "hetero", "-s", "15", "15", "15", "--nu-smooth", "1",
            "1", "--tol", "1e-4", "-c"]
    (want,) = jcli.run_all(jparse_args(args), out=io.StringIO())
    (got,) = cli.run_all(RunConfig(solve="hetero", size=(15, 15, 15),
                                   nu_smooth=(1, 1), tolerance=1e-4,
                                   check=True, device="cpu"),
                         out=io.StringIO())
    assert set(got) == set(want) and set(got["check"]) == set(want["check"])
    assert got["plan"] == want["plan"]
    assert got["converged"] == want["converged"] is True
    assert abs(got["iterations"] - want["iterations"]) <= 1


@pytest.mark.parametrize("op_kernel", ["auto", "pallas"])
def test_solve_hetero_opmg_cli(op_kernel, tmp_path):
    """The default ``--solve hetero`` (BiCGStab + opmg) converges with
    either matvec, the same iterations; ``pallas`` goes through the
    coefficient mode (its plain version here)."""
    out = io.StringIO()
    (rec,) = cli.run_all(RunConfig(solve="hetero", size=(15, 15, 15),
                                   tolerance=1e-4, contrast=30.0,
                                   op_kernel=op_kernel, check=True,
                                   device="cpu"), out=out)
    assert rec["converged"] and rec["solver"] == "bicgstab"
    assert rec["plan"]["precond"] == "opmg"
    assert rec["check"]["residual_f64_rel"] < 1e-2
    assert cli.main(["--solve", "hetero", "-s", "9", "9", "--op-kernel",
                     "pallas", "--device", "cpu"]) == 1  # a 2D pallas


def test_hetero_solve_method_matches_bicgstab(rng):
    shape = (7, 7, 7)
    _, tp = _problems(shape, jdiff.two_material(shape, lo=0.1, seed=4))
    f = rng.normal(size=shape).astype(np.float32)
    res = tp.solve(f, tolerance=1e-5)
    want = BiCGStab(tp, preconditioner=OperatorMultigrid(tp)).solve(
        f, tolerance=1e-5)
    assert res.converged and res.iterations == want.iterations
    assert torch.equal(res.grid.data, want.grid.data)
    unpre = tp.solve(f, tolerance=1e-5, preconditioned=False)
    assert unpre.converged and unpre.iterations > res.iterations


def test_pallas_matvec_plan_is_k1_coeff():
    shape = (9, 8, 7)
    _, tp = _problems(shape, np.ones(shape), kernel="pallas")
    plan = tp._kernel_plan()
    inv_h2 = 1.0 / tp.h ** 2
    assert plan.sweeps_per_call == 1 and plan.layout.halo == 1
    assert plan.coeff_scales == (-inv_h2, 0.0, inv_h2)
    jplan = jpt.make_tiled_plan(jget_spec("jacobi7"), shape, "float32", 1,
                                tap_mode="coeff",
                                coeff_scales=(-inv_h2, 0.0, inv_h2))
    assert (jplan.coeff_nb, jplan.coeff_c0, jplan.coeff_cs) == \
        plan.coeff_scales
