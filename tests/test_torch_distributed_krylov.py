"""The port's distributed Krylov solves (stencil_tpu_torch/krylov.py with
``mesh=``) on the CPU: CG and MG-preconditioned CG, BiCGStab plain and
``OperatorMultigrid``-preconditioned (advdiff and hetero), GMRES plain and
preconditioned, on 1D and 2D meshes and on a non-leading dim, against the
port's one-device solve and the JAX package's (stencil_tpu/krylov.py),
at the shapes and bars of JAX's own distributed tests
(tests/test_krylov.py:178-225, test_bicgstab.py:125-140,279,
test_gmres.py:164-180, test_hetero_poisson.py:141, test_mesh2d.py); and
the gates with JAX's messages.

Bars: JAX's between its distributed and one-device solves. Iterations
within 2 on 1D meshes (the dot products sum in another order) and equal
on the (2, 4) preconditioned cases; interiors within 1e-6 (CG, PCG),
1e-4 (BiCGStab, and relative to the solution's scale for GMRES and the
preconditioned advdiff case), 1e-3 of the scale + 1e-6 (hetero), 5e-5
(PCG on (2, 4)). JAX's plain-BiCGStab test bars no iteration count: its
own one-device and distributed solves differ by 3 there."""

import numpy as np
import pytest
import torch

from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.krylov import GMRES as JGMRES
from stencil_tpu.krylov import BiCGStab as JBiCGStab
from stencil_tpu.krylov import ConjugateGradient as JCG
from stencil_tpu.models.advection_diffusion import (
    AdvectionDiffusionProblem as JAdvDiff,
)
from stencil_tpu.models.poisson import PoissonProblem as JPoisson
from stencil_tpu.models.poisson import manufactured_sine
from stencil_tpu.multigrid import Multigrid as JMultigrid
from stencil_tpu.parallel.halo import make_mesh as jmake_mesh
from stencil_tpu_torch import krylov
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.krylov import GMRES, BiCGStab, ConjugateGradient
from stencil_tpu_torch.models.advection_diffusion import (
    AdvectionDiffusionProblem,
)
from stencil_tpu_torch.models.diffusion import (
    HeterogeneousPoissonProblem, two_material,
)
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.multigrid import Multigrid, OperatorMultigrid
from stencil_tpu_torch.parallel import comm_audit
from stencil_tpu_torch.parallel.mesh import Mesh, make_mesh

SHAPE_2D_MESH = (127, 39, 15)  # test_mesh2d.py's deep odd ladder


def _mesh(*sizes):
    return make_mesh(sizes, ("x", "y")[:len(sizes)], device="cpu")


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _interior(res):
    return res.grid.interior().double().numpy()


@pytest.mark.parametrize("preconditioned", [False, True])
def test_cg_on_a_nonleading_dim_matches_one_device(preconditioned):
    """tests/test_krylov.py:178: (31, 63) sharded on dim 1 over 4 ranks,
    plain CG and MG-PCG; held to the port's and (plain CG) JAX's
    one-device solves."""
    shape = (31, 63)
    prob = PoissonProblem(shape=shape, device="cpu")
    f = _normal(shape, 9)
    pre = Multigrid(prob) if preconditioned else None
    cg = ConjugateGradient(prob, preconditioner=pre)
    one = cg.solve(f, tolerance=1e-5, max_iterations=500)
    dist = cg.solve(f, tolerance=1e-5, max_iterations=500, mesh=_mesh(4),
                    dim=1)
    assert one.converged and dist.converged
    assert abs(one.iterations - dist.iterations) <= 2
    assert _diff(_interior(one), _interior(dist)) < 1e-6
    if not preconditioned:
        jone = JCG(JPoisson(shape=shape)).solve(f, tolerance=1e-5,
                                                max_iterations=500)
        assert abs(jone.iterations - dist.iterations) <= 2
        assert _diff(jone.grid.interior(), _interior(dist)) < 1e-6


def test_distributed_pcg_converges_3d():
    """tests/test_krylov.py:202: (31, 31, 31) over 8 ranks,
    replicate_below 8, to 1.2 h^2 of the manufactured solution."""
    shape = (31, 31, 31)
    prob = PoissonProblem(shape=shape, device="cpu")
    f, u = manufactured_sine(shape)
    res = ConjugateGradient(prob, preconditioner=Multigrid(prob)).solve(
        f, tolerance=1e-5, mesh=_mesh(8), replicate_below=8)
    assert res.converged, res.summary()
    assert _diff(_interior(res), u) < 1.2 * (1.0 / 32) ** 2


def test_pcg_2d_mesh_matches_one_device():
    """tests/test_mesh2d.py:37: (127, 39, 15) on (2, 4): equal iterations,
    5e-5, and 100 h^2 of the exact solution."""
    prob = PoissonProblem(shape=SHAPE_2D_MESH, device="cpu")
    f, u = manufactured_sine(SHAPE_2D_MESH, h=prob.h)
    f = f.astype(np.float32)
    cg = ConjugateGradient(prob, preconditioner=Multigrid(prob))
    one = cg.solve(f, tolerance=1e-5, max_iterations=50)
    dist = cg.solve(f, tolerance=1e-5, max_iterations=50, mesh=_mesh(2, 4))
    assert dist.converged and dist.iterations == one.iterations
    assert _diff(_interior(one), _interior(dist)) < 5e-5
    assert _diff(_interior(dist), u) < 100 * float(prob.h) ** 2


def test_plain_cg_2d_mesh_converges():
    prob = PoissonProblem(shape=SHAPE_2D_MESH, device="cpu")
    f = manufactured_sine(SHAPE_2D_MESH, h=prob.h)[0].astype(np.float32)
    res = ConjugateGradient(prob).solve(f, tolerance=1e-5,
                                        max_iterations=2000,
                                        mesh=_mesh(2, 4))
    assert res.converged


def test_plain_bicgstab_matches_one_device_and_jax():
    """tests/test_bicgstab.py:125: advdiff (24, 9, 10), reference walls,
    over 4 ranks: converged, within 1e-4 of the port's and JAX's
    one-device solves."""
    shape = (24, 9, 10)
    kw = dict(shape=shape, velocity=(0.5, -0.25, 1.0), nu=1.0)
    prob = AdvectionDiffusionProblem(bc=DirichletBC.reference_default(3),
                                     device="cpu", **kw)
    f = _normal(shape, 8)
    one = BiCGStab(prob).solve(f, tolerance=1e-5, max_iterations=500)
    dist = BiCGStab(prob).solve(f, tolerance=1e-5, max_iterations=500,
                                mesh=_mesh(4), dim=0)
    jone = JBiCGStab(JAdvDiff(bc=JBC.reference_default(3), **kw)).solve(
        f, tolerance=1e-5, max_iterations=500)
    assert one.converged and dist.converged
    assert _diff(_interior(one), _interior(dist)) < 1e-4
    assert _diff(jone.grid.interior(), _interior(dist)) < 1e-4


@pytest.mark.parametrize("family", ["advdiff", "hetero"])
def test_preconditioned_bicgstab_matches_one_device(family):
    """tests/test_bicgstab.py:279 and test_hetero_poisson.py:141: (31, 15,
    15) over 4 ranks, replicate_below 16, the rediscretized cycle on its
    ladder (the hetero weight fields cut like each level)."""
    shape = (31, 15, 15)
    if family == "advdiff":
        prob = AdvectionDiffusionProblem(shape=shape,
                                         velocity=(1.0, -0.5, 0.25),
                                         nu=0.1, device="cpu")
        f, budget = _normal(shape, 34), 100
    else:
        prob = HeterogeneousPoissonProblem(
            shape=shape, a=two_material(shape, seed=7),
            bc=DirichletBC.reference_default(3), device="cpu")
        f, budget = _normal(shape, 8), 300
    s = BiCGStab(prob, preconditioner=OperatorMultigrid(prob))
    one = s.solve(f, tolerance=1e-5, max_iterations=budget)
    dist = s.solve(f, tolerance=1e-5, max_iterations=budget,
                   mesh=_mesh(4), replicate_below=16)
    assert one.converged and dist.converged
    assert abs(one.iterations - dist.iterations) <= 2
    scale = float(np.max(np.abs(_interior(one))))
    bar = 1e-4 * scale if family == "advdiff" else 1e-3 * scale + 1e-6
    assert _diff(_interior(one), _interior(dist)) < bar


def test_gmres_matches_one_device_and_jax():
    """tests/test_gmres.py:164: (17, 16) upwind over 4 ranks (17 cut 5, 4,
    4, 4): within 1e-4 of the solution's scale of the port's and JAX's
    one-device solves."""
    shape = (17, 16)
    kw = dict(shape=shape, velocity=(1.0, -0.5), nu=1.0, scheme="upwind")
    prob = AdvectionDiffusionProblem(device="cpu", **kw)
    f = _normal(shape, 11)
    one = GMRES(prob).solve(f, tolerance=1e-6, max_iterations=500)
    dist = GMRES(prob).solve(f, tolerance=1e-6, max_iterations=500,
                             mesh=_mesh(4))
    jone = JGMRES(JAdvDiff(**kw)).solve(f, tolerance=1e-6,
                                       max_iterations=500)
    assert one.converged and dist.converged
    assert abs(one.iterations - dist.iterations) <= 2
    scale = float(np.max(np.abs(_interior(one))))
    assert _diff(_interior(one), _interior(dist)) < 1e-4 * scale
    assert _diff(jone.grid.interior(), _interior(dist)) < 1e-4 * scale


@pytest.mark.parametrize("cls,kw", [(BiCGStab, {}),
                                    (GMRES, {"restart": 8})])
def test_nonsymmetric_2d_mesh_preconditioned(cls, kw):
    """tests/test_mesh2d.py:66: advdiff (127, 39, 15) on (2, 4), the cycle
    on the per-axis ladder: equal iterations, within 1e-4."""
    prob = AdvectionDiffusionProblem(SHAPE_2D_MESH, velocity=(2.0, 1.0, 0.0),
                                     nu=0.1, device="cpu")
    f = _normal(SHAPE_2D_MESH, 0)
    pre = OperatorMultigrid(prob)
    one = cls(prob, preconditioner=pre, **kw).solve(
        f, tolerance=1e-5, max_iterations=200)
    dist = cls(prob, preconditioner=pre, **kw).solve(
        f, tolerance=1e-5, max_iterations=200, mesh=_mesh(2, 4))
    assert dist.converged and dist.iterations == one.iterations
    assert _diff(_interior(one), _interior(dist)) < 1e-4


def test_unpreconditioned_2d_mesh_gmres():
    """tests/test_mesh2d.py:85: (18, 18, 15) on (2, 2), GMRES(20)."""
    prob = AdvectionDiffusionProblem((18, 18, 15), velocity=(1.0, 0, 0),
                                     nu=0.5, device="cpu")
    f = _normal(prob.shape, 1)
    one = GMRES(prob, restart=20).solve(f, tolerance=1e-5,
                                        max_iterations=200)
    dist = GMRES(prob, restart=20).solve(f, tolerance=1e-5,
                                         max_iterations=200,
                                         mesh=_mesh(2, 2))
    assert dist.converged and dist.iterations == one.iterations


def test_hetero_solve_passes_the_mesh_on():
    """``HeterogeneousPoissonProblem.solve(mesh=)``: a ``kernel='pallas'``
    problem solves through its eager twin on a mesh, as JAX's through its
    XLA twin; the result equals the eager problem's distributed solve."""
    shape = (31, 15, 15)
    a = two_material(shape, seed=3)
    f = _normal(shape, 2)
    eager = HeterogeneousPoissonProblem(shape=shape, a=a, device="cpu")
    kern = HeterogeneousPoissonProblem(shape=shape, a=a, kernel="pallas",
                                       device="cpu")
    want = eager.solve(f, max_iterations=50, mesh=_mesh(2))
    got = kern.solve(f, max_iterations=50, mesh=_mesh(2))
    assert got.converged and got.iterations == want.iterations
    assert torch.equal(got.grid.data, want.grid.data)


def test_gates_match_jax():
    """"1D or 2D", "out of range" and "too narrow" as JAX's messages; the
    tiled fine level and the pallas coefficient matvec refused."""
    jp, tp = JPoisson(shape=(63, 63)), PoissonProblem(shape=(63, 63),
                                                      device="cpu")
    f = np.zeros((63, 63), np.float32)
    jm3 = jmake_mesh((2, 2, 2), ("x", "y", "z"))
    tm3 = make_mesh((2, 2, 2), ("x", "y", "z"), device="cpu")
    small = (34, 15, 15)
    fs = np.ones(small, np.float32)
    js, ts = JPoisson(shape=small), PoissonProblem(shape=small,
                                                   device="cpu")
    cases = [
        (lambda: JCG(jp).solve(f, mesh=jm3),
         lambda: ConjugateGradient(tp).solve(f, mesh=tm3), "1D or 2D"),
        (lambda: JCG(jp, preconditioner=JMultigrid(jp)).solve(
            f, mesh=jmake_mesh((4,), ("x",)), replicate_below=64),
         lambda: ConjugateGradient(tp, preconditioner=Multigrid(tp)).solve(
             f, mesh=_mesh(4), replicate_below=64), "too narrow"),
        (lambda: JCG(JPoisson(shape=(15, 15, 15))).solve(
            np.zeros((15,) * 3, np.float32), max_iterations=2,
            mesh=jmake_mesh((2, 4), ("x", "y")), dim=2),
         lambda: ConjugateGradient(PoissonProblem(
             shape=(15, 15, 15), device="cpu")).solve(
             np.zeros((15,) * 3, np.float32), max_iterations=2,
             mesh=_mesh(2, 4), dim=2), "out of range"),
        (lambda: JCG(js, preconditioner=JMultigrid(js)).solve(
            fs, max_iterations=2, mesh=jmake_mesh((2, 4), ("x", "y"))),
         lambda: ConjugateGradient(ts, preconditioner=Multigrid(ts)).solve(
             fs, max_iterations=2, mesh=_mesh(2, 4)), "too narrow"),
        (lambda: JBiCGStab(JAdvDiff(shape=(8, 8), velocity=(1.0, 0.0))
                           ).solve(np.ones((8, 8), np.float32), mesh=jm3),
         lambda: BiCGStab(AdvectionDiffusionProblem(
             shape=(8, 8), velocity=(1.0, 0.0), device="cpu")).solve(
             np.ones((8, 8), np.float32), mesh=tm3), "1D or 2D"),
    ]
    for jcall, tcall, match in cases:
        with pytest.raises(ValueError) as want:
            jcall()
        with pytest.raises(ValueError, match=match) as got:
            tcall()
        assert str(got.value) == str(want.value)
    p3 = PoissonProblem(shape=(31, 31, 31), device="cpu")
    with pytest.raises(ValueError, match="GSPMD"):
        ConjugateGradient(p3, preconditioner=Multigrid(
            p3, fine_method="pallas_tiled")).solve(
            np.zeros((31,) * 3, np.float32), mesh=_mesh(4))
    hp = HeterogeneousPoissonProblem(shape=(15, 15, 15),
                                     a=np.ones((15, 15, 15)),
                                     kernel="pallas", device="cpu")
    for solver in (BiCGStab(hp), GMRES(hp),
                   BiCGStab(hp, preconditioner=OperatorMultigrid(hp))):
        with pytest.raises(ValueError,
                           match="pallas coeff matvec is single-device"):
            solver.solve(np.ones((15, 15, 15), np.float32), mesh=_mesh(2))


def test_gmres_basis_budget_counts_distinct_devices(monkeypatch):
    """The basis is divided over the mesh's distinct devices: four ranks
    of one device pay the one-device budget, four devices a quarter."""
    from stencil_tpu_torch import device_model

    prob = AdvectionDiffusionProblem(shape=(64, 64, 64),
                                     velocity=(1.0, 0.0, 0.0), device="cpu")
    f = torch.zeros((64, 64, 64))
    per_vec = 64 ** 3 * 4
    # half the memory holds 10 vectors: restart 16 does not fit on one
    # device, a quarter of it per device does
    monkeypatch.setattr(device_model, "hbm_bytes",
                        lambda *a, **k: 20 * per_vec)
    g = GMRES(prob, restart=16)
    with pytest.raises(ValueError, match="exceeds half of device memory"):
        g._check_basis_budget(f, _mesh(4))
    four = Mesh(shape=(4,), axis_names=("x",),
                devices=tuple(torch.device("cpu", i) for i in range(4)))
    g._check_basis_budget(f, four)


def test_gmres_step_audit_counts_its_dots():
    """Each Arnoldi step on a mesh makes 3 all-reduces: the two
    Gram-Schmidt passes' stacked dots and the new vector's norm
    (tests/test_torch_comm_volume.py holds PCG's and the cycle's)."""
    adv = AdvectionDiffusionProblem(shape=(17, 16), velocity=(1.0, -0.5),
                                    device="cpu")
    fa = _normal((17, 16), 11)

    def reduces(steps):
        with comm_audit.audit() as rec:
            GMRES(adv, restart=8).solve(fa, tolerance=1e-12,
                                        max_iterations=steps,
                                        mesh=_mesh(4), stall_ratio=None)
        return rec.all_reduce_count

    assert reduces(3) - reduces(2) == 3


def test_check_mesh_operator_is_jax_rule():
    """``_check_mesh_operator`` looks at the problem and every level of the
    preconditioner, as JAX's does."""
    hp = HeterogeneousPoissonProblem(shape=(15, 15, 15),
                                     a=np.ones((15, 15, 15)), device="cpu")
    krylov._check_mesh_operator(hp, OperatorMultigrid(hp))
    kp = HeterogeneousPoissonProblem(shape=(15, 15, 15),
                                     a=np.ones((15, 15, 15)),
                                     kernel="pallas", device="cpu")
    with pytest.raises(ValueError, match="kernel='xla'"):
        krylov._check_mesh_operator(hp, OperatorMultigrid(kp))
