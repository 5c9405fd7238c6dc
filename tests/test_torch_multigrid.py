"""The port's multigrid (stencil_tpu_torch/multigrid.py) against the JAX
package's (stencil_tpu/multigrid.py) on the CPU: the hierarchy, the spec
factories and the Chebyshev coefficients exactly; the level ops, the V- and
W-cycle runner, FMG and the solve against the JAX XLA cycle; the tiled fine
level (the kernel's plain version on the CPU) against the JAX XLA fine
level; the gates; and that no cycle syncs with the host.

Tolerances: the level ops 1e-6 absolute (fp32, values of order 1); the
cycles 1e-6 absolute on iterates of order 1e-2 (fp32, the same operations
in the same order; measured ~1e-9); the tiled fine level 5e-6, the bar of
the JAX package's own tiled-vs-XLA cycle test
(tests/test_multigrid.py::test_chebyshev_pallas_fine_matches_xla_cycle)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu import multigrid as jmg
from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.models.poisson import PoissonProblem as JPoisson
from stencil_tpu.models.poisson import manufactured_sine
from stencil_tpu_torch import convert
from stencil_tpu_torch import multigrid as tmg
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

TOL = 1e-6
TILED_TOL = 5e-6


def _problems(shape, bc=None):
    jp = JPoisson(shape=shape, bc=bc)
    tp = convert.poisson_from_arrays(jp.shape, jp.h, jp.bc.values,
                                     device="cpu")
    return jp, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_level_shapes_match_jax():
    for shape, m in [((63, 63), 3), ((64, 64), 3), ((31, 15), 3),
                     ((255, 255, 255), 3), ((31, 31, 31), 7),
                     ((57, 50, 46), 3), ((3, 3), 3), ((15, 7, 31), 1)]:
        assert tmg._level_shapes(shape, m) == jmg._level_shapes(shape, m)


def test_spec_factories_and_cheby_coeffs_match_jax():
    for nd in (2, 3):
        for t, j in [(tmg.wjacobi_spec(nd, 2 / 3), jmg.wjacobi_spec(nd, 2 / 3)),
                     (tmg.wjacobi_spec(nd, 0.8), jmg.wjacobi_spec(nd, 0.8)),
                     (tmg.residual_spec(nd, 1 / 16),
                      jmg.residual_spec(nd, 1 / 16)),
                     (tmg.nbsum_spec(nd), jmg.nbsum_spec(nd))]:
            assert (t.offsets, t.weights, t.radius, t.name) == \
                (j.offsets, j.weights, j.radius, j.name)
            assert t.weight_groups() == j.weight_groups()
    for nu in (1, 2, 4, 7):
        for ratio, nd, h in [(4.0, 3, 1 / 256), (2.5, 2, 0.1)]:
            assert tmg._cheby_sweep_coeffs(nu, ratio, nd, h) == \
                jmg._cheby_sweep_coeffs(nu, ratio, nd, h)


@pytest.mark.parametrize("shape", [(15, 13, 9), (31, 17)])
def test_transfers_match_jax(rng, shape):
    r = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(
        _np(tmg._restrict_fw(torch.from_numpy(r))),
        _np(jmg._restrict_fw(jnp.asarray(r))), atol=TOL)
    e = rng.normal(size=tuple((n - 1) // 2 for n in shape)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        _np(tmg._prolong_lin(torch.from_numpy(e))),
        _np(jmg._prolong_lin(jnp.asarray(e))), atol=TOL)
    u = rng.normal(size=tuple((n - 1) // 2 + 2 for n in shape)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        _np(tmg._prolong_full(torch.from_numpy(u))),
        _np(jmg._prolong_full(jnp.asarray(u))), atol=TOL)


@pytest.mark.parametrize("shape", [(9, 10, 11), (17, 15)])
def test_smoothers_and_residual_match_jax(rng, shape):
    """``_smooth``/``_smooth_cheby`` update in place where the JAX ops
    return new arrays: each gets its own copy."""
    pad = rng.normal(size=tuple(n + 2 for n in shape)).astype(np.float32)
    f = rng.normal(size=shape).astype(np.float32)
    nd, h = len(shape), 0.1
    inv_h2, two_d = 1 / h ** 2, 2.0 * nd
    tp, tf = torch.from_numpy(pad), torch.from_numpy(f)
    jp_, jf = jnp.asarray(pad), jnp.asarray(f)
    np.testing.assert_allclose(_np(tmg._nb_sum(tp)), _np(jmg._nb_sum(jp_)),
                               atol=TOL)
    np.testing.assert_allclose(
        _np(tmg._residual(tp, tf, inv_h2, two_d)),
        _np(jmg._residual(jp_, jf, inv_h2, two_d)), atol=100 * TOL,
        rtol=TOL)  # r carries the 1/h^2 = 100 of the operator
    np.testing.assert_allclose(
        _np(tmg._smooth(tp.clone(), h * h * tf, 2 / 3, 1 / two_d, 3)),
        _np(jmg._smooth(jp_, h * h * jf, 2 / 3, 1 / two_d, 3)), atol=TOL)
    np.testing.assert_allclose(
        _np(tmg._smooth_cheby(tp.clone(), tf, inv_h2, two_d, 4, 4.0)),
        _np(jmg._smooth_cheby(jp_, jf, inv_h2, two_d, 4, 4.0)), atol=TOL)
    assert torch.equal(tp, torch.from_numpy(pad))  # the copies, not tp


@pytest.mark.parametrize("shape", [(15, 15, 15), (31, 31)])
@pytest.mark.parametrize("smoother", ["wjacobi", "chebyshev"])
@pytest.mark.parametrize("gamma", [1, 2])
def test_eager_runner_matches_jax(rng, shape, smoother, gamma):
    jp, tp = _problems(shape)
    f = rng.normal(size=shape).astype(np.float32)
    jr = jmg.Multigrid(jp, smoother=smoother, gamma=gamma).runner(f)
    tr = tmg.Multigrid(tp, smoother=smoother, gamma=gamma).runner(f)
    want = jr.iterate(jp.initial_grid(), 2)
    got = tr.iterate(tp.initial_grid(), 2)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL)
    assert tr.plan_info == {k: v for k, v in jr.plan_info.items()}


@pytest.mark.parametrize("smoother,nu1,nu2,gamma", [
    ("chebyshev", 2, 2, 1), ("chebyshev", 3, 1, 1), ("chebyshev", 2, 2, 2),
    ("wjacobi", 2, 2, 1), ("wjacobi", 4, 4, 1), ("wjacobi", 0, 2, 1)])
def test_tiled_fine_matches_jax_xla_fine(rng, smoother, nu1, nu2, gamma):
    """The fine level on the tiled kernel (its plain version here): the
    source mode, the Chebyshev mode and the fused smooth+residual."""
    shape = (15, 15, 15)
    jp, tp = _problems(shape)
    f = rng.normal(size=shape).astype(np.float32)
    kw = dict(nu1=nu1, nu2=nu2, gamma=gamma, smoother=smoother)
    want = jmg.Multigrid(jp, **kw).runner(f).iterate(jp.initial_grid(), 3)
    mg = tmg.Multigrid(tp, fine_method="pallas_tiled", **kw)
    r = mg.runner(f)
    assert r.plan_info["fine_method"] == "pallas_tiled"
    assert len(r.plan_info["fine_tiles"]) == 3
    got = r.iterate(tp.initial_grid(), 3)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=TILED_TOL)


def test_tiled_fine_ops_are_the_jax_plans():
    """Each fine-level operation has the spec, depth, coefficients and
    source scale of the JAX ``_fine_ops``."""
    for smoother, nu1, nu2 in [("chebyshev", 2, 2), ("chebyshev", 4, 1),
                               ("wjacobi", 4, 4), ("wjacobi", 2, 3),
                               ("wjacobi", 0, 2)]:
        jp, tp = _problems((15, 15, 15))
        f = np.zeros(jp.shape, np.float32)
        jops = jmg.Multigrid(jp, smoother=smoother, nu1=nu1, nu2=nu2,
                             fine_method="pallas_tiled",
                             interpret=True)._fine_ops(f)
        tops = tmg.Multigrid(tp, smoother=smoother, nu1=nu1, nu2=nu2,
                             fine_method="tiled")._fine_ops()
        assert (jops[3] is None) == (tops[3] is None)
        assert (jops[0] is jops[2]) == (tops[0] is tops[2])
        for j, t in zip(jops, tops):
            if j is None:
                continue
            assert t.plan.spec.offsets == j.plan.spec.offsets
            assert t.plan.spec.weights == j.plan.spec.weights
            assert t.plan.sweeps_per_call == j.plan.sweeps_per_call
            assert t.plan.cheby_coeffs == j.plan.cheby_coeffs
            assert t.plan.cheby_dual == j.plan.cheby_dual
            assert t.source_scale == j.source_scale


def test_tiled_fine_launches_each_mode(rng):
    """On the CPU the wrapper runs the plain version and counts nothing;
    the launch counts are the card's (tests/test_torch_cuda.py)."""
    jp, tp = _problems((15, 15, 15))
    f = rng.normal(size=jp.shape).astype(np.float32)
    before = (tiled_sweep.launches, tiled_sweep.dual_launches)
    tmg.Multigrid(tp, smoother="chebyshev", fine_method="tiled") \
        .runner(f).iterate(tp.initial_grid(), 1)
    assert (tiled_sweep.launches, tiled_sweep.dual_launches) == before


@pytest.mark.parametrize("shape,fine", [((15, 15, 15), "xla"),
                                        ((15, 15, 15), "pallas_tiled"),
                                        ((31, 31), "xla")])
def test_fmg_matches_jax(shape, fine):
    jp, tp = _problems(shape)
    f, _ = manufactured_sine(shape)
    want = jmg.Multigrid(jp).fmg(f.astype(np.float32), n_vcycles=1)
    got = tmg.Multigrid(tp, fine_method=fine).fmg(f, n_vcycles=1)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TILED_TOL if fine != "xla" else TOL)


def test_fmg_nonzero_walls_matches_jax():
    shape = (15, 15)
    jp, tp = _problems(shape, bc=JBC(values=((1.0, 1.0), (1.0, 1.0))))
    f = np.zeros(shape, np.float32)
    want = jmg.Multigrid(jp).fmg(f)
    got = tmg.Multigrid(tp).fmg(f)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL)
    np.testing.assert_allclose(got.interior().numpy(), 1.0, atol=1e-4)


def test_solve_and_residual_norm_match_jax():
    shape = (15, 15, 15)
    jp, tp = _problems(shape)
    f, u_exact = manufactured_sine(shape)
    jm, tm = jmg.Multigrid(jp), tmg.Multigrid(tp)
    want = jm.solve(f, tolerance=1e-6, max_cycles=30)
    got = tm.solve(f, tolerance=1e-6, max_cycles=30)
    assert got.converged and got.iterations == want.iterations
    np.testing.assert_allclose(got.grid.data.numpy(),
                               np.asarray(want.grid.data), atol=TOL)
    err = np.max(np.abs(got.grid.interior().double().numpy() - u_exact))
    assert err < 1.2 * (1.0 / 16) ** 2
    # the certificate after one cycle, well above the fp32 floor (at
    # convergence both sit on it, ~eps |u| 2 ndim / h^2, and differ by
    # rounding)
    g1 = tm.runner(f).iterate(tp.initial_grid(), 1)
    np.testing.assert_allclose(
        tm.residual_norm(g1, f),
        jm.residual_norm(jm.runner(f).iterate(jp.initial_grid(), 1), f),
        rtol=1e-5)
    assert tm.residual_norm(got.grid, f) < 5e-3


def test_even_width_single_level_on_both_fine_levels(rng):
    """A non-coarsenable grid is one level: pure damped-Jacobi smoothing,
    eager or through the tiled kernel's source mode."""
    shape = (16, 16, 16)
    jp, tp = _problems(shape)
    f = rng.normal(size=shape).astype(np.float32)
    want = jmg.Multigrid(jp).runner(f).iterate(jp.initial_grid(), 1)
    for fine in ("xla", "tiled"):
        mg = tmg.Multigrid(tp, fine_method=fine)
        assert mg.levels == 1
        got = mg.runner(f).iterate(tp.initial_grid(), 1)
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   atol=TILED_TOL)


def test_gates_match_jax():
    p2, p3 = _problems((31, 31))[1], _problems((15, 15, 15))[1]
    bc = DirichletBC.zero(2).with_periodic((0,))
    jbc = JBC.zero(2).with_periodic((0,))
    cases = [
        (dict(problem=convert.poisson_from_arrays(
            (31, 31), 1 / 32, bc.values, bc.periodic, device="cpu")),
         dict(problem=JPoisson(shape=(31, 31), bc=jbc))),
        (dict(problem=p2, fine_method="pallas_tiled"),
         dict(problem=JPoisson(shape=(31, 31)), fine_method="pallas_tiled")),
        (dict(problem=p3, smoother="sor"),
         dict(problem=JPoisson(shape=(15, 15, 15)), smoother="sor")),
        (dict(problem=p3, cheby_ratio=1.0),
         dict(problem=JPoisson(shape=(15, 15, 15)), cheby_ratio=1.0)),
        (dict(problem=p3, gamma=3),
         dict(problem=JPoisson(shape=(15, 15, 15)), gamma=3)),
        (dict(problem=_problems((16, 16, 16))[1], smoother="chebyshev",
              fine_method="pallas_tiled"),
         dict(problem=JPoisson(shape=(16, 16, 16)), smoother="chebyshev",
              fine_method="pallas_tiled")),
    ]
    for tkw, jkw in cases:
        with pytest.raises(ValueError) as want:
            jmg.Multigrid(**jkw)
        with pytest.raises(ValueError) as got:
            tmg.Multigrid(**tkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="fine_method"):
        tmg.Multigrid(p3, fine_method="bogus")
    with pytest.raises(ValueError, match="source shape"):
        tmg.Multigrid(p2).runner(np.zeros((31, 30), np.float32))
    with pytest.raises(ValueError, match="halo=1"):
        tmg.Multigrid(p2).runner(np.zeros((31, 31))).iterate(
            p2.initial_grid().__class__.create((31, 31), halo=2,
                                               device="cpu"), 1)
    with pytest.raises(NotImplementedError, match="Multigrid.sharded_runner"):
        tmg.Multigrid(p2).sharded_runner(np.zeros((31, 31)), mesh=None)
    # OperatorMultigrid (ported) rediscretizes the problem at each level
    assert tmg.OperatorMultigrid(p2).levels == tmg.Multigrid(p2).levels
    # the JAX package's interpret flag is accepted and changes nothing
    assert tmg.Multigrid(p3, interpret=True).levels == 3


@pytest.mark.parametrize("fine,smoother", [("xla", "wjacobi"),
                                           ("tiled", "chebyshev"),
                                           ("tiled", "wjacobi")])
def test_vcycle_loop_never_syncs_with_the_host(monkeypatch, rng, fine,
                                               smoother):
    """The runner queues its cycles: no ``.item()``, ``float()``,
    ``bool()``, ``.tolist()`` or ``.cpu()`` on a tensor."""
    shape = (15, 15, 15)
    tp = _problems(shape)[1]
    f = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    r = tmg.Multigrid(tp, smoother=smoother, fine_method=fine).runner(f)
    g = tp.initial_grid()

    def sync(*a, **k):
        raise AssertionError("host sync inside the V-cycle loop")

    for name in ("item", "__float__", "__bool__", "__int__", "tolist",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    out = r.iterate(g, 2)
    monkeypatch.undo()
    assert np.isfinite(out.data.numpy()).all()
