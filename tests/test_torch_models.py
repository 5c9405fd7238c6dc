"""The slice as a whole: the port's model families (models/poisson.py,
models/heat.py), its solver (solver.py) and ``convert.poisson_from_arrays``
against the JAX package's. The same problem, built in both packages from
numpy, relaxes through each method of ``PoissonProblem.runner`` (the eager
sweep, the tiled source kernel, the slab source kernel; the TPU kernels in
interpret mode, the port's kernels as their plain versions on the CPU),
and the manufactured solve converges to the exact solution.

Tolerances: runners within 2e-6 over 12 iterations, the JAX package's own
bar for its kernel runners against ``xla`` (the eager runner scales a host
source in float64, the kernel runners in float32); manufactured solves
within 5 h² of the exact solution, the discretisation bar of
tests/test_tiled_source.py; problem properties exactly."""

import numpy as np
import pytest
import torch

from stencil_tpu import solver as jsolver
from stencil_tpu.models import heat as jheat
from stencil_tpu.models import poisson as jpoisson
from stencil_tpu_torch import convert, solver
from stencil_tpu_torch.models import heat, poisson

RUNNER_TOL = 2e-6


def _pair(shape):
    jp = jpoisson.PoissonProblem(shape=shape)
    tp = convert.poisson_from_arrays(jp.shape, jp.h, jp.bc.values,
                                     jp.bc.periodic, jp.bc.neumann,
                                     jp.dtype, device="cpu")
    return jp, tp


def _taps(spec):
    return spec.ndim, spec.radius, spec.offsets, spec.weights


@pytest.mark.parametrize("shape", [(12, 16, 20), (24, 32)])
def test_poisson_properties_match_jax(shape):
    jp, tp = _pair(shape)
    assert tp == poisson.PoissonProblem(shape=shape, device="cpu")
    assert tp.h == jp.h and tp.ndim == jp.ndim
    assert tp.bc.values == jp.bc.values
    assert _taps(tp.spec) == _taps(jp.spec)
    assert _taps(tp.operator_spec) == _taps(jp.operator_spec)
    assert tp.source_scale == jp.source_scale
    assert tp.operator_inv_diagonal() == jp.operator_inv_diagonal()
    assert tp.operator_data() is None and jp.operator_data() is None
    jc = jp.with_discretization((5,) * len(shape), 0.25)
    tc = tp.with_discretization((5,) * len(shape), 0.25)
    assert (tc.shape, tc.h, tc.bc.values) == (jc.shape, jc.h, jc.bc.values)
    np.testing.assert_array_equal(tp.initial_grid().data.numpy(),
                                  np.asarray(jp.initial_grid().data))


def test_poisson_operator_and_certificate_match_jax(rng):
    shape = (9, 11, 10)
    jp, tp = _pair(shape)
    u = rng.random(shape).astype(np.float32)
    f = rng.normal(size=shape)
    np.testing.assert_array_equal(tp.apply_f64(u), jp.apply_f64(u))
    assert tp.residual_f64(tp.initial_grid(u), f) == \
        jp.residual_f64(jp.initial_grid(u), f)
    padded = tp.initial_grid(u).data
    want = jp.operator_apply(np.asarray(jp.initial_grid(u).data))
    np.testing.assert_allclose(tp.operator_apply(padded).numpy(),
                               np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("shape,method,jax_kw,port_kw", [
    ((12, 16, 20), "xla", {}, {}),
    ((12, 16, 20), "pallas_tiled", {"sweeps_per_call": 4,
                                    "interpret": True},
     {"sweeps_per_call": 4}),
    ((24, 32), "xla", {}, {}),
    ((24, 32), "pallas_slab", {"sweeps_per_call": 4, "interpret": True},
     {"sweeps_per_call": 4}),
])
def test_poisson_runner_matches_jax(rng, shape, method, jax_kw, port_kw):
    jp, tp = _pair(shape)
    f = rng.normal(size=shape)
    want = jp.runner(f, method=method, **jax_kw).iterate(jp.initial_grid(),
                                                         12)
    runner = tp.runner(f, method=method, **port_kw)
    got = runner.iterate(tp.initial_grid(), 12)
    assert float(np.max(np.abs(got.interior().double().numpy()
                               - np.asarray(want.interior(), np.float64)))
                 ) < RUNNER_TOL
    assert runner.plan_info["has_source"]


@pytest.mark.parametrize("shape", [(12, 16, 20), (24, 32)])
def test_poisson_kernel_runner_matches_eager(rng, shape):
    """``auto`` picks the kernel of the problem's rank and matches the
    eager runner (the JAX test_poisson_*_runner_matches_xla)."""
    _, tp = _pair(shape)
    f = rng.normal(size=shape)
    auto = tp.runner(f, method="auto", sweeps_per_call=4)
    assert auto.plan_info["kernel"] == ("tiled" if len(shape) == 3
                                        else "slab")
    assert auto.granularity == 4
    a = tp.runner(f, method="eager").iterate(tp.initial_grid(), 12)
    b = auto.iterate(tp.initial_grid(), 12)
    assert float((a.interior() - b.interior()).abs().max()) < RUNNER_TOL


@pytest.mark.parametrize("shape,method", [((12, 12, 12), "auto"),
                                          ((15, 15), "auto"),
                                          ((15, 15), "xla")])
def test_poisson_manufactured_solution(shape, method):
    prob = poisson.PoissonProblem(shape=shape, device="cpu")
    f, u_exact = poisson.manufactured_sine(shape)
    res = prob.solve(f, tolerance=5e-7, max_iterations=20_000,
                     check_every=500, method=method, sweeps_per_call=4) \
        if method == "auto" else prob.solve(
            f, tolerance=5e-7, max_iterations=20_000, check_every=500,
            method=method)
    assert res.converged, res.summary()
    u = res.grid.interior().double().numpy()
    assert np.max(np.abs(u - u_exact)) < 5.0 * prob.h ** 2
    assert prob.residual_f64(res.grid, f) < 1.0


def test_manufactured_sine_matches_jax():
    for shape in ((7, 9), (5, 6, 4)):
        for got, want in zip(poisson.manufactured_sine(shape),
                             jpoisson.manufactured_sine(shape)):
            np.testing.assert_array_equal(got, want)


def test_poisson_runner_refusals_and_ignored_flags():
    tp = poisson.PoissonProblem(shape=(8, 8), device="cpu")
    f = np.zeros((8, 8))
    with pytest.raises(ValueError, match="3D-only"):
        tp.runner(f, method="pallas_tiled")
    with pytest.raises(ValueError, match="unknown Poisson method"):
        tp.runner(f, method="rma")
    with pytest.raises(ValueError, match="source shape"):
        tp.runner(np.zeros((4, 4)), method="xla")
    with pytest.raises(ValueError, match="sharded Poisson is 3D-only"):
        tp.sharded_runner(f, mesh=None)
    # autotune tunes the 3D tiled runner on a card; the slab runner keeps
    # the chooser's plan and records no ignored flag
    r = tp.runner(f, method="slab", sweeps_per_call=2, autotune="force")
    assert "ignored" not in r.plan_info and "source" not in r.plan_info
    tp3 = poisson.PoissonProblem(shape=(8, 8, 8), device="cpu")
    with pytest.raises(ValueError, match="2D-only"):
        tp3.runner(np.zeros((8, 8, 8)), method="pallas_slab")


def test_poisson_device_source_scales_on_device(rng):
    """A torch source is scaled in the problem dtype, as JAX scales a
    device array."""
    shape = (10, 12)
    jp, tp = _pair(shape)
    f = rng.normal(size=shape).astype(np.float32)
    import jax.numpy as jnp

    want = jp.runner(jnp.asarray(f), method="xla").iterate(
        jp.initial_grid(), 5)
    got = tp.runner(torch.from_numpy(f), method="xla").iterate(
        tp.initial_grid(), 5)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=1e-6,
                               rtol=1e-6)


def test_heat_matches_jax():
    for kw in ({}, {"dt": 0.1}, {"alpha": 2.0, "h": 0.5, "dt": 0.02}):
        for shape in ((8, 8), (6, 6, 6)):
            j = jheat.HeatDiffusion(shape, **kw)
            t = heat.HeatDiffusion(shape, device="cpu", **kw)
            assert t.fourier == j.fourier
            assert _taps(t.spec) == _taps(j.spec)
            np.testing.assert_array_equal(t.initial_grid().data.numpy(),
                                          np.asarray(j.initial_grid().data))
    with pytest.raises(ValueError, match="unstable"):
        heat.HeatDiffusion((8, 8), dt=0.5, device="cpu").spec
    with pytest.raises(ValueError, match="unstable"):
        jheat.HeatDiffusion((8, 8), dt=0.5).spec
    lr, jlr = heat.LaplaceRelaxation((8, 10), radius=2, device="cpu"), \
        jheat.LaplaceRelaxation((8, 10), radius=2)
    assert _taps(lr.spec) == _taps(jlr.spec)
    np.testing.assert_array_equal(lr.initial_grid().data.numpy(),
                                  np.asarray(jlr.initial_grid().data))


def test_heat_initial_interior_matches_jax(rng):
    x = rng.random((6, 7)).astype(np.float32)
    j = jheat.HeatDiffusion((6, 7), dt=0.1).initial_grid(x)
    t = heat.HeatDiffusion((6, 7), dt=0.1, device="cpu").initial_grid(x)
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


@pytest.mark.parametrize("check_every", [25, 40])
def test_solver_matches_jax(check_every):
    """Same runner semantics, same chunking: the same number of sweeps,
    and residuals within fp32 rounding of each other."""
    from stencil_tpu import registry as jregistry
    from stencil_tpu_torch import registry

    shape = (16, 16)
    jl = jheat.LaplaceRelaxation(shape)
    tl = heat.LaplaceRelaxation(shape, device="cpu")
    jr = jregistry.get_runner("xla", None, jl.spec, jl.initial_grid())
    tr = registry.get_runner("slab", None, tl.spec, tl.initial_grid())
    want = jsolver.solve(jr, jl.initial_grid(), tolerance=1e-3,
                         max_iterations=2000, check_every=check_every)
    msgs = []
    got = solver.solve(tr, tl.initial_grid(), tolerance=1e-3,
                       max_iterations=2000, check_every=check_every,
                       progress=msgs.append)
    assert (got.iterations, got.converged) == (want.iterations,
                                               want.converged)
    assert abs(got.residual - want.residual) < 1e-6
    assert len(msgs) == got.iterations // check_every
    assert got.summary().startswith("converged")


def test_solver_rounds_chunks_to_granularity():
    """A k=4 runner with check_every=10 runs chunks of 12; the last chunk
    is cut to the budget."""
    tp = poisson.PoissonProblem(shape=(8, 8), device="cpu")
    r = tp.runner(np.ones((8, 8)), method="slab", sweeps_per_call=4)
    seen = []
    res = solver.solve(r, tp.initial_grid(), tolerance=0.0,
                       max_iterations=30, check_every=10,
                       progress=seen.append)
    assert not res.converged and res.iterations == 30
    assert [s.split(":")[0] for s in seen] == ["sweep 12", "sweep 24",
                                               "sweep 30"]


def test_convert_round_trip(rng):
    """A JAX PoissonProblem carried across gives the same source scale,
    operator taps and runner output (the source f goes across as numpy)."""
    shape = (8, 10, 12)
    jp = jpoisson.PoissonProblem(shape=shape, h=0.07)
    tp = convert.poisson_from_arrays(jp.shape, jp.h, jp.bc.values,
                                     jp.bc.periodic, jp.bc.neumann,
                                     jp.dtype, device="cpu")
    assert isinstance(tp, poisson.PoissonProblem)
    assert tp.source_scale == jp.source_scale
    assert _taps(tp.operator_spec) == _taps(jp.operator_spec)
    f = rng.normal(size=shape)
    want = jp.runner(f).iterate(jp.initial_grid(), 6)
    got = tp.runner(f).iterate(tp.initial_grid(), 6)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=1e-6,
                               rtol=1e-6)
    bc = convert.bc_from_arrays(((0.0, 1.0), (2.0, 3.0)), (True, False),
                                (False, True))
    assert bc.periodic == (True, False) and bc.neumann == (False, True)
