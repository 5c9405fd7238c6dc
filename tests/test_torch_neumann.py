"""Neumann (mirror) and mixed periodic/Neumann walls on the sweep kernels of
the port and on the model families that run them: the tiled and slab
iterates, the source mode (Poisson), the two-level mode (the wave) and the
coefficient mode (heterogeneous diffusion), each through its plain version
against the JAX package (its kernels in interpret mode, as
tests/test_neumann.py, test_tiled_source.py, test_wave_tiled.py and
test_varcoeff.py run them) and against the float64 golden; and the
mirror-symmetry gate with JAX's messages. The kernels themselves are held
against their plain versions on a card by tests/test_torch_cuda.py.

Tolerances: port vs JAX allclose at 1e-5 (fp32; the TPU kernels may sum
in another order; the coefficient mode 5e-5, JAX's bar, as its face means
are formed in another order); port vs the float64 golden at 5e-6 (the
reference suite's bar; the coefficient mode 5e-5, the wave 5e-4 over its
steps, JAX's bars)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.models import diffusion as jdiff
from stencil_tpu.models import poisson as jpoisson
from stencil_tpu.models import wave as jwave
from stencil_tpu.ops.pallas import PallasStencil
from stencil_tpu.ops.pallas_tiled import TiledPallasStencil
from stencil_tpu_torch import cli, convert
from stencil_tpu_torch.config import parse_args
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.models import diffusion as tdiff
from stencil_tpu_torch.models import poisson as tpoisson
from stencil_tpu_torch.models import wave as twave
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.slab import SlabStencil
from stencil_tpu_torch.ops.tiled import TiledStencil
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

TOL_JAX = 1e-5
TOL_GOLDEN = 5e-6
# asymmetric in dim 1 (one-sided tap), symmetric in dims 0 and 2
ASYM3D = [((0, 0, 0), 0.4), ((-1, 0, 0), 0.1), ((1, 0, 0), 0.1),
          ((0, -1, 0), 0.2), ((0, 0, -1), 0.1), ((0, 0, 1), 0.1)]
ASYM2D = [((0, 0), 0.5), ((-1, 0), 0.3), ((0, 1), 0.1), ((0, -1), 0.1)]


def _bcs(ndim, periodic=(), neumann=(), zero=False):
    base = jgrid.DirichletBC.zero(ndim) if zero \
        else jgrid.DirichletBC.reference_default(ndim)
    jbc = base.with_periodic(periodic).with_neumann(neumann)
    return jbc, convert.bc_from_arrays(jbc.values, jbc.periodic,
                                       jbc.neumann)


def _specs(name_or_taps, ndim):
    if isinstance(name_or_taps, str):
        return jspec.get_spec(name_or_taps), tspec.get_spec(name_or_taps)
    return (jspec.weighted(ndim, name_or_taps),
            tspec.weighted(ndim, name_or_taps))


def check_kernel(name, shape, k, iters, rng, periodic=(), neumann=(),
                 jax_too=True, source=False):
    """The port's iterate (the tiled kernel in 3D, the slab kernel in 2D)
    against the float64 golden and, with ``jax_too``, the TPU kernel in
    interpret mode."""
    ndim = len(shape)
    jsp, sp = _specs(name, ndim)
    jbc, tbc = _bcs(ndim, periodic, neumann)
    x = rng.random(shape).astype(np.float32)
    f = rng.normal(size=shape).astype(np.float32) if source else None
    kw = dict(source=f, source_scale=-0.04) if source else {}
    stencil = TiledStencil if ndim == 3 else SlabStencil
    tg = tgrid.HaloGrid.from_interior(torch.from_numpy(x), halo=sp.radius,
                                      bc=tbc, device="cpu")
    got = stencil(sp, shape, sweeps_per_call=k, device="cpu", **kw) \
        .iterate(tg, iters)
    ref = golden.golden_iterate(x, sp, iters, bc=tbc, source=f,
                                source_scale=-0.04)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=TOL_GOLDEN, rtol=0)
    if jax_too:
        jg = jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=sp.radius,
                                          bc=jbc)
        jcls = TiledPallasStencil if ndim == 3 else PallasStencil
        want = jcls(jsp, shape, sweeps_per_call=k, interpret=True,
                    tap_mode="slice", **kw).iterate(jg, iters)
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   atol=TOL_JAX, rtol=0)


# ---- the tiled kernel -------------------------------------------------------


@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
@pytest.mark.parametrize("k", [1, 4])
def test_tiled_neumann_leading_dims_match_jax(rng, dims, k):
    check_kernel("jacobi7", (12, 16, 18), k, 2 * k, rng, neumann=dims)


@pytest.mark.parametrize("name,shape,k", [("jacobi27", (16, 24, 20), 4),
                                          ("laplace3d_ho", (14, 18, 16), 3),
                                          ("jacobi7", (13, 17, 19), 4)])
def test_tiled_neumann_box_r2_ragged_match_golden(rng, name, shape, k):
    """Box corners, radius-2 mirrors and clamped ragged tiles, two
    launches and a remainder."""
    check_kernel(name, shape, k, 2 * k + 1, rng, neumann=(0, 1),
                 jax_too=False)


def test_tiled_mixed_periodic_neumann_matches_jax(rng):
    """Periodic d0 and Neumann d1 on the box stencil: its corner ghosts
    are live only where both faces are, and right only through the
    refresh order (d0 wrapped over d1's mirror) and the mirror gate."""
    check_kernel("jacobi27", (12, 16, 18), 3, 6, rng, periodic=(0,),
                 neumann=(1,))


@pytest.mark.parametrize("name", ["jacobi27", "laplace3d_ho"])
def test_tiled_neumann_lane_k1_matches_golden(rng, name):
    check_kernel(name, (12, 16, 20), 1, 4, rng, neumann=(2,),
                 periodic=(0,), jax_too=False)


def test_neumann_asymmetric_gates_match_jax():
    """At k>1 a Neumann dim needs taps mirror-symmetric in it: the tiled
    and slab iterates and the registry refuse with JAX's messages."""
    from stencil_tpu import registry as jregistry
    from stencil_tpu.config import RunConfig as JRunConfig
    from stencil_tpu_torch import registry
    from stencil_tpu_torch.config import RunConfig

    for taps, shape, jcls, tcls in ((ASYM3D, (16, 16, 16),
                                     TiledPallasStencil, TiledStencil),
                                    (ASYM2D, (16, 16), PallasStencil,
                                     SlabStencil)):
        ndim = len(shape)
        jsp, sp = _specs(taps, ndim)
        d = 1 if ndim == 3 else 0
        jbc, tbc = _bcs(ndim, neumann=(d,), zero=True)
        with pytest.raises(ValueError) as want:
            jcls(jsp, shape, sweeps_per_call=4, interpret=True,
                 tap_mode="slice").iterate(
                jgrid.HaloGrid.create(shape, bc=jbc), 4)
        with pytest.raises(ValueError) as got:
            tcls(sp, shape, sweeps_per_call=4, device="cpu").iterate(
                tgrid.HaloGrid.create(shape, bc=tbc, device="cpu"), 4)
        assert str(got.value) == str(want.value)
        assert "mirror-symmetric" in str(got.value)
        # the registry's own message (raised when the runner is made)
        with pytest.raises(ValueError) as want:
            jregistry.get_runner(
                "pallas_temporal", JRunConfig(size=shape, temporal=4),
                jsp, jgrid.HaloGrid.create(shape, bc=jbc))
        with pytest.raises(ValueError) as got:
            registry.get_runner(
                "pallas_temporal", RunConfig(size=shape, temporal=4,
                                             device="cpu"),
                sp, tgrid.HaloGrid.create(shape, bc=tbc, device="cpu"))
        assert str(got.value) == str(want.value)


def test_neumann_asymmetric_runs_at_k1_and_on_symmetric_dims(rng):
    """The same spec at k=1 on its asymmetric dim, and at k=4 on a dim
    it is symmetric in."""
    check_kernel(ASYM3D, (12, 16, 18), 1, 5, rng, neumann=(1,),
                 jax_too=False)
    check_kernel(ASYM3D, (12, 16, 18), 4, 9, rng, neumann=(0,),
                 jax_too=False)


# ---- the slab kernel --------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_slab_neumann_lead_matches_jax(rng, k):
    check_kernel("jacobi9", (24, 40), k, 2 * k, rng, neumann=(0,))


def test_slab_neumann_ragged_and_lane_match_golden(rng):
    check_kernel("star2d_r2", (250, 333), 3, 7, rng, neumann=(0,),
                 jax_too=False)
    check_kernel("jacobi9", (250, 333), 1, 3, rng, neumann=(0, 1),
                 jax_too=False)
    check_kernel(ASYM2D, (40, 24), 1, 3, rng, neumann=(0,), jax_too=False)


# ---- the source mode (Poisson) ----------------------------------------------


def test_tiled_source_periodic_neumann_matches_jax(rng):
    """The source mode with periodic d0 and Neumann d1 (the source's ghosts
    wrapped and mirrored once, to full depth)."""
    check_kernel("jacobi7", (12, 16, 18), 2, 4, rng, periodic=(0,),
                 neumann=(1,), source=True)


@pytest.mark.parametrize("shape,method,k", [((12, 14, 16), "tiled", 4),
                                            ((24, 40), "slab", 4)])
def test_poisson_runner_dynamic_walls_match_jax(rng, shape, method, k):
    """The Poisson runner on each kernel with periodic d0 and Neumann d1
    (2D: Neumann d0 only, the lane dim at k>1 is gated) against the JAX
    package's ``xla`` runner and the float64 golden with the source."""
    ndim = len(shape)
    periodic, neumann = ((0,), (1,)) if ndim == 3 else ((), (0,))
    jbc = jgrid.DirichletBC.zero(ndim).with_periodic(periodic) \
        .with_neumann(neumann)
    jp = jpoisson.PoissonProblem(shape=shape, bc=jbc)
    tp = convert.poisson_from_arrays(shape, jp.h, jbc.values, jbc.periodic,
                                     jbc.neumann, device="cpu")
    f = rng.normal(size=shape)
    u0 = rng.random(shape).astype(np.float32)
    runner = tp.runner(f, method=method, sweeps_per_call=k)
    assert runner.plan_info["kernel"] == method
    got = runner.iterate(tp.initial_grid(u0), 2 * k + 1)
    want = jp.runner(f, method="xla").iterate(jp.initial_grid(u0), 2 * k + 1)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=TOL_JAX,
                               rtol=0)
    ref = golden.golden_iterate(u0, tp.spec, 2 * k + 1, bc=tp.bc, source=f,
                                source_scale=tp.source_scale)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=TOL_GOLDEN, rtol=0)


# ---- the two-level mode (the wave) ------------------------------------------


@pytest.mark.parametrize("periodic,neumann", [((0,), (1,)), ((0, 1), ())])
def test_wave_dynamic_walls_match_jax(rng, periodic, neumann):
    """The tiled leapfrog (k=4 over 8 steps, both levels refreshed before
    every launch) against the JAX tiled kernel in interpret mode, the
    eager leapfrog and the float64 golden loop."""
    shape = (12, 16, 18)
    jbc = jgrid.DirichletBC.zero(3).with_periodic(periodic) \
        .with_neumann(neumann)
    jw = jwave.WaveEquation(shape=shape, bc=jbc)
    tw = convert.wave_from_arrays(shape, jw.c, jw.h, jw.dt, jbc.values,
                                  jbc.periodic, jbc.neumann, device="cpu")
    u0 = rng.normal(size=shape)
    got = tw.simulate_interior(u0, 9, method="tiled", sweeps_per_call=4)
    want = jw.simulate_interior(u0, 9, method="pallas_tiled",
                                sweeps_per_call=4, interpret=True)
    np.testing.assert_allclose(got, want, atol=TOL_JAX, rtol=0)
    np.testing.assert_allclose(
        got, tw.simulate_interior(u0, 9, method="eager"), atol=TOL_JAX,
        rtol=0)
    ref = twave.golden_wave(u0, tw.spec, 9, tw.bc)
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=0)


def test_wave_remainder_and_lane_gate(rng):
    """11 steps at k=4 (a remainder launch of 2) with Neumann d0; a
    dynamic lane dim keeps JAX's refusal."""
    shape = (10, 12, 14)
    _, tbc = _bcs(3, neumann=(0,), zero=True)
    tw = twave.WaveEquation(shape=shape, bc=tbc, device="cpu")
    u0 = rng.normal(size=shape)
    np.testing.assert_allclose(
        tw.simulate_interior(u0, 12, method="tiled", sweeps_per_call=4),
        tw.simulate_interior(u0, 12, method="eager"), atol=TOL_JAX, rtol=0)
    jbc, tbc = _bcs(3, periodic=(2,), zero=True)
    with pytest.raises(ValueError) as want:
        jwave.WaveEquation(shape=shape, bc=jbc).simulate_interior(
            u0, 3, method="pallas_tiled", interpret=True)
    with pytest.raises(ValueError) as got:
        twave.WaveEquation(shape=shape, bc=tbc, device="cpu") \
            .simulate_interior(u0, 3, method="tiled")
    assert str(got.value) == str(want.value)


# ---- the coefficient mode (heterogeneous diffusion) -------------------------


def _diffusions(shape, a, periodic=(), neumann=()):
    jbc = jgrid.DirichletBC.zero(3).with_periodic(periodic) \
        .with_neumann(neumann)
    jd = jdiff.HeterogeneousDiffusion(shape=shape, a=a, bc=jbc)
    td = convert.diffusion_from_arrays(shape, a, jd.h, jd.dt, jbc.values,
                                       jbc.periodic, jbc.neumann,
                                       device="cpu")
    return jd, td


@pytest.mark.parametrize("periodic,neumann", [((0,), (1,)), ((0, 1), ())])
def test_hetero_diffusion_dynamic_walls_match_jax(rng, periodic, neumann):
    """The coefficient mode at k=2 over 6 sweeps with dynamic leading dims
    (a(x) wrapped or mirrored once, u refreshed before every launch)
    against the TPU kernel in interpret mode and the float64 field
    golden; ``auto`` picks the kernel, as JAX's rule does."""
    shape = (10, 12, 14)
    a = rng.uniform(0.2, 3.0, size=shape)
    jd, td = _diffusions(shape, a, periodic, neumann)
    u0 = rng.normal(size=shape).astype(np.float32)
    runner = td.runner(sweeps_per_call=2)
    assert td.uses_kernel() and runner.plan_info["kernel"] == "tiled"
    before = tiled_sweep.launches
    got = runner.iterate(td.initial_grid(u0), 6)
    assert tiled_sweep.launches == before  # the plain version is no launch
    want = jd.runner(method="pallas_tiled", sweeps_per_call=2,
                     interpret=True).iterate(jd.initial_grid(u0), 6)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=5e-5,
                               rtol=0)
    offsets, fields = td.tap_fields()
    ref = golden.golden_iterate_fields(u0, offsets, fields, 6, bc=td.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize("periodic,neumann,kernel", [
    ((), (), True), ((0,), (), True), ((), (1,), True), ((0, 1), (), True),
    ((2,), (), False), ((), (2,), False), ((0,), (2,), False)])
def test_hetero_auto_rule_matches_jax(periodic, neumann, kernel):
    """``auto`` runs the coefficient kernel exactly where JAX's runs its
    Pallas kernel: dynamic leading dims included, a dynamic lane dim
    not."""
    shape = (8, 9, 10)
    jd, td = _diffusions(shape, np.ones(shape), periodic, neumann)
    assert jd.runner(interpret=True).name.startswith(
        "hetero_diffusion_pallas") == kernel
    assert td.uses_kernel() == kernel
    assert (td.runner().plan_info["kernel"] == "tiled") == kernel


def test_varcoeff_cli_dynamic_walls(rng):
    """``-m varcoeff --periodic 0 --neumann 1 -c``: the coefficient mode
    against the float64 field golden."""
    out = io.StringIO()
    (rec,) = cli.run_all(parse_args(
        ["-s", "12", "10", "14", "-i", "7", "--spec", "jacobi7", "-m",
         "varcoeff", "-k", "3", "--contrast", "30", "--periodic", "0",
         "--neumann", "1", "-c", "--device", "cpu"]), out=out)
    assert rec["check"]["ok"] and rec["plan"]["kernel"] == "tiled"
    assert rec["check"]["max_abs_err"] < 5e-5


def test_cli_neumann_checks_on_the_kernels():
    """``-c`` over every iteration on the tiled kernel (Neumann d0, d1)
    and on the slab kernel (Neumann d0), pins recorded."""
    for argv, pins in (
            (["-s", "12", "16", "20", "-i", "9", "--spec", "jacobi7", "-m",
              "pallas_temporal", "-k", "4", "--neumann", "0", "1"],
             [0, 0, 0, 0]),
            (["-s", "24", "40", "-i", "9", "--spec", "jacobi9", "-m",
              "pallas_temporal", "-k", "4", "--neumann", "0"], [0, 0])):
        (rec,) = cli.run_all(parse_args([*argv, "-c", "--device", "cpu"]),
                             out=io.StringIO())
        assert rec["check"]["ok"] and not rec["check"]["capped"]
        assert rec["plan"]["pins"] == pins
