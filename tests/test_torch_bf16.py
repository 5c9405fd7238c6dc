"""The port's bfloat16 paths against the JAX package's, on the CPU: the
eager sweep (ops/eager.py vs ops/xla.py), ``convert`` of bf16 grids, the
plain versions of both kernels in bf16 (``TiledStencil``/``SlabStencil``
vs the TPU kernels at dtype=bfloat16 in interpret mode), the source mode
(the Poisson runners), the leapfrog, the advection family, the multigrid
fine level on the tiled kernel, ``--solve poisson --dtype bfloat16``, and
the plans' bf16 geometry and gates. The kernels themselves are held
against their plain versions on a card by tests/test_torch_cuda.py.

Tolerances: the eager sweep bitwise against JAX's ``xla`` sweep (both
round each weight to bf16 first, then every op to bf16); the kernels'
paths within 3e-2 of JAX and of the float64 golden
(tests/test_pallas_tiled.py's bf16 bar: bf16 has an 8-bit significand);
the source mode within 0.15 (tests/test_tiled_source.py:85-87, errors
accumulate over sweeps); the multigrid and solve paths as stated at each
test."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.cli import run_all as jrun_all
from stencil_tpu.config import RunConfig as JRunConfig
from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.models import advection as jadv
from stencil_tpu.models.poisson import PoissonProblem as JPoisson
from stencil_tpu.models import wave as jwave
from stencil_tpu.ops import xla
from stencil_tpu.ops.pallas import PallasStencil
from stencil_tpu.ops.pallas_tiled import TiledPallasStencil
from stencil_tpu_torch import cli, convert
from stencil_tpu_torch.config import RunConfig
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.models import advection as tadv
from stencil_tpu_torch.ops import eager, golden
from stencil_tpu_torch.ops.eager import round_to
from stencil_tpu_torch.ops.slab import SlabStencil, make_slab_plan
from stencil_tpu_torch.ops.sweep_kernel import sweep_reference, tap_table
from stencil_tpu_torch.ops.tiled import (
    TiledStencil, choose_tiles, make_tiled_plan,
)

BF16_TOL = 3e-2
SOURCE_TOL = 0.15


def _f32(x):
    """A torch or JAX bf16 array as float32 numpy (exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _walls(ndim, periodic=(), neumann=()):
    bc = jgrid.DirichletBC.reference_default(ndim)
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    return bc


def _both(rng, name, shape, bc=None, scale=1.0):
    """The same random bf16 grid in both packages; the port's spec."""
    j = jspec.get_spec(name)
    t = convert.spec_from_arrays(j.name, j.offsets, j.weights, j.radius)
    x = (rng.random(shape) * scale).astype(np.float32)
    jbc = bc if bc is not None else _walls(len(shape))
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x, jnp.bfloat16),
                                      halo=j.radius, bc=jbc)
    tg = convert.grid_from_arrays(np.asarray(jg.data), jg.halo,
                                  jg.bc.values, jg.bc.periodic,
                                  jg.bc.neumann, device="cpu")
    return j, t, jg, tg


# ---- the eager sweep: bitwise JAX's xla sweep (repair of the weights) ------

SPECS = ["jacobi5", "jacobi7", "jacobi9", "jacobi27", "laplace3d_ho",
         "star3d_r2"]


@pytest.mark.parametrize("name", SPECS)
def test_eager_bf16_matches_jax_bitwise(rng, name):
    """One ``apply_spec`` and 5 ``iterate`` sweeps on Dirichlet, periodic
    and Neumann walls, bitwise. Before each weight was rounded to bf16,
    jacobi7, jacobi27, laplace3d_ho and star3d_r2 differed (the port
    multiplied by the weight at fp32 precision; JAX by bf16(w))."""
    nd = jspec.get_spec(name).ndim
    shape = (16, 18, 20) if nd == 3 else (30, 34)
    for bc in (_walls(nd), _walls(nd, (0,), (1,)), _walls(nd, (), (0, 1))):
        j, t, jg, tg = _both(rng, name, shape, bc)
        one_j = xla.apply_spec(jg.data, j, halo=jg.halo)
        one_t = eager.apply_spec(tg.data, t, halo=tg.halo)
        assert one_t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(one_t), _f32(one_j))
        want = xla.iterate(jg, j, 5)
        got = eager.iterate(tg, t, 5)
        np.testing.assert_array_equal(_f32(got.interior()),
                                      _f32(want.interior()))


def test_cli_bf16_check_errors_agree():
    """``-m xla --dtype bfloat16 -c`` at 24x20x28, 9 iterations: the two
    CLIs' ``-c`` (``check_method`` on the grid and runner their
    ``run_all`` makes) report the same max abs error against the float64
    golden (7.548e-03; the port reported 4.257e-03 before the repair).
    The CLIs' timing runs are left out."""
    from stencil_tpu import cli as jcli
    from stencil_tpu import registry as jregistry
    from stencil_tpu_torch import registry

    kw = dict(size=(24, 20, 28), iterations=9, spec="jacobi7",
              methods=("xla",), dtype="bfloat16", check=True)
    results = []
    for c, reg, config in ((jcli, jregistry, JRunConfig(**kw)),
                           (cli, registry, RunConfig(device="cpu", **kw))):
        spec = config.resolved_spec()
        runner = reg.get_runner("xla", config, spec,
                                c.make_grid(config, spec))
        chk, iters = c.check_method(config, spec, runner)
        assert chk.ok and iters == 9
        results.append(chk.max_abs_err)
    assert results[1] == results[0]
    np.testing.assert_allclose(results[0], 7.548e-03, rtol=1e-3)


def test_round_to_is_the_dtype_rounding():
    assert round_to(1.0 / 6.0, "bfloat16") == 0.1669921875
    assert round_to(1.0 / 6.0, torch.float32) == float(np.float32(1 / 6))
    assert round_to(1.0 / 6.0, "float64") == 1.0 / 6.0
    # the kernels' host tables carry the bf16 values (exact in float32)
    _, _, weights, uniform, uw = tap_table(
        convert.spec_from_arrays("jacobi7", *_spec_arrays("jacobi7")),
        "bfloat16")
    assert uniform and uw == 0.1669921875


def _spec_arrays(name):
    j = jspec.get_spec(name)
    return j.offsets, j.weights, j.radius


# ---- convert: a JAX bf16 grid bit for bit (repair) -------------------------


def test_convert_bf16_grid_round_trip(rng):
    bc = _walls(3, (0,), (1,))
    x = rng.normal(size=(6, 7, 8)).astype(np.float32) * 1e3
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x, jnp.bfloat16), halo=2,
                                      bc=bc)
    arr = np.asarray(jg.data)
    assert arr.dtype.name == "bfloat16"
    tg = convert.grid_from_arrays(arr, jg.halo, jg.bc.values,
                                  jg.bc.periodic, jg.bc.neumann,
                                  device="cpu")
    assert tg.dtype == torch.bfloat16 and tg.halo == 2
    assert tg.bc.periodic_mask(3) == (True, False, False)
    assert tg.bc.neumann_mask(3) == (False, True, False)
    bits = tg.data.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(bits, arr.view(np.uint16))
    back = jnp.asarray(_f32(tg.data)).astype(jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(back).view(np.uint16),
                                  arr.view(np.uint16))
    # float32 arrays go across as before
    f = convert.tensor_from_array(x, device="cpu")
    assert f.dtype == torch.float32 and np.array_equal(f.numpy(), x)


# ---- the 3D tiled kernel's plain version in bf16 vs JAX interpret ---------


@pytest.mark.parametrize("name,k,periodic,neumann", [
    ("jacobi7", 3, (), ()), ("jacobi7", 2, (0, 1), ()),
    ("jacobi7", 4, (), (0, 1)), ("jacobi27", 2, (), ()),
    ("jacobi27", 2, (0, 1), ()), ("laplace3d_ho", 2, (), (0, 1))])
def test_tiled_bf16_matches_jax_interpret_and_golden(rng, name, k, periodic,
                                                     neumann):
    """Ragged 13x17x19, 2k iterations (two launches), tiles (8, 16) on the
    JAX side (t1 a multiple of bf16's sublane, 16): the port's plain
    version within 3e-2 of the TPU kernel in interpret mode and of the
    float64 golden; on the CPU it is the eager iterate (bitwise, Dirichlet
    and periodic walls). Against JAX it is bitwise for the star specs,
    whose taps the TPU kernel sums one by one; jacobi27 differs in ~60% of
    its points by a bf16 ulp or two, the TPU kernel evaluating the uniform
    box as (box sum - centre)*w (pallas_tiled.py:1030-1076)."""
    shape = (13, 17, 19)
    bc = _walls(3, periodic, neumann)
    j, t, jg, tg = _both(rng, name, shape, bc)
    iters = 2 * k
    want = TiledPallasStencil(j, shape, "bfloat16", sweeps_per_call=k,
                              tiles=(8, 16), interpret=True).iterate(jg,
                                                                     iters)
    stencil = TiledStencil(t, shape, "bfloat16", sweeps_per_call=k,
                           device="cpu")
    assert stencil.plan.dtype == "bfloat16" and stencil.plan.itemsize == 2
    got = stencil.iterate(tg, iters)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got.interior()), _f32(want.interior()),
                               atol=BF16_TOL, rtol=BF16_TOL)
    if name != "jacobi27":
        np.testing.assert_array_equal(_f32(got.interior()),
                                      _f32(want.interior()))
    ref = golden.golden_iterate(_f32(tg.interior()).astype(np.float64), t,
                                iters, bc=tg.bc)
    np.testing.assert_allclose(_f32(got.interior()), ref, atol=BF16_TOL,
                               rtol=BF16_TOL)
    if not neumann:
        assert torch.equal(got.data, eager.iterate(tg, t, iters).data)


def test_tiled_bf16_plain_version_is_the_launch(rng):
    """One launch of the plain version in bf16 equals k eager bf16 sweeps
    with the ghosts held (the rule the kernel's bf16 entry follows)."""
    shape = (9, 10, 11)
    j, t, jg, tg = _both(rng, "jacobi27", shape)
    plan = make_tiled_plan(t, shape, "bfloat16", 3)
    cur = plan.layout.pad_grid(tg)
    got = plan.layout.unpad(sweep_reference(cur, plan))
    want = eager.iterate(tg, t, 3).interior()
    assert torch.equal(got, want)


# ---- the 2D slab kernel's plain version in bf16 vs JAX interpret ----------


@pytest.mark.parametrize("name,shape,k,periodic", [
    ("jacobi5", (32, 40), 2, ()), ("jacobi9", (32, 40), 2, ()),
    ("jacobi5", (32, 40), 2, (0,)), ("jacobi9", (48, 40), 3, (0,))])
def test_slab_bf16_matches_jax_interpret_and_golden(rng, name, shape, k,
                                                    periodic):
    """tests/test_pallas.py:159-170's case (jacobi5 32x40 k=2, 4
    iterations) and jacobi9, also with a periodic d0: within 3e-2 of the
    TPU slab kernel in interpret mode and of the float64 golden; bitwise
    for jacobi5 (jacobi9's box the TPU kernel sums in another order)."""
    bc = _walls(2, periodic)
    j, t, jg, tg = _both(rng, name, shape, bc)
    want = PallasStencil(j, shape, "bfloat16", sweeps_per_call=k,
                         interpret=True).iterate(jg, 2 * k)
    got = SlabStencil(t, shape, "bfloat16", sweeps_per_call=k,
                      device="cpu").iterate(tg, 2 * k)
    np.testing.assert_allclose(_f32(got.interior()), _f32(want.interior()),
                               atol=BF16_TOL, rtol=BF16_TOL)
    if name == "jacobi5":
        np.testing.assert_array_equal(_f32(got.interior()),
                                      _f32(want.interior()))
    ref = golden.golden_iterate(_f32(tg.interior()).astype(np.float64), t,
                                2 * k, bc=tg.bc)
    np.testing.assert_allclose(_f32(got.interior()), ref, atol=BF16_TOL,
                               rtol=BF16_TOL)
    assert torch.equal(got.data, eager.iterate(tg, t, 2 * k).data)


# ---- the source mode: the Poisson runners in bf16 --------------------------


@pytest.mark.parametrize("shape,k,periodic", [
    ((16, 16, 24), 2, ()), ((14, 17, 10), 3, (0,)), ((32, 40), 2, ()),
    ((48, 40), 4, (0,))])
def test_poisson_bf16_runner_matches_jax(rng, shape, k, periodic):
    """``PoissonProblem(dtype="bfloat16").runner(method="auto")`` (the
    tiled source mode in 3D, the slab's in 2D) over k iterations within
    0.15 of JAX's, the TPU kernel in interpret mode, and of the float64
    golden with the source; the padded source is scaled in bf16."""
    nd = len(shape)
    bc = jgrid.DirichletBC.zero(nd)
    if periodic:
        bc = bc.with_periodic(periodic)
    jp = JPoisson(shape=shape, bc=bc, dtype="bfloat16")
    tp = convert.poisson_from_arrays(jp.shape, jp.h, bc.values, bc.periodic,
                                     bc.neumann, "bfloat16", device="cpu")
    u0 = rng.random(shape).astype(np.float32)
    f = rng.normal(size=shape).astype(np.float32)
    iters = k
    jr = jp.runner(f, method="pallas_tiled" if nd == 3 else "pallas_slab",
                   sweeps_per_call=k, interpret=True)
    want = jr.iterate(jp.initial_grid(jnp.asarray(u0, jnp.bfloat16)), iters)
    tr = tp.runner(f, method="auto", sweeps_per_call=k)
    assert tr.plan_info["kernel"] == ("tiled" if nd == 3 else "slab")
    got = tr.iterate(tp.initial_grid(u0), iters)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got.interior()), _f32(want.interior()),
                               atol=SOURCE_TOL)
    u0b = _f32(torch.from_numpy(u0).to(torch.bfloat16)).astype(np.float64)
    ref = golden.golden_iterate(u0b, tp.spec, iters, bc=tp.bc, source=f,
                                source_scale=tp.source_scale)
    np.testing.assert_allclose(_f32(got.interior()), ref, atol=SOURCE_TOL)


def test_pad_source_scales_in_the_plan_dtype(rng):
    """JAX's ``pad_source``: bf16(source) * bf16(scale), one bf16 product;
    the port's interior is that, bit for bit."""
    from stencil_tpu.ops.pallas_tiled import make_tiled_plan as jmake
    from stencil_tpu.ops.pallas_tiled import pad_source as jpad
    from stencil_tpu_torch.ops.layout import pad_source

    shape = (6, 7, 9)
    f = rng.normal(size=shape)
    scale = -(1.0 / 7) ** 2 / 6
    jplan = jmake(jspec.get_spec("jacobi7"), shape, "bfloat16", 2,
                  tiles=(6, 7), has_source=True)
    want = jplan.layout.unpad(jpad(jplan, f, scale, _walls(3)))
    plan = make_tiled_plan(convert.spec_from_arrays(
        "jacobi7", *_spec_arrays("jacobi7")), shape, "bfloat16", 2)
    got = plan.layout.unpad(pad_source(plan, f, scale, _walls(3)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))


# ---- the leapfrog and the advection family in bf16 -------------------------


@pytest.mark.parametrize("k,periodic,neumann", [(3, (), ()),
                                                (2, (0,), (1,))])
def test_wave_bf16_tiled_matches_jax(rng, k, periodic, neumann):
    """The two-level mode's plain version in bf16: 2k steps against JAX's
    tiled leapfrog in interpret mode and the port's eager leapfrog, 3e-2
    (the remainder launch is held bitwise on the card)."""
    shape = (10, 17, 14)
    jbc = jgrid.DirichletBC.zero(3)
    if periodic:
        jbc = jbc.with_periodic(periodic)
    if neumann:
        jbc = jbc.with_neumann(neumann)
    jw = jwave.WaveEquation(shape=shape, bc=jbc, dtype="bfloat16")
    tw = convert.wave_from_arrays(shape, jw.c, jw.h, jw.dt, jbc.values,
                                  jbc.periodic, jbc.neumann, "bfloat16",
                                  device="cpu")
    u0 = rng.normal(size=shape)
    jprev, jcur = jw.initial_pair(u0)
    tprev, tcur = tw.initial_pair(u0)
    np.testing.assert_array_equal(_f32(tcur.interior()),
                                  _f32(jcur.interior()))
    _, want = jw.simulate(jprev, jcur, 2 * k, method="pallas_tiled",
                          sweeps_per_call=k, interpret=True, tiles=(8, 16))
    _, got = tw.simulate(tprev, tcur, 2 * k, method="tiled",
                         sweeps_per_call=k)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got.interior()), _f32(want.interior()),
                               atol=BF16_TOL, rtol=BF16_TOL)
    _, ref = tw.simulate(tprev, tcur, 2 * k, method="eager")
    np.testing.assert_allclose(_f32(got.interior()), _f32(ref.interior()),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_advection_bf16_matches_jax(rng):
    """JAX's ``Advection`` has no dtype gate: its upwind spec on a box
    periodic in d0 and d1 runs the tiled kernel in bf16. The port's plain
    version at k=4 over 8 steps within 3e-2 of JAX's interpret-mode
    kernel."""
    shape = (12, 17, 14)
    velocity = (0.5, -0.25, 0.125)
    jbc = _walls(3, (0, 1))
    ja = jadv.Advection(shape=shape, velocity=velocity, bc=jbc,
                        dtype="bfloat16")
    ta = tadv.Advection(shape=shape, velocity=velocity,
                        bc=convert.bc_from_arrays(jbc.values, jbc.periodic,
                                                  jbc.neumann),
                        dtype="bfloat16", device="cpu")
    u0 = rng.random(shape).astype(np.float32)
    want = TiledPallasStencil(ja.spec, shape, "bfloat16", sweeps_per_call=4,
                              tiles=(8, 16), interpret=True).iterate(
        ja.initial_grid(u0), 8)
    tg = ta.initial_grid(u0)
    assert tg.dtype == torch.bfloat16
    got = TiledStencil(ta.spec, shape, "bfloat16", sweeps_per_call=4,
                       device="cpu").iterate(tg, 8)
    np.testing.assert_allclose(_f32(got.interior()), _f32(want.interior()),
                               atol=BF16_TOL, rtol=BF16_TOL)


# ---- the multigrid fine level and --solve poisson in bf16 ------------------


@pytest.mark.parametrize("smoother,nu", [("chebyshev", 2), ("wjacobi", 4)])
def test_multigrid_bf16_tiled_fine_matches_jax(smoother, nu):
    """``Multigrid(PoissonProblem(dtype="bfloat16"),
    fine_method="pallas_tiled")`` at 15^3, V(nu,nu) (the dual mode with
    the Chebyshev or the source mode, in bf16), against JAX's cycle with
    its XLA fine level: JAX's tiled fine level refuses 15^3 in bf16 (its
    16-bit lane_roll needs an even sublane extent) and takes 7 s per
    3-cycle run at 31^3 in interpret mode. The first cycle's update norm
    max |u_1 - u_0| within rtol 0.05 of JAX's; later cycles move u by a
    few bf16 ulps of 7.8e-3 at |u| = 1 (the rounding floor, where the two
    fine levels' sums round apart), held under 0.2 on both sides; after 2
    cycles the error against the exact solution under 2x JAX's + 3e-2."""
    from stencil_tpu.multigrid import Multigrid as JMultigrid
    from stencil_tpu.models.poisson import manufactured_sine
    from stencil_tpu_torch.multigrid import Multigrid

    shape = (15, 15, 15)
    f, u = manufactured_sine(shape)
    f = f.astype(np.float32)
    jp = JPoisson(shape=shape, dtype="bfloat16")
    tp = convert.poisson_from_arrays(shape, jp.h, jp.bc.values,
                                     dtype="bfloat16", device="cpu")
    kw = dict(smoother=smoother, nu1=nu, nu2=nu)
    jrun = JMultigrid(jp, **kw).runner(f)
    trun = Multigrid(tp, fine_method="pallas_tiled", **kw).runner(f)
    assert trun.plan_info["fine_method"] == "pallas_tiled"
    jg, tg = jp.initial_grid(), tp.initial_grid()
    for cycle in range(2):
        jn, tn = jrun.iterate(jg, 1), trun.iterate(tg, 1)
        assert tn.dtype == torch.bfloat16
        ju = float(np.max(np.abs(_f32(jn.interior()) - _f32(jg.interior()))))
        tu = float(np.max(np.abs(_f32(tn.interior()) - _f32(tg.interior()))))
        if cycle == 0:
            np.testing.assert_allclose(tu, ju, rtol=0.05)
        else:
            assert tu < 0.2 and ju < 0.2
        jg, tg = jn, tn
    err_t = np.max(np.abs(_f32(tg.interior()) - u))
    err_j = np.max(np.abs(_f32(jg.interior()) - u))
    assert err_t < 2 * err_j + BF16_TOL


def test_solve_poisson_bf16_tiled_fine_record_matches_jax():
    """``--solve poisson --dtype bfloat16 --fine-method pallas_tiled``
    (PCG, weighted-Jacobi V(2,2) on the tiled fine level: the source and
    dual modes in bf16) at 15^3, tol 1e-2, against JAX's record with its
    XLA fine level (its tiled one refuses 15^3 in bf16, see above): JAX's
    keys, plan but the fine level, convergence and iteration count (3);
    the error against the exact solution under 0.05, six bf16 ulps at
    |u| = 1 (JAX's own is 2.8e-2; 3 h^2 = 1.2e-2 is below bf16's
    floor)."""
    kw = dict(solve="poisson", size=(15, 15, 15), iterations=30,
              tolerance=1e-2, check=True, dtype="bfloat16")
    with open(os.devnull, "w") as out:
        (want,) = jrun_all(JRunConfig(fine_method="xla", **kw), out=out)
    (got,) = cli.run_all(RunConfig(device="cpu", fine_method="pallas_tiled",
                                   **kw), out=io.StringIO())
    assert set(want) <= set(got), set(want) - set(got)
    assert got["plan"] == dict(want["plan"], fine_method="pallas_tiled")
    assert got["dtype"] == want["dtype"] == "bfloat16"
    assert got["converged"] and want["converged"]
    assert got["iterations"] == want["iterations"]
    assert got["check"]["error_vs_exact"] < 0.05


def test_solve_default_fine_level_keeps_the_fp32_gate(monkeypatch):
    """The default chooser picks the tiled fine level only for fp32, as
    JAX's (solve_cli.py:146)."""
    from stencil_tpu_torch import solve_cli
    from stencil_tpu_torch.config import parse_args

    monkeypatch.setattr(solve_cli, "_on_cuda", lambda config: True)
    base = ["--solve", "poisson", "-s", "63", "63", "63", "--smoother",
            "chebyshev"]
    assert solve_cli._resolve_fine_method(parse_args(base), None) \
        == "pallas_tiled"
    assert solve_cli._resolve_fine_method(
        parse_args(base + ["--dtype", "bfloat16"]), None) == "xla"


# ---- plans and gates ------------------------------------------------------


def test_coeff_mode_refuses_bf16_with_jax_message():
    from stencil_tpu.ops.pallas_tiled import make_tiled_plan as jmake

    kw = dict(coeff_scales=(0.1, 1.0, -0.1))
    with pytest.raises(ValueError, match="4-byte dtype") as jerr:
        jmake(jspec.get_spec("jacobi7"), (16, 16, 16), "bfloat16",
              tap_mode="coeff", **kw)
    with pytest.raises(ValueError) as terr:
        make_tiled_plan(convert.spec_from_arrays(
            "jacobi7", *_spec_arrays("jacobi7")), (16, 16, 16), "bfloat16",
            **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name,shape,k", [
    ("jacobi7", (256, 256, 256), 8), ("laplace3d_ho", (384, 384, 384), 4),
    ("jacobi27", (57, 50, 46), 3), ("jacobi5", (512, 512), 16),
    ("jacobi9", (4096, 4096), 4)])
def test_bf16_windows_take_half_the_shared_memory(name, shape, k):
    """For the same tiles a bf16 plan's windows (or rings) take half the
    bytes of a fp32 plan's; the bf16 chooser of the plan's schedule picks a
    tile that fits, and both cfg4 plans (laplace3d_ho 384^3 k=4, radius 2)
    fit one block."""
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.ops.tiled import SMEM_LIMIT, choose_march_tiles

    sp = get_spec(name)
    make = make_tiled_plan if len(shape) == 3 else make_slab_plan
    p32 = make(sp, shape, "float32", k)
    p16 = make(sp, shape, "bfloat16", k, tiles=p32.tiles)
    assert p16.smem_bytes * 2 == p32.smem_bytes
    assert p16.itemsize == 2 and p32.itemsize == 4
    chosen = make(sp, shape, "bfloat16", k)
    assert chosen.smem_bytes <= SMEM_LIMIT
    if len(shape) == 3:
        chooser = (choose_march_tiles if chosen.schedule == "march"
                   else choose_tiles)
        assert chooser(sp, shape, k, dtype="bfloat16") == chosen.tiles


def test_varcoeff_bf16_takes_the_eager_field_sweep_as_jax():
    """JAX's ``-m varcoeff`` in bf16 takes its XLA field sweep (the coeff
    kernel needs a 4-byte dtype): so does the port's, through ``auto``."""
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.registry import get_runner

    cfg = RunConfig(size=(12, 10, 14), spec="jacobi7", temporal=3,
                    methods=("varcoeff",), dtype="bfloat16", device="cpu")
    grid = tgrid.HaloGrid.create(cfg.size, halo=1, dtype="bfloat16",
                                 device="cpu")
    runner = get_runner("varcoeff", cfg, get_spec("jacobi7"), grid)
    assert runner.plan_info["kernel"] == "eager"
    out = runner.iterate(grid, 3)
    assert out.dtype == torch.bfloat16
