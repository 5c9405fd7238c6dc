"""Heterogeneous FTCS diffusion (stencil_tpu_torch/models/diffusion.py:
HeterogeneousDiffusion), the eager field sweep (ops/eager.py:apply_fields),
its float64 golden (ops/golden.py:golden_iterate_fields), the plain
version of the tiled kernel's coefficient mode (ops/sweep_kernel.py,
ops/tiled.py:coeff_iterate) and the ``varcoeff`` method against the JAX
package: its field helpers, its XLA runner, its tiled Pallas kernel in
interpret mode (as tests/test_varcoeff.py runs it) and its CLI record. The
kernel itself is held against its plain version on a card by
tests/test_torch_cuda.py.

Tolerances: the float64 fields and golden exactly equal (the same
arithmetic); eager runner vs JAX XLA runner 3e-5 and the uniform limit
3e-5 (fp32 over a few sweeps, the JAX tests' bars); the coefficient plain
version vs the TPU kernel 5e-5 (the JAX test's bar against the golden: the
two form the face means in fp32 in another order).
"""

import io

import numpy as np
import pytest
import torch

from stencil_tpu import cli as jcli
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.core.grid import HaloGrid as JHaloGrid
from stencil_tpu.models import diffusion as jdiff
from stencil_tpu.ops import golden as jgolden
from stencil_tpu.utils.timing import Measurement
from stencil_tpu_torch import cli, convert
from stencil_tpu_torch.config import parse_args
from stencil_tpu_torch.core.spec import weighted
from stencil_tpu_torch.models import diffusion as tdiff
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.tiled import TiledStencil
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

CLI_ARGS = ["-s", "20", "18", "22", "-i", "9", "-k", "3", "--contrast", "30",
            "-c", "--spec", "jacobi7", "-m", "varcoeff"]
CLI_SHAPE = (20, 18, 22)


def _diffusions(shape, a, periodic=(), neumann=(), dt=None):
    jbc = JBC.reference_default(len(shape))
    if periodic:
        jbc = jbc.with_periodic(periodic)
    if neumann:
        jbc = jbc.with_neumann(neumann)
    jd = jdiff.HeterogeneousDiffusion(shape=shape, a=a, bc=jbc, dt=dt)
    td = convert.diffusion_from_arrays(shape, a, jd.h, jd.dt, jbc.values,
                                       jbc.periodic, jbc.neumann,
                                       device="cpu")
    return jd, td


@pytest.mark.parametrize("shape,periodic", [((7, 8, 9), ()),
                                            ((7, 8, 9), (True, False, True)),
                                            ((10, 12), ())])
def test_fields_equal_jax(rng, shape, periodic):
    a = rng.uniform(0.2, 3.0, size=shape)
    for j, t in zip(jdiff.face_harmonic_means(a, periodic or None),
                    tdiff.face_harmonic_means(a, periodic or None)):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tdiff.two_material(shape, 0.1, 1.0, 3),
                                  jdiff.two_material(shape, 0.1, 1.0, 3))
    dims = [d for d, p in enumerate(periodic) if p]
    jd, td = _diffusions(shape, a, periodic=dims)
    (jo, jf), (to, tf) = jd.tap_fields(), td.tap_fields()
    assert tuple(to) == tuple(jo)
    np.testing.assert_array_equal(tf, jf)
    u0 = rng.normal(size=shape)
    np.testing.assert_array_equal(
        golden.golden_iterate_fields(u0, to, tf, 5, bc=td.bc),
        jgolden.golden_iterate_fields(u0, jo, jf, 5, bc=jd.bc))
    with pytest.raises(ValueError) as want:
        jdiff.HeterogeneousDiffusion(shape=shape, a=a, dt=1.0).tap_fields()
    with pytest.raises(ValueError) as got:
        tdiff.HeterogeneousDiffusion(shape=shape, a=a, dt=1.0,
                                     device="cpu").tap_fields()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,periodic,neumann", [
    ((10, 12, 14), (), ()), ((16, 20), (), ()), ((10, 12, 14), (0,), (2,))])
def test_eager_runner_matches_jax_xla_runner(rng, shape, periodic, neumann):
    a = rng.uniform(0.5, 2.0, size=shape)
    jd, td = _diffusions(shape, a, periodic, neumann)
    u0 = rng.normal(size=shape).astype(np.float32)
    want = jd.runner(method="xla").iterate(jd.initial_grid(u0), 6)
    trun = td.runner()  # auto: eager here (2D, a dynamic lane dim) or tiled
    if td.uses_kernel():
        trun = td.runner(method="eager")
    assert trun.plan_info == {"kernel": "eager"}
    got = trun.iterate(td.initial_grid(u0), 6)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=3e-5, rtol=0)


@pytest.mark.parametrize("k,iters", [(1, 3), (2, 4), (3, 9)])
def test_coeff_plain_matches_jax_tiled_interpret(k, iters):
    """The coefficient mode's plain version through the runner (launches
    of k sweeps, a remainder at k=2) against the TPU kernel in interpret
    mode, on the CLI test's ragged grid and field (so that JAX's compiled
    k=3 kernel is the one the CLI test below reuses)."""
    a = jdiff.two_material(CLI_SHAPE, lo=1.0 / 30.0, hi=1.0, seed=0)
    jd, td = _diffusions(CLI_SHAPE, a)
    u0 = np.random.default_rng(21).normal(size=CLI_SHAPE).astype(np.float32)
    want = jd.runner(method="pallas_tiled", sweeps_per_call=k,
                     interpret=True).iterate(jd.initial_grid(u0), iters)
    before = tiled_sweep.launches
    trun = td.runner(sweeps_per_call=k)
    assert trun.plan_info["kernel"] == "tiled"
    got = trun.iterate(td.initial_grid(u0), iters)
    assert tiled_sweep.launches == before  # the plain version is no launch
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=5e-5,
                               rtol=0)
    offsets, fields = td.tap_fields()
    ref = golden.golden_iterate_fields(u0, offsets, fields, iters, bc=td.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=5e-5, rtol=0)


def test_varcoeff_cli_record_matches_jax(monkeypatch):
    """The CLI line passes its field golden check, and its record has the
    JAX record's keys and values but for the timings, the device name and
    the tile (the port's tile is its own; its plan also names the
    kernel). The JAX CLI's timing is stubbed: on the CPU it would time the
    interpreter."""
    monkeypatch.setattr(jcli, "bench_method", _fake_bench)
    monkeypatch.setattr(jcli, "measure_wall",
                        lambda fn, repeats=1: [0.0] * repeats)
    monkeypatch.setattr(jcli.roofline, "prepare_hbm_measurement", _no_hbm)
    (want,) = jcli.run_all(jparse_args(CLI_ARGS), out=io.StringIO())
    out = io.StringIO()
    (got,) = cli.run_all(parse_args([*CLI_ARGS, "--device", "cpu"]), out=out)
    assert got["check"]["ok"] and "field golden" not in out.getvalue()
    timing = {"seconds_per_sweep", "glups", "hbm_gbps", "roofline_fraction",
              "wall_seconds"}
    assert set(got) - {"device"} == set(want)
    for key in set(want) - timing - {"plan", "check"}:
        assert got[key] == want[key], key
    for key in ("ok", "iterations_checked", "capped"):
        assert got["check"][key] == want["check"][key], key
    assert got["check"]["max_abs_err"] < 1e-5
    # the port's own keys: its kernel, and the schedule (the d0 march)
    assert got["plan"]["schedule"] == "march"
    assert {k: v for k, v in got["plan"].items()
            if k not in ("tiles", "kernel", "schedule", "chunk")} == \
        {k: v for k, v in want["plan"].items() if k != "tiles"}


def _fake_bench(config, spec, runner):
    return Measurement(1e-3, 1, ())


def _no_hbm():
    raise RuntimeError("no device bandwidth on the CPU")


def test_varcoeff_cli_2d_and_refusals():
    out = io.StringIO()
    (rec,) = cli.run_all(parse_args(["-s", "24", "16", "-i", "5", "--spec",
                                     "jacobi5", "-m", "varcoeff",
                                     "--contrast", "10", "-c", "--device",
                                     "cpu"]), out=out)
    assert rec["check"]["ok"] and rec["plan"]["kernel"] == "eager"
    (rec,) = cli.run_all(parse_args(["-s", "16", "16", "-i", "5", "--spec",
                                     "jacobi9", "-m", "varcoeff", "--device",
                                     "cpu"]), out=out)
    assert "radius-1" in rec["error"]
    (rec,) = cli.run_all(parse_args(["-s", "16", "16", "-i", "5", "--spec",
                                     "jacobi5", "-m", "varcoeff",
                                     "--contrast", "0.5", "--device", "cpu"]),
                         out=out)
    assert "--contrast must be >= 1" in rec["error"]
    # -c beyond 50 iterations is capped, and says why
    out = io.StringIO()
    (rec,) = cli.run_all(parse_args(["-s", "10", "9", "11", "-i", "60",
                                     "--spec", "jacobi7", "-m", "varcoeff",
                                     "-k", "4", "-c", "--device", "cpu"]),
                         out=out)
    assert rec["check"]["ok"] and rec["check"]["capped"]
    assert rec["check"]["iterations_checked"] == 50
    assert "method-specific field golden" in out.getvalue()


def test_uniform_limit_matches_jacobi_tiled(rng):
    """a = const: the coefficient mode equals the constant-weight tiled
    path on the same FTCS update (harm(a, a) = a up to rounding)."""
    shape = (9, 16, 12)
    a0, dt = 0.7, 0.05
    td = tdiff.HeterogeneousDiffusion(shape=shape, a=np.full(shape, a0),
                                      dt=dt, device="cpu")
    lam = dt
    taps = [((0, 0, 0), 1.0 - 6 * lam * a0)]
    for d in range(3):
        for s in (-1, 1):
            off = [0, 0, 0]
            off[d] = s
            taps.append((tuple(off), lam * a0))
    spec = weighted(3, taps, name="uniform_ftcs")
    u0 = rng.normal(size=shape).astype(np.float32)
    g = td.initial_grid(u0)
    got = td.runner(method="tiled", sweeps_per_call=2).iterate(g, 6)
    want = TiledStencil(spec, shape, sweeps_per_call=2, device="cpu") \
        .iterate(g, 6)
    np.testing.assert_allclose(got.interior().numpy(),
                               want.interior().numpy(), atol=3e-5, rtol=0)


def test_coeff_plan_gates_and_wrapper(rng):
    from stencil_tpu.core.spec import get_spec as jget_spec
    from stencil_tpu.ops import pallas_tiled as jpt
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.ops.sweep_kernel import coeff_of, sweep_reference
    from stencil_tpu_torch.ops.tiled import (
        coeff_operand, make_tiled_plan, pad_coeff,
    )

    scales = (1.0, 1.0, -1.0)
    for name, dtype in (("jacobi7", "bfloat16"), ("laplace3d_ho", "float32")):
        with pytest.raises(ValueError) as want:
            jpt.make_tiled_plan(jget_spec(name), (16, 16, 16), dtype,
                                tap_mode="coeff", coeff_scales=scales)
        with pytest.raises(ValueError) as got:
            make_tiled_plan(get_spec(name), (16, 16, 16), dtype,
                            coeff_scales=scales)
        assert str(got.value) == str(want.value)
    shape = (6, 7, 8)
    plan = make_tiled_plan(get_spec("jacobi7"), shape, "float32", 2,
                           coeff_scales=scales)
    assert plan.has_coeff and plan.with_sweeps(1).coeff_scales == scales
    assert not plan.two_level and coeff_of(plan) == scales
    a = rng.uniform(0.5, 2.0, size=shape)
    coeff = pad_coeff(plan, a, _zero_bc())
    # the ghosts are edge-replicated to the layout's full depth
    np.testing.assert_array_equal(
        coeff.numpy(), np.pad(a.astype(np.float32), 2, mode="edge"))
    x = torch.from_numpy(rng.random(plan.layout.padded_shape)
                         .astype(np.float32))
    # the launches read the plan's operand: on the march the weight fields
    op = coeff_operand(plan, coeff)
    with pytest.raises(ValueError, match="coeff"):
        tiled_sweep(x, x.clone(), plan)
    with pytest.raises(ValueError, match="no source"):
        tiled_sweep(x, x.clone(), plan, src=x.clone(), coeff=op)
    with pytest.raises(ValueError, match="shape"):
        tiled_sweep(x, x.clone(), plan, coeff=op[1:])
    got = tiled_sweep(x, x.clone(), plan, coeff=op)
    assert torch.equal(got, sweep_reference(x, plan, coeff=op))
    # periodic d0: edge-replicated, then wrapped over the full extent of
    # the other dims (pallas_tiled.pad_coeff's order)
    want = np.pad(np.pad(a.astype(np.float32), ((0, 0), (2, 2), (2, 2)),
                         mode="edge"), ((2, 2), (0, 0), (0, 0)), mode="wrap")
    np.testing.assert_array_equal(
        pad_coeff(plan, a, _zero_bc().with_periodic([0])).numpy(), want)


def _zero_bc():
    from stencil_tpu_torch.core.grid import DirichletBC

    return DirichletBC.zero(3)


def test_jax_grid_round_trip_is_exact(rng):
    """convert carries a JAX grid's padded data unchanged (the comparisons
    above start from the same bits)."""
    shape = (5, 6, 7)
    jd, td = _diffusions(shape, np.ones(shape))
    u0 = rng.normal(size=shape).astype(np.float32)
    jg = jd.initial_grid(u0)
    assert isinstance(jg, JHaloGrid)
    np.testing.assert_array_equal(td.initial_grid(u0).data.numpy(),
                                  np.asarray(jg.data))
