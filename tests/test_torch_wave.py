"""The wave equation (stencil_tpu_torch/models/wave.py) and the two-level
mode of the tiled kernel's plain version (ops/sweep_kernel.py,
ops/tiled.py:wave_iterate) against the JAX package: its WaveEquation on
the XLA leapfrog, its tiled Pallas kernel in interpret mode (as
tests/test_wave_tiled.py runs it), and its float64 golden loop. The kernel
itself is held against its plain version on a card by
tests/test_torch_cuda.py.

Tolerances: the spec, Courant number and Taylor start exactly equal (the
same float64 arithmetic); port vs JAX leapfrog 5e-6 on values of order 1
(fp32; XLA and the Pallas kernel may sum the taps in another order), the
JAX tests' bar; vs the float64 golden loop 5e-4 and vs the analytic
standing mode 3e-4 over 24 and 12 steps (fp32 drift), the JAX tests' bars.
"""

import numpy as np
import pytest
import torch

from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.core.spec import get_spec as jget_spec
from stencil_tpu.models import wave as jwave
from stencil_tpu.ops import pallas_tiled as jpt
from stencil_tpu_torch import convert
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.models import wave as twave
from stencil_tpu_torch.ops.tiled import (
    make_tiled_plan, march_smem_bytes, wave_iterate,
)
from stencil_tpu_torch.ops.tiled_kernel import sweep_reference, tiled_sweep

TOL = 5e-6


def _waves(shape, dt=None, periodic=(), neumann=()):
    """The same wave problem in both packages (zero walls)."""
    jbc = JBC.zero(len(shape))
    if periodic:
        jbc = jbc.with_periodic(periodic)
    if neumann:
        jbc = jbc.with_neumann(neumann)
    jw = jwave.WaveEquation(shape=shape, bc=jbc, dt=dt)
    tw = convert.wave_from_arrays(shape, jw.c, jw.h, jw.dt, jbc.values,
                                  jbc.periodic, jbc.neumann, device="cpu")
    return jw, tw


@pytest.mark.parametrize("shape,dt", [((6, 7, 8), None), ((6, 7, 8), 0.4),
                                      ((9, 10), None), ((9, 10), 0.25)])
def test_spec_courant_and_initial_pair_equal_jax(rng, shape, dt):
    jw, tw = _waves(shape, dt)
    assert tw.courant == jw.courant
    assert tw.spec.offsets == jw.spec.offsets
    assert tw.spec.weights == jw.spec.weights
    u0, v0 = rng.normal(size=shape), rng.normal(size=shape)
    for jg, tg in zip(jw.initial_pair(u0, v0), tw.initial_pair(u0, v0)):
        np.testing.assert_array_equal(tg.data.numpy(), np.asarray(jg.data))
    with pytest.raises(ValueError) as want:
        jwave.WaveEquation(shape=shape, dt=2.0).courant
    with pytest.raises(ValueError) as got:
        twave.WaveEquation(shape=shape, dt=2.0, device="cpu").courant
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,periodic,neumann", [
    ((10, 12, 14), (), ()), ((20, 18), (), ()),
    ((10, 12, 14), (0,), (1,)), ((16, 20), (1,), (0,))])
def test_eager_matches_jax_xla(rng, shape, periodic, neumann):
    jw, tw = _waves(shape, periodic=periodic, neumann=neumann)
    u0, v0 = rng.normal(size=shape), rng.normal(size=shape)
    want = jw.simulate_interior(u0, 9, v0=v0)
    got = tw.simulate_interior(u0, 9, v0=v0, method="eager")
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("shape,k,steps", [
    ((16, 24, 20), 1, 3), ((16, 24, 20), 2, 4), ((16, 24, 20), 4, 8),
    ((16, 24, 20), 4, 10), ((13, 17, 19), 3, 7)])
def test_tiled_matches_jax_tiled_interpret(shape, k, steps):
    """The two-level plain version through ``WaveEquation.simulate``
    (``wave_iterate``: launches of k steps, a remainder launch) against the
    TPU kernel in interpret mode: depths, a remainder, a ragged grid."""
    rng = np.random.default_rng(0)
    jw, tw = _waves(shape)
    u0, v0 = rng.normal(size=shape), rng.normal(size=shape)
    want = jw.simulate_interior(u0, steps, v0=v0, method="pallas_tiled",
                                sweeps_per_call=k, interpret=True)
    before = tiled_sweep.launches
    got = tw.simulate_interior(u0, steps, v0=v0, method="tiled",
                               sweeps_per_call=k)
    assert tiled_sweep.launches == before  # the plain version is no launch
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_tiled_matches_float64_golden():
    shape = (12, 16, 20)
    jw, tw = _waves(shape)
    u0 = np.random.default_rng(5).normal(size=shape)
    want = jwave.golden_wave(u0, jw.spec, 24, jw.bc,
                             dt=jw.courant * jw.h / jw.c)
    np.testing.assert_array_equal(
        twave.golden_wave(u0, tw.spec, 24, tw.bc,
                          dt=tw.courant * tw.h / tw.c), want)
    got = tw.simulate_interior(u0, 24, method="tiled", sweeps_per_call=4)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_tiled_standing_mode_analytic():
    """The discrete eigenmode through the tiled path: catches a wrong
    subtrahend or a ghost overwritten with live data."""
    n = 16
    w = twave.WaveEquation(shape=(n, n, n), dt=0.25, device="cpu")
    x = np.arange(1, n + 1) / (n + 1)
    m1 = np.sin(np.pi * x)
    mode = np.einsum("i,j,k->ijk", m1, m1, m1)
    s2 = w.courant ** 2
    theta = np.arccos((2 - 6 * s2 + 6 * s2 * np.cos(np.pi / (n + 1))) / 2)
    got = w.simulate_interior(mode, 12, method="tiled", sweeps_per_call=4)
    np.testing.assert_allclose(got, np.cos(12 * theta) * mode, atol=3e-4,
                               rtol=0)


def test_plan_gates_match_jax():
    j7, jj7 = get_spec("jacobi7"), jget_spec("jacobi7")
    for kw in (dict(two_level=True, has_source=True),
               dict(two_level=True, coeff_scales=(1.0, 1.0, -1.0),
                    tap_mode="coeff")):
        with pytest.raises(ValueError) as want:
            jpt.make_tiled_plan(jj7, (16, 16, 16), "float32", 2, **kw)
        kw.pop("tap_mode", None)
        with pytest.raises(ValueError) as got:
            make_tiled_plan(j7, (16, 16, 16), "float32", 2, **kw)
        assert str(got.value) == str(want.value)
    # the lane gate and the 3D gate carry the JAX messages
    for shape, periodic in (((8, 8, 8), (2,)), ((8, 8), ())):
        jw, tw = _waves(shape, periodic=periodic)
        u0 = np.zeros(shape)
        with pytest.raises(ValueError) as want:
            jw.simulate_interior(u0, 3, method="pallas_tiled",
                                 interpret=True)
        with pytest.raises(ValueError) as got:
            tw.simulate_interior(u0, 3, method="tiled")
        assert str(got.value) == str(want.value)
    # dynamic leading dims run on the kernel, as the eager leapfrog
    _, tw = _waves((8, 8, 8), periodic=(0,), neumann=(1,))
    u0 = np.random.default_rng(3).normal(size=(8, 8, 8))
    np.testing.assert_allclose(
        tw.simulate_interior(u0, 5, method="tiled", sweeps_per_call=2),
        tw.simulate_interior(u0, 5, method="eager"), atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="unknown wave method"):
        tw.simulate_interior(np.zeros((8, 8, 8)), 3, method="bogus")


def test_two_level_plan_and_wrapper(rng):
    shape = (9, 10, 11)
    spec = twave.WaveEquation(shape=shape, device="cpu").spec
    plan = make_tiled_plan(spec, shape, "float32", 3, two_level=True)
    assert plan.two_level and plan.with_sweeps(2).two_level
    # the march, its rings one plane deeper than a plain plan's (level s
    # reads level s-2's plane); on the window two windows, as a plain
    # plan's: u_t is written over u_{t-2}
    assert plan.schedule == "march"
    assert plan.smem_bytes == march_smem_bytes(plan.tiles, 3, 1, 4, True) \
        == march_smem_bytes(plan.tiles, 3, 1) * 5 // 4
    window = make_tiled_plan(spec, shape, "float32", 3, two_level=True,
                             schedule="window")
    assert window.smem_bytes == make_tiled_plan(
        spec, shape, "float32", 3, tiles=window.tiles,
        schedule="window").smem_bytes
    x = torch.from_numpy(rng.random(plan.layout.padded_shape)
                         .astype(np.float32))
    y = torch.from_numpy(rng.random(plan.layout.padded_shape)
                         .astype(np.float32))
    with pytest.raises(ValueError, match="prev"):
        tiled_sweep(x, x.clone(), plan, out2=y.clone())
    with pytest.raises(ValueError, match="out2"):
        tiled_sweep(x, x.clone(), plan, prev=y)
    with pytest.raises(ValueError, match="distinct"):
        tiled_sweep(x, x.clone(), plan, prev=y, out2=y)
    nxt, out2 = tiled_sweep(x, x.clone(), plan, prev=y, out2=y.clone())
    want = sweep_reference(x, plan, prev=y)
    assert torch.equal(nxt, want[0]) and torch.equal(out2, want[1])
    # k = 1: the second output is the input level itself
    one = plan.with_sweeps(1)
    _, level = sweep_reference(x, one, prev=y)
    assert torch.equal(level, x)
    # wave_iterate rotates four tensors: n_outer launches then a remainder
    bc = DirichletBC.zero(3)
    h1 = [torch.nn.functional.pad(torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)), (1,) * 6)
        for _ in range(2)]
    c7, p7 = wave_iterate(plan, h1[0], h1[1], bc, 2, rem=1)
    c, p = h1
    for _ in range(7):
        c, p = twave._simulate_eager(
            _grid(p), _grid(c), spec, 1)[1].data, c
    np.testing.assert_array_equal(c7.numpy(), c.numpy())
    np.testing.assert_array_equal(p7.numpy(), p.numpy())


def _grid(data):
    from stencil_tpu_torch.core.grid import HaloGrid

    return HaloGrid(data=data, halo=1, bc=DirichletBC.zero(3))
