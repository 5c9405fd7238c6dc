"""The advection family (stencil_tpu_torch/models/advection.py:Advection)
against the JAX package's: its spec, CFL numbers, stability gates and exact
translation equal; the upwind scheme's one-sided taps through the tiled
and slab kernels' plain versions over periodic walls at temporal depth
(against the JAX tiled kernel in interpret mode and the float64 golden);
exact integer-CFL translation on a fully periodic box at k=1; mass
conservation; and the Neumann mirror-symmetry gate firing on these taps.

Tolerances: specs and CFL numbers exactly equal (the same float64
arithmetic); port vs JAX 1e-5 and vs the float64 golden 5e-6 (fp32, the
JAX test's bar); integer-CFL translation bitwise (each step copies with
weight 1.0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.models import advection as jadv
from stencil_tpu.ops.pallas_tiled import TiledPallasStencil
from stencil_tpu_torch import convert
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.models import advection as tadv
from stencil_tpu_torch.ops import eager, golden
from stencil_tpu_torch.ops.slab import SlabStencil
from stencil_tpu_torch.ops.tiled import TiledStencil


def _gaussian(shape, width=0.08):
    axes = [np.linspace(0, 1, n, endpoint=False) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    r2 = sum((g - 0.35) ** 2 for g in grids)
    return np.exp(-r2 / (2 * width ** 2)).astype(np.float32)


def _both(shape, velocity, jbc=None, **kw):
    jbc = jbc if jbc is not None else jgrid.DirichletBC.periodic_all(
        len(shape))
    ja = jadv.Advection(shape=shape, velocity=velocity, bc=jbc, **kw)
    ta = tadv.Advection(shape=shape, velocity=velocity,
                        bc=convert.bc_from_arrays(jbc.values, jbc.periodic,
                                                  jbc.neumann),
                        device="cpu", **kw)
    return ja, ta


@pytest.mark.parametrize("shape,velocity,kw", [
    ((16, 16), (0.7, -0.3), {}),
    ((16, 16), (0.7, -0.3), dict(scheme="lax_wendroff")),
    ((16, 16), (1.0, 0.0), dict(dt=0.5)),
    ((8, 9, 10), (0.5, -0.25, 0.125), {}),
    ((8, 9, 10), (0.6, -0.3, 0.4), dict(cfl_safety=0.8)),
    ((8, 9, 10), (1.0, 0.0, 0.0), dict(dt=1.0))])
def test_spec_and_courant_equal_jax(shape, velocity, kw):
    ja, ta = _both(shape, velocity, **kw)
    assert ta.dt == ja.dt and ta.courant == ja.courant
    assert ta.spec.offsets == ja.spec.offsets
    assert ta.spec.weights == ja.spec.weights
    assert ta.spec.name == ja.spec.name
    for d in range(len(shape)):
        assert ta.spec.symmetric_in(d) == ja.spec.symmetric_in(d)
    assert ta.bc.periodic == ja.bc.periodic


@pytest.mark.parametrize("kw", [
    dict(shape=(8, 8), velocity=(1.0, 1.0), dt=0.75),
    dict(shape=(8, 8), velocity=(2.0, 0.0), dt=0.75, scheme="lax_wendroff"),
    dict(shape=(8, 8), velocity=(1.0,)),
    dict(shape=(8, 8), velocity=(1.0, 0.0), scheme="bogus")])
def test_stability_gates_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jadv.Advection(**kw)
    with pytest.raises(ValueError) as got:
        tadv.Advection(device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_exact_translate_equals_jax():
    ja, ta = _both((8, 12), (0.5, -0.25), dt=1.0)
    u0 = _gaussian((8, 12))
    np.testing.assert_array_equal(ta.exact_translate(u0, 4),
                                  ja.exact_translate(u0, 4))
    ja, ta = _both((8, 8), (0.3, 0.0), dt=1.0)
    with pytest.raises(ValueError) as want:
        ja.exact_translate(np.zeros((8, 8), np.float32), 1)
    with pytest.raises(ValueError) as got:
        ta.exact_translate(np.zeros((8, 8), np.float32), 1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stencil,shape,velocity", [
    (TiledStencil, (12, 14, 16), (1.0, 0.0, 0.0)),
    (TiledStencil, (12, 14, 16), (0.0, 0.0, -1.0)),
    (SlabStencil, (16, 24), (0.0, 1.0))])
def test_integer_cfl_is_exact_translation_on_the_kernels(stencil, shape,
                                                         velocity):
    """c_d = 1 makes upwind the exact shift: on a fully periodic box, k=1
    launches (every dim dynamic, the last one too) translate the field
    bitwise, as the eager sweep does."""
    adv = tadv.Advection(shape=shape, velocity=velocity, dt=1.0,
                         device="cpu")
    u0 = _gaussian(shape)
    g = adv.initial_grid(u0)
    got = stencil(adv.spec, shape, sweeps_per_call=1, device="cpu") \
        .iterate(g, 5)
    want = adv.exact_translate(u0, 5)
    np.testing.assert_array_equal(got.interior().numpy(), want)
    np.testing.assert_array_equal(
        eager.iterate(g, adv.spec, 5).interior().numpy(), want)


def test_periodic_mass_conservation_on_the_kernel():
    shape = (20, 16)
    adv = tadv.Advection(shape=shape, velocity=(0.6, -0.4), cfl_safety=0.9,
                         bc=DirichletBC.zero(2).with_periodic((0,))
                         .with_periodic((1,)), device="cpu")
    u0 = _gaussian(shape)
    got = SlabStencil(adv.spec, shape, sweeps_per_call=1, device="cpu") \
        .iterate(adv.initial_grid(u0), 12).interior().double().numpy()
    assert abs(got.sum() - u0.astype(np.float64).sum()) < 1e-3 * u0.sum()
    assert got.min() > -1e-6  # upwind is monotone: no undershoots


@pytest.mark.parametrize("scheme", ["upwind", "lax_wendroff"])
def test_tiled_kernel_runs_one_sided_taps_at_depth(scheme):
    """k=4 over periodic leading dims (a wrap needs no symmetry) and a
    Dirichlet lane dim, two launches, against the TPU kernel in interpret
    mode and the float64 golden."""
    shape = (12, 16, 18)
    jbc = jgrid.DirichletBC.zero(3).with_periodic((0, 1))
    ja, ta = _both(shape, (0.6, -0.3, 0.4), jbc=jbc, cfl_safety=0.8,
                   scheme=scheme)
    u0 = _gaussian(shape)
    got = TiledStencil(ta.spec, shape, sweeps_per_call=4, device="cpu") \
        .iterate(ta.initial_grid(u0), 8)
    want = TiledPallasStencil(ja.spec, shape, sweeps_per_call=4,
                              interpret=True).iterate(
        jgrid.HaloGrid.from_interior(jnp.asarray(u0), halo=1, bc=jbc), 8)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=1e-5, rtol=0)
    ref = golden.golden_iterate(u0, ta.spec, 8, bc=ta.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=5e-6, rtol=0)


def test_cfg12_walls_and_remainder_match_golden():
    """cfg12's configuration cut to 20x18x22: upwind, velocity (0.5,
    -0.25, 0.125), reference walls, k=8, two launches and a remainder."""
    shape = (20, 18, 22)
    adv = tadv.Advection(shape=shape, velocity=(0.5, -0.25, 0.125),
                         bc=DirichletBC.reference_default(3), device="cpu")
    assert adv.spec.num_taps == 4
    u0 = _gaussian(shape)
    got = TiledStencil(adv.spec, shape, sweeps_per_call=8, device="cpu") \
        .iterate(adv.initial_grid(u0), 19)
    ref = golden.golden_iterate(u0, adv.spec, 19, bc=adv.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=5e-6, rtol=0)


def test_neumann_depth_gate_fires_on_one_sided_taps():
    """Neumann d0 at k>1 refuses the upwind taps with JAX's message; k=1
    runs and matches the golden."""
    shape = (12, 16, 18)
    jbc = jgrid.DirichletBC.zero(3).with_neumann((0,))
    ja, ta = _both(shape, (0.5, 0.0, 0.0), jbc=jbc, dt=0.5)
    u0 = _gaussian(shape)
    with pytest.raises(ValueError) as want:
        TiledPallasStencil(ja.spec, shape, sweeps_per_call=2,
                           interpret=True).iterate(
            jgrid.HaloGrid.from_interior(jnp.asarray(u0), halo=1, bc=jbc), 2)
    with pytest.raises(ValueError) as got:
        TiledStencil(ta.spec, shape, sweeps_per_call=2, device="cpu") \
            .iterate(ta.initial_grid(u0), 2)
    assert str(got.value) == str(want.value)
    out = TiledStencil(ta.spec, shape, sweeps_per_call=1, device="cpu") \
        .iterate(ta.initial_grid(u0), 3)
    ref = golden.golden_iterate(u0, ta.spec, 3, bc=ta.bc)
    np.testing.assert_allclose(out.interior().double().numpy(), ref,
                               atol=5e-6, rtol=0)


def test_initial_grid_dtype_device_and_walls():
    adv = tadv.Advection(shape=(6, 7), velocity=(0.5, 0.5), device="cpu")
    g = adv.initial_grid(np.ones((6, 7)))
    assert g.dtype == torch.float32 and g.device.type == "cpu"
    assert g.halo == 1 and g.bc == DirichletBC.periodic_all(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            tadv.Advection(shape=(6, 7), velocity=(0.5, 0.5)) \
                .initial_grid(np.ones((6, 7)))
        else:
            raise RuntimeError("CUDA present; nothing to refuse")
