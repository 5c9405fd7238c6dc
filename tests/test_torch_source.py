"""The port's source term (the affine sweep ``u' = S(u) + c*f`` behind
Poisson relaxation) against the JAX package's: the eager sweeps
(ops/eager.py vs ops/xla.py), the float64 golden and its operator
(ops/golden.py), the padded source (ops/layout.py:pad_source vs
ops/pallas_tiled.py:pad_source), and the plain versions of both kernels'
source modes through ``TiledStencil``/``SlabStencil`` vs the TPU kernels
with ``has_source`` in interpret mode.

Tolerances: port vs JAX in fp32 allclose at atol = rtol = 1e-6 (XLA may
fuse the source add into the tap sum; the TPU kernels may evaluate box
stencils in another order); the numpy goldens and the padded source's
interior are compared exactly (the same float64, resp. float32, steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.ops import golden as jgolden
from stencil_tpu.ops import xla
from stencil_tpu.ops.layout import PaddedLayout as JPaddedLayout
from stencil_tpu.ops.layout import refresh_dynamic_layout as jrefresh
from stencil_tpu.ops.pallas import PallasStencil
from stencil_tpu.ops.pallas_tiled import TiledPallasStencil
from stencil_tpu.ops.pallas_tiled import pad_source as jpad_source
from stencil_tpu_torch import convert
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import eager, golden
from stencil_tpu_torch.ops.layout import pad_source
from stencil_tpu_torch.ops.slab import SlabStencil, make_slab_plan
from stencil_tpu_torch.ops.tiled import TiledStencil, make_tiled_plan

TOL = 1e-6
SCALE = -0.04


def _both(rng, name, shape, bc=None):
    """The same random grid and source in both packages."""
    j = jspec.get_spec(name)
    t = convert.spec_from_arrays(j.name, j.offsets, j.weights, j.radius)
    x = rng.random(shape).astype(np.float32)
    f = rng.normal(size=shape).astype(np.float32)
    jbc = bc or jgrid.DirichletBC.reference_default(len(shape))
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=j.radius, bc=jbc)
    tg = convert.grid_from_arrays(np.asarray(jg.data), jg.halo,
                                  jg.bc.values, jg.bc.periodic,
                                  jg.bc.neumann, device="cpu")
    return j, t, jg, tg, f


@pytest.mark.parametrize("name,shape", [("jacobi5", (14, 17)),
                                        ("jacobi27", (7, 9, 8))])
def test_sweep_source_matches_xla(rng, name, shape):
    j, t, jg, tg, f = _both(rng, name, shape)
    scaled = f * np.float32(SCALE)
    want = xla.sweep_source(jg, j, jnp.asarray(scaled))
    got = eager.iterate(tg, t, 1, torch.from_numpy(scaled))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,shape,dims", [
    ("jacobi5", (14, 17), ()), ("jacobi7", (8, 9, 10), ()),
    ("jacobi9", (12, 10), ((0,), (1,)))])
def test_iterate_source_matches_xla(rng, name, shape, dims):
    """Dynamic ghosts (a periodic and a Neumann dim) are refreshed after
    every sweep on both sides."""
    bc = jgrid.DirichletBC.reference_default(len(shape))
    if dims:
        bc = bc.with_periodic(dims[0]).with_neumann(dims[1])
    j, t, jg, tg, f = _both(rng, name, shape, bc)
    scaled = f * np.float32(SCALE)
    want = xla.iterate_source_dynamic(jg, j, jnp.int32(6),
                                      jnp.asarray(scaled))
    got = eager.iterate(tg, t, 6, torch.from_numpy(scaled))
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


def test_eager_source_shape_mismatch(rng):
    _, t, _, tg, _ = _both(rng, "jacobi5", (8, 8))
    with pytest.raises(ValueError, match="source shape"):
        eager.iterate(tg, t, 2, torch.zeros(4, 4))


@pytest.mark.parametrize("name,shape", [("jacobi5", (11, 13)),
                                        ("jacobi7", (6, 7, 8)),
                                        ("laplace3d_ho", (7, 6, 9))])
def test_golden_with_source_matches_jax(rng, name, shape):
    j = jspec.get_spec(name)
    t = tspec.get_spec(name)
    x = rng.random(shape)
    f = rng.normal(size=shape)
    jbc = jgrid.DirichletBC.reference_default(len(shape))
    tbc = convert.bc_from_arrays(jbc.values)
    want = jgolden.golden_iterate(x, j, 5, bc=jbc, source=f,
                                  source_scale=SCALE)
    got = golden.golden_iterate(x, t, 5, bc=tbc, source=f,
                                source_scale=SCALE)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(golden.apply_spec_f64(x, t, tbc),
                                  jgolden.apply_spec_f64(x, j, jbc))
    with pytest.raises(ValueError, match="source shape"):
        golden.golden_iterate(x, t, 1, source=f[..., 1:])


@pytest.mark.parametrize("kind", ["tiled", "slab"])
def test_pad_source_matches_jax(rng, kind):
    """The interior is float32(f) * float32(scale), as JAX scales it; the
    ghosts hold 0."""
    if kind == "tiled":
        shape = (12, 16, 20)
        j = jspec.get_spec("jacobi7")
        jplan = TiledPallasStencil(j, shape, sweeps_per_call=4,
                                   interpret=True,
                                   source=np.zeros(shape)).plan
        tplan = make_tiled_plan(tspec.get_spec("jacobi7"), shape, "float32",
                                4)
    else:
        shape = (24, 32)
        j = jspec.get_spec("jacobi5")
        jplan = PallasStencil(j, shape, sweeps_per_call=4, interpret=True,
                              source=np.zeros(shape)).plan
        tplan = make_slab_plan(tspec.get_spec("jacobi5"), shape, "float32",
                               4)
    f = rng.normal(size=shape)  # float64, cast to float32 on both sides
    jbc = jgrid.DirichletBC.reference_default(len(shape))
    want = jplan.layout.unpad(jpad_source(jplan, f, SCALE, jbc))
    padded = pad_source(tplan, f, SCALE, convert.bc_from_arrays(jbc.values))
    np.testing.assert_array_equal(tplan.layout.unpad(padded).numpy(),
                                  np.asarray(want))
    ghosts = padded.clone()
    ghosts[tplan.layout.interior_index] = 0
    assert not ghosts.any()


def test_pad_source_refuses():
    """A source of another shape; a dynamic dim shallower than the
    layout's depth, with the JAX refresh's message."""
    plan = make_slab_plan(tspec.get_spec("jacobi5"), (8, 8), "float32", 2)
    bc = tgrid.DirichletBC.reference_default(2)
    with pytest.raises(ValueError, match="source shape"):
        pad_source(plan, np.zeros((8, 9)), 1.0, bc)
    shallow = make_slab_plan(tspec.get_spec("jacobi5"), (3, 8), "float32",
                             4)
    jlayout = JPaddedLayout.for_halo((3, 8), 4)
    jbc = jgrid.DirichletBC.reference_default(2).with_periodic([0])
    with pytest.raises(ValueError) as want:
        jrefresh(jnp.zeros(jlayout.padded_shape), jlayout, jbc, 4)
    with pytest.raises(ValueError) as got:
        pad_source(shallow, np.ones((3, 8)), 1.0, bc.with_periodic([0]))
    assert str(got.value) == str(want.value)


def test_tiled_source_matches_jax_interpret(rng):
    """k=4 over 10 iterations: two launches and a remainder launch of 2,
    each adding the source."""
    shape = (12, 16, 20)
    j, t, jg, tg, f = _both(rng, "jacobi7", shape)
    want = TiledPallasStencil(j, shape, sweeps_per_call=4, interpret=True,
                              source=f, source_scale=SCALE).iterate(jg, 10)
    got = TiledStencil(t, shape, sweeps_per_call=4, device="cpu", source=f,
                       source_scale=SCALE).iterate(tg, 10)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


def test_slab_source_matches_jax_interpret(rng):
    shape = (24, 32)
    j, t, jg, tg, f = _both(rng, "jacobi5", shape)
    want = PallasStencil(j, shape, sweeps_per_call=4, interpret=True,
                         source=f, source_scale=SCALE).iterate(jg, 10)
    got = SlabStencil(t, shape, sweeps_per_call=4, device="cpu", source=f,
                      source_scale=SCALE).iterate(tg, 10)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,shape,k", [("jacobi9", (19, 23), 3),
                                          ("jacobi27", (9, 8, 10), 2)])
def test_kernel_source_matches_golden(rng, name, shape, k):
    sp = tspec.get_spec(name)
    x = rng.random(shape).astype(np.float32)
    f = rng.normal(size=shape).astype(np.float32)
    g = tgrid.HaloGrid.from_interior(torch.from_numpy(x), device="cpu")
    stencil = SlabStencil if len(shape) == 2 else TiledStencil
    out = stencil(sp, shape, sweeps_per_call=k, device="cpu", source=f,
                  source_scale=SCALE).iterate(g, 7)
    ref = golden.golden_iterate(x, sp, 7, bc=g.bc, source=f,
                                source_scale=SCALE)
    np.testing.assert_allclose(out.interior().double().numpy(), ref,
                               atol=5e-6, rtol=5e-6)


def test_kernel_source_refusals(rng):
    sp = tspec.get_spec("jacobi7")
    with pytest.raises(ValueError, match="source shape"):
        TiledStencil(sp, (8, 8, 8), sweeps_per_call=2, device="cpu",
                     source=np.zeros((4, 4, 4)))
    bc = tgrid.DirichletBC.reference_default(3).with_neumann([2])
    g = tgrid.HaloGrid.create((8, 8, 8), bc=bc, device="cpu")
    with pytest.raises(ValueError, match="lane"):
        TiledStencil(sp, (8, 8, 8), sweeps_per_call=2, device="cpu",
                     source=np.zeros((8, 8, 8))).iterate(g, 2)
