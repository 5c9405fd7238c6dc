"""The tiled iterate (stencil_tpu_torch/ops/tiled.py) and the plain version
of its CUDA kernel (ops/tiled_kernel.py) against the JAX package's tiled
Pallas kernel in interpret mode, as tests/test_pallas_tiled.py runs it;
plus the plan's geometry and the wrapper's refusals. The kernel itself is
tested on a card by tests/test_torch_cuda.py.

Tolerances: port vs JAX allclose at atol = rtol = 1e-6 (fp32; the TPU
kernel may evaluate box stencils separably, in another order); port vs the
float64 golden at 5e-6, the reference suite's bar."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.ops import xla
from stencil_tpu.ops.pallas_tiled import TiledPallasStencil
from stencil_tpu_torch import convert
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.tiled import (
    SMEM_LIMIT, TiledStencil, make_tiled_plan,
)
from stencil_tpu_torch.ops.tiled_kernel import (
    sweep_reference, tap_table, tiled_sweep,
)

TOL = 1e-6


def _both(rng, jspec_, shape):
    """The same random grid (reference walls) in both packages."""
    t = convert.spec_from_arrays(jspec_.name, jspec_.offsets,
                                 jspec_.weights, jspec_.radius)
    x = rng.random(shape).astype(np.float32)
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=jspec_.radius)
    tg = convert.grid_from_arrays(np.asarray(jg.data), jg.halo,
                                  jg.bc.values, device="cpu")
    return t, jg, tg


@pytest.mark.parametrize("name,k", [
    ("jacobi7", 1), ("jacobi7", 2), ("jacobi27", 2), ("star3d_r2", 2)])
def test_iterate_matches_jax_tiled_interpret(rng, name, k):
    shape = (16, 16, 20)
    j = jspec.get_spec(name)
    t, jg, tg = _both(rng, j, shape)
    want = TiledPallasStencil(j, shape, sweeps_per_call=k, tiles=(8, 8),
                              interpret=True).iterate(jg, 2 * k)
    got = TiledStencil(t, shape, sweeps_per_call=k, device="cpu") \
        .iterate(tg, 2 * k)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


def test_plain_version_matches_jax_tiled_interpret(rng):
    """One launch's plain version on the deep-halo layout equals one
    k-sweep call of the TPU kernel."""
    shape, k = (16, 16, 20), 2
    j = jspec.get_spec("jacobi7")
    t, jg, tg = _both(rng, j, shape)
    want = TiledPallasStencil(j, shape, sweeps_per_call=k, tiles=(8, 8),
                              interpret=True).iterate(jg, k)
    plan = make_tiled_plan(t, shape, "float32", k, tiles=(8, 8, 16))
    out = sweep_reference(plan.layout.pad_grid(tg), plan)
    np.testing.assert_allclose(plan.layout.unpad(out).numpy(),
                               np.asarray(want.interior()),
                               atol=TOL, rtol=TOL)


def test_remainder_iterations_match_xla(rng):
    """k=3 over 7 iterations: two launches of 3 and one of 1 sweep."""
    shape = (12, 24, 20)
    j = jspec.get_spec("jacobi7")
    t, jg, tg = _both(rng, j, shape)
    want = xla.iterate(jg, j, 7)
    got = TiledStencil(t, shape, sweeps_per_call=3, tiles=(4, 8, 16),
                       device="cpu").iterate(tg, 7)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["jacobi7", "jacobi27", "laplace3d_ho"])
def test_iterate_matches_golden(rng, name):
    sp = tspec.get_spec(name)
    shape = (13, 11, 9)
    x = rng.random(shape).astype(np.float32)
    g = tgrid.HaloGrid.from_interior(torch.from_numpy(x), halo=sp.radius,
                                     device="cpu")
    out = TiledStencil(sp, shape, sweeps_per_call=4, device="cpu") \
        .iterate(g, 9)
    ref = golden.golden_iterate(x.astype(np.float64), sp, 9, bc=g.bc)
    np.testing.assert_allclose(out.interior().double().numpy(), ref,
                               atol=5e-6, rtol=5e-6)


@pytest.mark.parametrize("shape,k", list(itertools.product(
    [(256, 256, 256), (257, 257, 257), (57, 50, 46)], [1, 4, 8])))
def test_plan_geometry(shape, k):
    """Tiles cover every interior point, every window lies inside the
    padded tensor, and the shared memory fits one block."""
    plan = make_tiled_plan(tspec.get_spec("jacobi7"), shape, "float32", k)
    assert plan.smem_bytes <= SMEM_LIMIT
    for d in range(3):
        covered = np.zeros(shape[d], bool)
        for start in plan.tile_starts(d):
            covered[start:start + plan.tiles[d]] = True
            lo = plan.window_origin(d, start)
            assert lo >= 0
            assert lo + plan.window_shape[d] <= plan.layout.padded_shape[d]
        assert covered.all()
    assert len(plan.kernel_geometry()) == 15


def test_plan_refuses_what_is_not_ported():
    sp = tspec.get_spec("jacobi7")
    with pytest.raises(ValueError, match="3D-only"):
        make_tiled_plan(tspec.get_spec("jacobi5"), (16, 16))
    with pytest.raises(ValueError, match="float32"):
        make_tiled_plan(sp, (16, 16, 16), "bfloat16")
    with pytest.raises(ValueError, match="shared memory"):
        make_tiled_plan(sp, (64, 64, 64), "float32", 8, tiles=(32, 32, 32))
    with pytest.raises(ValueError, match="fits"):
        make_tiled_plan(tspec.get_spec("star3d_r2"), (64, 64, 64),
                        "float32", 8)


def test_wrapper_checks_and_cpu_path(rng):
    sp = tspec.get_spec("jacobi27")
    shape = (9, 10, 11)
    plan = make_tiled_plan(sp, shape, "float32", 2)
    g = tgrid.HaloGrid.from_interior(
        torch.from_numpy(rng.random(shape).astype(np.float32)), device="cpu")
    cur = plan.layout.pad_grid(g)
    nxt = cur.clone()
    before = tiled_sweep.launches
    out = tiled_sweep(cur, nxt, plan)
    assert out is nxt
    assert torch.equal(nxt, sweep_reference(cur, plan))
    assert tiled_sweep.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="pins"):
        tiled_sweep(cur, nxt, plan, pins=(0, 0, 1, 1))
    with pytest.raises(ValueError, match="dtype"):
        tiled_sweep(cur.double(), nxt.double(), plan)
    with pytest.raises(ValueError, match="shape"):
        tiled_sweep(cur[1:], nxt[1:], plan)
    with pytest.raises(ValueError, match="distinct"):
        tiled_sweep(cur, cur, plan)


def test_tiled_refuses_dynamic_walls(rng):
    sp = tspec.get_spec("jacobi7")
    bc = tgrid.DirichletBC.reference_default(3).with_periodic([0])
    g = tgrid.HaloGrid.create((8, 8, 8), bc=bc, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        TiledStencil(sp, (8, 8, 8), device="cpu").iterate(g, 2)


def test_tap_table_is_weight_group_order():
    sp = tspec.get_spec("laplace3d_ho")
    offsets, sizes, weights, uniform, _ = tap_table(sp)
    groups = sp.weight_groups()
    assert not uniform
    assert list(sizes) == [len(offs) for _, offs in groups]
    assert [tuple(o) for o in offsets.reshape(-1, 3)] == \
        [off for _, offs in groups for off in offs]
    np.testing.assert_array_equal(
        weights, np.asarray([w for w, _ in groups], np.float32))
