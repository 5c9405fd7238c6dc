"""The 2D iterate (stencil_tpu_torch/ops/slab.py) and the plain version of
its CUDA kernel (ops/slab_kernel.py) against the JAX package's slab Pallas
kernel in interpret mode, as tests/test_pallas.py runs it, and against
``xla.iterate`` and the float64 golden; plus the plan's geometry and the
wrapper's refusals. The kernel itself is tested on a card by
tests/test_torch_cuda.py.

Tolerances: port vs JAX allclose at atol = rtol = 1e-6 (fp32; the TPU
kernel evaluates jacobi9 with rotated accumulation, in another order);
port vs the float64 golden at 5e-6, the reference suite's bar."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.ops import xla
from stencil_tpu.ops.pallas import PallasStencil
from stencil_tpu_torch import convert
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.slab import (
    SMEM_LIMIT, SlabStencil, choose_tiles, make_slab_plan,
)
from stencil_tpu_torch.ops.slab_kernel import slab_sweep, sweep_reference

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


@pytest.mark.parametrize("name,k,iters", [
    ("jacobi5", 1, 3), ("jacobi5", 4, 10), ("jacobi9", 4, 9),
    ("star2d_r2", 2, 5)])
def test_iterate_matches_jax_slab_interpret(rng, name, k, iters):
    """Iteration counts that leave a remainder run the k' = iters % k
    launch on both sides."""
    shape = (24, 40)
    j = jspec.get_spec(name)
    t, jg, tg = _both(rng, j, shape)
    want = PallasStencil(j, shape, sweeps_per_call=k,
                         interpret=True).iterate(jg, iters)
    got = SlabStencil(t, shape, sweeps_per_call=k, device="cpu") \
        .iterate(tg, iters)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["jacobi5", "jacobi9", "laplace2d_ho"])
def test_iterate_matches_xla(rng, name):
    shape = (21, 30)
    j = jspec.get_spec(name)
    t, jg, tg = _both(rng, j, shape)
    want = xla.iterate(jg, j, 7)
    got = SlabStencil(t, shape, sweeps_per_call=3, tiles=(8, 16),
                      device="cpu").iterate(tg, 7)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["jacobi5", "jacobi9", "star2d_r2"])
def test_iterate_matches_golden(rng, name):
    sp = tspec.get_spec(name)
    shape = (19, 27)
    x = rng.random(shape).astype(np.float32)
    g = tgrid.HaloGrid.from_interior(torch.from_numpy(x), halo=sp.radius,
                                     device="cpu")
    out = SlabStencil(sp, shape, sweeps_per_call=4, device="cpu") \
        .iterate(g, 9)
    ref = golden.golden_iterate(x.astype(np.float64), sp, 9, bc=g.bc)
    np.testing.assert_allclose(out.interior().double().numpy(), ref,
                               atol=5e-6, rtol=5e-6)


def test_plain_version_matches_jax_slab_interpret(rng):
    """One launch's plain version on the deep-halo layout equals one
    k-sweep call of the TPU kernel."""
    shape, k = (24, 40), 4
    j = jspec.get_spec("jacobi5")
    t, jg, tg = _both(rng, j, shape)
    want = PallasStencil(j, shape, sweeps_per_call=k,
                         interpret=True).iterate(jg, k)
    plan = make_slab_plan(t, shape, "float32", k, tiles=(8, 24))
    out = sweep_reference(plan.layout.pad_grid(tg), plan)
    np.testing.assert_allclose(plan.layout.unpad(out).numpy(),
                               np.asarray(want.interior()),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape,k,t0", list(itertools.product(
    [(512, 512), (4096, 4096), (250, 333), (24, 40), (7, 300)],
    [1, 4, 16], [None, 256])))
def test_plan_geometry(shape, k, t0):
    """Tiles cover every interior point, every window lies inside the
    padded tensor, the shared memory fits one block, and -b pins t0
    (clamped to the rows there are)."""
    plan = make_slab_plan(tspec.get_spec("jacobi9"), shape, "float32", k,
                          t0_fixed=t0)
    assert plan.smem_bytes <= SMEM_LIMIT
    if t0 is not None:
        assert plan.tiles[0] == min(t0, shape[0])
    for d in range(2):
        covered = np.zeros(shape[d], bool)
        for start in plan.tile_starts(d):
            covered[start:start + plan.tiles[d]] = True
            lo = plan.window_origin(d, start)
            assert lo >= 0
            assert lo + plan.window_shape[d] <= plan.layout.padded_shape[d]
        assert covered.all()
    geom = plan.kernel_geometry()
    assert len(geom) == 11
    assert geom == (*shape, *plan.layout.padded_shape, k, *plan.tiles,
                    *plan.num_tiles, k, 1)


def test_chooser_fills_the_card_on_small_grids():
    """At 512², k=16 the chooser spreads the grid over at least half the
    card's 132 SMs instead of taking the fewest, largest tiles."""
    tiles = choose_tiles(tspec.get_spec("jacobi5"), (512, 512), 16)
    blocks = np.prod([-(-512 // t) for t in tiles])
    assert blocks >= 66


def test_any_row_count_runs(rng):
    """The TPU's sublane rule (rows % 8) is not carried: 13 rows run."""
    sp = tspec.get_spec("jacobi5")
    shape = (13, 17)
    x = rng.random(shape).astype(np.float32)
    g = tgrid.HaloGrid.from_interior(torch.from_numpy(x), device="cpu")
    out = SlabStencil(sp, shape, sweeps_per_call=2, t0_fixed=5,
                      device="cpu").iterate(g, 4)
    ref = golden.golden_iterate(x.astype(np.float64), sp, 4, bc=g.bc)
    np.testing.assert_allclose(out.interior().double().numpy(), ref,
                               atol=5e-6, rtol=5e-6)


def test_plan_refuses_what_is_not_ported():
    sp = tspec.get_spec("jacobi5")
    with pytest.raises(ValueError, match="2D-only"):
        make_slab_plan(tspec.get_spec("jacobi7"), (16, 16, 16))
    # bf16 is ported: its plan builds, with 2-byte windows
    bf16 = make_slab_plan(sp, (16, 16), "bfloat16")
    assert bf16.dtype == "bfloat16" and bf16.itemsize == 2
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_slab_plan(sp, (16, 16), "float64")
    with pytest.raises(ValueError, match="shared memory"):
        make_slab_plan(sp, (512, 512), "float32", 8, tiles=(256, 256))
    with pytest.raises(ValueError, match="fits"):
        make_slab_plan(tspec.get_spec("star2d_r2"), (512, 512), "float32",
                       64)
    with pytest.raises(ValueError, match="must lie"):
        make_slab_plan(sp, (16, 16), tiles=(8, 32))


def test_wrapper_checks_and_cpu_path(rng):
    sp = tspec.get_spec("jacobi9")
    shape = (9, 14)
    plan = make_slab_plan(sp, shape, "float32", 2)
    g = tgrid.HaloGrid.from_interior(
        torch.from_numpy(rng.random(shape).astype(np.float32)), device="cpu")
    cur = plan.layout.pad_grid(g)
    nxt = cur.clone()
    before = slab_sweep.launches
    out = slab_sweep(cur, nxt, plan)
    assert out is nxt
    assert torch.equal(nxt, sweep_reference(cur, plan))
    assert slab_sweep.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="pins"):
        slab_sweep(cur, nxt, plan, pins=(0, 1, 1, 1))
    with pytest.raises(ValueError, match="pins"):
        slab_sweep(cur, nxt, plan, pins=(1, 3))
    with pytest.raises(ValueError, match="dtype"):
        slab_sweep(cur.double(), nxt.double(), plan)
    with pytest.raises(ValueError, match="shape"):
        slab_sweep(cur[1:], nxt[1:], plan)
    with pytest.raises(ValueError, match="src shape"):
        slab_sweep(cur, nxt, plan, src=cur[1:])
    with pytest.raises(ValueError, match="contiguous"):
        slab_sweep(cur, nxt, plan, src=cur.t().contiguous().t())
    with pytest.raises(ValueError, match="distinct"):
        slab_sweep(cur, cur, plan)


def test_slab_refuses_dynamic_walls():
    """The periodic/Neumann walls the TPU slab kernel refuses, refused
    with its message: a dynamic lane dim at k>1, a Neumann d0 at k>1 under
    taps not mirror-symmetric in d0."""
    upwind = [((0, 0), 0.5), ((-1, 0), 0.25), ((0, -1), 0.25)]
    for taps, shape, k, walls in (
            (None, (8, 8), 2, dict(periodic=(1,))),
            (upwind, (8, 8), 2, dict(neumann=(0,)))):
        j = jspec.weighted(2, taps) if taps else jspec.get_spec("jacobi5")
        t = tspec.weighted(2, taps) if taps else tspec.get_spec("jacobi5")
        jbc = jgrid.DirichletBC.reference_default(2) \
            .with_periodic(walls.get("periodic", ())) \
            .with_neumann(walls.get("neumann", ()))
        tbc = convert.bc_from_arrays(jbc.values, jbc.periodic, jbc.neumann)
        with pytest.raises(ValueError) as want:
            PallasStencil(j, shape, sweeps_per_call=k, interpret=True,
                          tap_mode="slice").iterate(
                jgrid.HaloGrid.create(shape, bc=jbc), k)
        with pytest.raises(ValueError) as got:
            SlabStencil(t, shape, sweeps_per_call=k, device="cpu").iterate(
                tgrid.HaloGrid.create(shape, bc=tbc, device="cpu"), k)
        assert str(got.value) == str(want.value)


def test_build_hashes_headers_and_raises_on_failure(tmp_path, monkeypatch):
    """An edit to a header the kernels include builds anew; a compiler
    that fails raises with its stderr (no quiet fallback)."""
    from stencil_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    cc = tmp_path / "cc.sh"
    cc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                  'touch "$2"\n')
    cc.chmod(0o755)
    src, header = tmp_path / "k.cu", tmp_path / "k.cuh"
    src.write_text("// kernel\n")
    header.write_text("// taps v1\n")
    first = _build.build(str(cc), [src], (), "k", headers=[header])
    assert not first.cached
    assert _build.build(str(cc), [src], (), "k", headers=[header]).cached
    header.write_text("// taps v2\n")
    second = _build.build(str(cc), [src], (), "k", headers=[header])
    assert not second.cached and second.path != first.path
    bad = tmp_path / "bad.sh"
    bad.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                   "exit 2\n")
    bad.chmod(0o755)
    with pytest.raises(_build.BuildError, match="no such intrinsic"):
        _build.build(str(bad), [src], (), "bad", headers=[header])
