"""Periodic walls on the sweep kernels of the port (the kernels' ``pins``,
stencil_tpu_torch/ops/sweep_kernel.py; the deep ghost refresh,
ops/layout.py:refresh_dynamic_layout; the runners and gates of
ops/tiled.py, ops/slab.py and registry.py) against the JAX package: its
refresh and pins bitwise, its tiled and slab Pallas kernels in interpret
mode (as tests/test_periodic.py runs them), its gates' messages, and the
float64 golden. Also the plain version's live-band rule against the
kernels' window algorithm, and the proof that no read of a launch leaves
the padded tensor. The kernels themselves are held against their plain
versions on a card by tests/test_torch_cuda.py.

Tolerances: port vs JAX allclose at 1e-5 (fp32; the TPU kernels may sum
box stencils in another order); port vs the float64 golden at 5e-6, the
reference suite's bar; the refresh, the pins and the padded source
exactly."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu import registry as jregistry
from stencil_tpu.config import RunConfig as JRunConfig
from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.ops import layout as jlayout
from stencil_tpu.ops.pallas import PallasStencil
from stencil_tpu.ops.pallas_tiled import TiledPallasStencil, _dynamic_pins
from stencil_tpu.ops.pallas_tiled import pad_source as jpad_source
from stencil_tpu_torch import cli, convert, registry
from stencil_tpu_torch.config import RunConfig, parse_args
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.layout import (
    PaddedLayout, pad_source, refresh_dynamic_layout,
)
from stencil_tpu_torch.ops.slab import SlabStencil, make_slab_plan
from stencil_tpu_torch.ops.sweep_kernel import (
    launch_plans, sweep_reference, update_boxes,
)
from stencil_tpu_torch.ops.tiled import (
    TiledStencil, dynamic_pins, make_tiled_plan,
)

TOL_JAX = 1e-5
TOL_GOLDEN = 5e-6
SCALE = -0.04


def _bcs(ndim, periodic=(), neumann=()):
    """The same walls in both packages (reference faces elsewhere)."""
    jbc = jgrid.DirichletBC.reference_default(ndim) \
        .with_periodic(periodic).with_neumann(neumann)
    return jbc, convert.bc_from_arrays(jbc.values, jbc.periodic,
                                       jbc.neumann)


def _grids(x, halo, jbc, tbc):
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=halo, bc=jbc)
    return jg, tgrid.HaloGrid.from_interior(torch.from_numpy(x), halo=halo,
                                            bc=tbc, device="cpu")


def check_kernel(stencil, name, shape, k, iters, rng, periodic=(),
                 neumann=(), jax_too=True, source=False):
    """The port's iterate on ``stencil`` (TiledStencil or SlabStencil)
    against the float64 golden and, with ``jax_too``, the TPU kernel in
    interpret mode on the same grid (and source)."""
    jbc, tbc = _bcs(len(shape), periodic, neumann)
    sp, jsp = tspec.get_spec(name), jspec.get_spec(name)
    x = rng.random(shape).astype(np.float32)
    f = rng.normal(size=shape).astype(np.float32) if source else None
    jg, tg = _grids(x, sp.radius, jbc, tbc)
    kw = dict(source=f, source_scale=SCALE) if source else {}
    got = stencil(sp, shape, sweeps_per_call=k, device="cpu", **kw) \
        .iterate(tg, iters)
    assert got.bc == tbc
    ref = golden.golden_iterate(x, sp, iters, bc=tbc, source=f,
                                source_scale=SCALE)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=TOL_GOLDEN, rtol=0)
    if jax_too:
        jcls = TiledPallasStencil if len(shape) == 3 else PallasStencil
        want = jcls(jsp, shape, sweeps_per_call=k, interpret=True,
                    tap_mode="slice", **kw).iterate(jg, iters)
        np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                                   atol=TOL_JAX, rtol=0)


# ---- the deep refresh and the pins -----------------------------------------


@pytest.mark.parametrize("shape,halo,periodic,neumann", [
    ((7, 9, 11), 3, (0, 1), ()),
    ((7, 9, 11), 2, (), (0, 2)),
    ((7, 9, 11), 4, (0,), (1,)),
    ((6, 8, 5), 2, (0, 1, 2), ()),
    ((10, 13), 4, (0,), ()),
    ((10, 13), 3, (1,), (0,)),
])
def test_refresh_dynamic_layout_matches_jax(rng, shape, halo, periodic,
                                            neumann):
    """Bitwise equal to JAX's on the region both layouts share (the JAX
    layout also pads d-1 and d-2 to the TPU's alignment); the radius below
    the layout's depth refreshes only that many rings."""
    jbc, tbc = _bcs(len(shape), periodic, neumann)
    x = rng.random(shape).astype(np.float32)
    jl = jlayout.PaddedLayout.for_halo(shape, halo)
    tl = PaddedLayout.for_halo(shape, halo)
    for radius in (halo, halo - 1):
        want = np.asarray(jlayout.refresh_dynamic_layout(
            jl.pad(jnp.asarray(x), jbc), jl, jbc, radius))
        padded = tl.pad(torch.from_numpy(x), tbc)
        got = refresh_dynamic_layout(padded, tl, tbc, radius)
        assert got is padded  # in place
        cut = tuple(slice(lo - halo, lo + n + halo)
                    for (lo, _), n in zip(jl.pads, shape))
        np.testing.assert_array_equal(got.numpy(), want[cut])


def test_refresh_depth_check_matches_jax():
    jbc, tbc = _bcs(3, neumann=(1,))
    jl = jlayout.PaddedLayout.for_halo((8, 3, 8), 4)
    with pytest.raises(ValueError) as want:
        jlayout.refresh_dynamic_layout(jnp.zeros(jl.padded_shape), jl, jbc,
                                       4)
    tl = PaddedLayout.for_halo((8, 3, 8), 4)
    with pytest.raises(ValueError) as got:
        refresh_dynamic_layout(torch.zeros(tl.padded_shape), tl, tbc, 4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("periodic,neumann", [
    ((), ()), ((0,), ()), ((1,), ()), ((2,), ()), ((), (0, 1)),
    ((0,), (1,)), ((1,), (2,)), ((0, 1, 2), ())])
def test_dynamic_pins_match_jax(periodic, neumann):
    jbc, tbc = _bcs(3, periodic, neumann)
    assert dynamic_pins(tbc, 3) == tuple(int(p) for p in _dynamic_pins(jbc))
    # the 2D slab kernel: d0's two faces (pallas.py:_cached_iterate)
    jbc2, tbc2 = _bcs(2, [d for d in periodic if d < 2],
                      [d for d in neumann if d < 2])
    dyn0 = jbc2.dynamic_mask(2)[0]
    assert dynamic_pins(tbc2, 2) == (0 if dyn0 else 1,) * 2


# ---- the plain version's live-band rule and the reads' bounds --------------


PIN_SETS = [p for p in itertools.product((0, 1), repeat=4)]
PLANS = [("jacobi7", (13, 17, 19), 4, None),
         ("jacobi7", (16, 24, 20), 3, (8, 8, 16)),
         ("laplace3d_ho", (14, 18, 16), 3, None),
         ("jacobi27", (9, 10, 11), 2, (4, 2, 8))]


def _kernel_windows(plan):
    """For each tile and sweep t: the padded index range of its window and
    of sweep t's region, per dim (the kernel's arithmetic: origin =
    clamped start + H - k*r, region [o + t*r, o + w - t*r))."""
    k, r, halo = plan.sweeps_per_call, plan.spec.radius, plan.layout.halo
    starts = [plan.tile_starts(d) for d in range(len(plan.tiles))]
    for tile in itertools.product(*starts):
        origin = [s + halo - k * r for s in tile]
        window = [(o, o + t + 2 * k * r) for o, t in zip(origin, plan.tiles)]
        yield tile, window, [[(lo + t * r, hi - t * r) for lo, hi in window]
                             for t in range(1, k + 1)]


@pytest.mark.parametrize("name,shape,k,tiles", PLANS)
def test_update_boxes_are_the_kernels_update_test(name, shape, k, tiles):
    """On every point a launch computes (every tile's region at every
    sweep, the remainder launch's too), the plain version's region says
    "update" exactly where the kernel's test does: the interior bound of
    a pinned face, the window's edge at a live one. With the shrinking
    windows (sweep t reads only sweep t-1's region) this makes the kernel
    and its plain version agree point by point, for every pin set."""
    plan0 = make_tiled_plan(tspec.get_spec(name), shape, "float32", k,
                            tiles=tiles)
    halo = plan0.layout.halo
    for plan in launch_plans(plan0, 1, k - 1):
        for pins in PIN_SETS:
            boxes = update_boxes(plan, pins)
            for tile, window, regions in _kernel_windows(plan):
                for t, region in enumerate(regions, 1):
                    for d in range(3):
                        o = window[d][0]
                        lo = halo if d == 2 or pins[2 * d] else o
                        hi = halo + shape[d] \
                            if d == 2 or pins[2 * d + 1] else window[d][1]
                        for p in range(*region[d]):
                            kernel = lo <= p < hi
                            plain = boxes[t - 1][d].start <= p \
                                < boxes[t - 1][d].stop
                            assert kernel == plain, (plan.tiles, pins, tile,
                                                     t, d, p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,k,tiles", PLANS + [
    ("jacobi5", (25, 33), 3, None), ("star2d_r2", (40, 24), 4, (8, 8))])
def test_launch_reads_stay_in_bounds(name, shape, k, tiles, dtype):
    """Every window lies inside the padded tensor; at sweep t every
    update (live ghosts included) reads its taps inside the window, and in
    the coefficient mode a(x) one cell further, still inside the padded
    tensor; a source or older level is read at the point itself. In
    bfloat16 the chooser may pick other tiles (2-byte windows); the
    geometry holds for them too."""
    sp = tspec.get_spec(name)
    make = make_tiled_plan if len(shape) == 3 else make_slab_plan
    plan0 = make(sp, shape, dtype, k, tiles=tiles)
    padded = plan0.layout.padded_shape
    for plan in launch_plans(plan0, 1, k - 1):
        for _, window, regions in _kernel_windows(plan):
            for d, (lo, hi) in enumerate(window):
                assert 0 <= lo and hi <= padded[d]
                for region in regions:
                    a, b = region[d]
                    assert lo <= a - sp.radius and b + sp.radius <= hi
                    assert 0 <= a - 1 and b + 1 <= padded[d]
        # the plain version's regions: the same reads
        for pins in itertools.product((0, 1), repeat=2 * (len(shape) - 1)):
            for box in update_boxes(plan, pins):
                for d, s in enumerate(box):
                    assert s.start - sp.radius >= 0
                    assert s.stop + sp.radius <= padded[d]


def _emulated_launch(plan, cur, pins, src=None):
    """The kernel's algorithm in torch: per tile its window, k sweeps over
    the shrinking region, each point updated where the kernel's test says
    (else held), the tile written to a copy of ``cur``."""
    from stencil_tpu_torch.ops.eager import apply_spec

    k, r, halo = plan.sweeps_per_call, plan.spec.radius, plan.layout.halo
    out = cur.clone()
    for tile, window, _ in _kernel_windows(plan):
        win = cur[tuple(slice(*w) for w in window)].clone()
        for t in range(1, k + 1):
            e = t * r
            region = tuple(slice(e, w1 - w0 - e) for w0, w1 in window)
            grown = tuple(slice(s.start - r, s.stop + r) for s in region)
            new = apply_spec(win[grown], plan.spec, halo=r)
            if src is not None:
                new.add_(src[tuple(slice(w0 + s.start, w0 + s.stop)
                                   for (w0, _), s in zip(window, region))])
            mask = torch.ones(new.shape, dtype=torch.bool)
            for d, ((w0, w1), s) in enumerate(zip(window, region)):
                idx = torch.arange(s.start, s.stop) + w0
                lo = halo if d == 2 or pins[2 * d] else w0
                hi = halo + plan.interior_shape[d] \
                    if d == 2 or pins[2 * d + 1] else w1
                shape = [1, 1, 1]
                shape[d] = -1
                mask &= ((idx >= lo) & (idx < hi)).reshape(shape)
            win[region] = torch.where(mask, new, win[region])
        tile_idx = tuple(slice(s + halo, s + halo + n)
                         for s, n in zip(tile, plan.tiles))
        win_idx = tuple(slice(k * r, k * r + n) for n in plan.tiles)
        out[tile_idx] = win[win_idx]
    return out


@pytest.mark.parametrize("pins,source", [((0, 0, 1, 1), False),
                                         ((1, 0, 0, 1), True),
                                         ((0, 0, 0, 0), True)])
def test_plain_version_equals_emulated_kernel(rng, pins, source):
    """Bitwise: the plain version and the kernel's window algorithm, on a
    ragged grid with clamped tiles, random ghosts standing in for a
    refresh."""
    plan = make_tiled_plan(tspec.get_spec("jacobi27"), (9, 10, 11),
                           "float32", 3, tiles=(4, 4, 8))
    cur = torch.from_numpy(rng.random(plan.layout.padded_shape,
                                      dtype=np.float32))
    src = torch.from_numpy(rng.normal(size=plan.layout.padded_shape)
                           .astype(np.float32)) if source else None
    want = _emulated_launch(plan, cur, pins, src)
    assert torch.equal(sweep_reference(cur, plan, src, pins=pins), want)


# ---- the kernels with periodic walls ---------------------------------------


@pytest.mark.parametrize("dims", [(0,), (1,), (0, 1)])
def test_tiled_periodic_leading_dims_match_jax(rng, dims):
    """k=3 over two launches (one compiled JAX kernel; the remainder
    launch is held against the golden below)."""
    check_kernel(TiledStencil, "jacobi7", (12, 16, 18), 3, 6, rng,
                 periodic=dims)


@pytest.mark.parametrize("dims", [(2,), (0, 1, 2)])
def test_tiled_periodic_lane_k1_matches_jax(rng, dims):
    check_kernel(TiledStencil, "jacobi7", (12, 16, 18), 1, 3, rng,
                 periodic=dims)


@pytest.mark.parametrize("name,k,dims", [("jacobi27", 4, (0, 1)),
                                         ("laplace3d_ho", 3, (0, 1)),
                                         ("jacobi7", 4, (0, 1)),
                                         ("jacobi27", 1, (0, 1, 2))])
def test_tiled_periodic_box_r2_ragged_match_golden(rng, name, k, dims):
    """Box corners, radius-2 rings and clamped ragged tiles through the
    wrap, two launches and a remainder launch of 1, against the float64
    golden."""
    check_kernel(TiledStencil, name, (13, 17, 19), k, 2 * k + 1, rng,
                 periodic=dims, jax_too=False)


@pytest.mark.parametrize("dims,k", [((0,), 4), ((0, 1), 1)])
def test_slab_periodic_matches_jax(rng, dims, k):
    check_kernel(SlabStencil, "jacobi5", (24, 40), k, 2 * k, rng,
                 periodic=dims)


@pytest.mark.parametrize("name,k", [("star2d_r2", 3), ("jacobi9", 4)])
def test_slab_periodic_ragged_matches_golden(rng, name, k):
    check_kernel(SlabStencil, name, (250, 333), k, 2 * k + 1, rng,
                 periodic=(0,), jax_too=False)


def test_slab_source_periodic_matches_jax(rng):
    check_kernel(SlabStencil, "jacobi5", (24, 40), 4, 8, rng,
                 periodic=(0,), source=True)


@pytest.mark.parametrize("ndim,periodic,neumann", [
    (3, (0,), (1,)), (3, (0, 1, 2), ()), (2, (0,), ())])
def test_pad_source_matches_jax(rng, ndim, periodic, neumann):
    """The padded source: the scaled interior and the wrapped or mirrored
    ghosts of the dynamic dims, bitwise (on the region both layouts
    share; the JAX plan's ghost-reading tap mode gives it lane ghosts);
    Dirichlet ghosts 0."""
    shape = (6, 7, 9)[:ndim]
    jbc, tbc = _bcs(ndim, periodic, neumann)
    spec = "jacobi7" if ndim == 3 else "jacobi5"
    if ndim == 3:
        from stencil_tpu.ops.pallas_tiled import make_tiled_plan as jmake

        jplan = jmake(jspec.get_spec(spec), shape, "float32", 2,
                      tap_mode="slice", has_source=True)
        tplan = make_tiled_plan(tspec.get_spec(spec), shape, "float32", 2,
                                has_source=True)
    else:
        from stencil_tpu.ops.pallas import make_plan as jmake

        shape = (16, 24)
        jplan = jmake(jspec.get_spec(spec), shape, "float32", 2,
                      tap_mode="slice", has_source=True)
        tplan = make_slab_plan(tspec.get_spec(spec), shape, "float32", 2)
    f = rng.normal(size=shape)
    want = np.asarray(jpad_source(jplan, f, SCALE, jbc))
    got = pad_source(tplan, f, SCALE, tbc).numpy()
    h = tplan.layout.halo
    cut = tuple(slice(lo - h, lo + n + h)
                for (lo, _), n in zip(jplan.layout.pads, shape))
    np.testing.assert_array_equal(got, want[cut])


# ---- the CLI and the registry ----------------------------------------------


@pytest.mark.parametrize("argv", [
    ["-s", "24", "20", "28", "-i", "9", "--spec", "jacobi7", "-m",
     "pallas_temporal", "-k", "3", "--periodic", "0", "1"],
    ["-s", "12", "16", "20", "-i", "4", "--spec", "jacobi27", "-m",
     "pallas", "--periodic", "all"],
    ["-s", "24", "40", "-i", "10", "--spec", "jacobi5", "-m",
     "pallas_temporal", "-k", "4", "--periodic", "0"],
])
def test_cli_periodic_checks_on_the_kernels(argv):
    """``-c`` against the float64 golden over every iteration; the plan
    records the pins, and the result equals the JAX package's ``xla``
    runner on the same grid (its ``make_grid``)."""
    from stencil_tpu import cli as jcli
    from stencil_tpu.config import parse_args as jparse_args

    cfg = parse_args([*argv, "-c", "--device", "cpu"])
    spec = cfg.resolved_spec()
    grid = cli.make_grid(cfg, spec)
    runner = registry.get_runner(cfg.methods[0], cfg, spec, grid)
    chk, iters = cli.check_method(cfg, spec, runner)
    assert chk.ok and iters == cfg.iterations, chk.message()
    dyn = grid.bc.dynamic_mask(spec.ndim)
    assert runner.plan_info["pins"] == [0 if dyn[d] else 1
                                        for d in range(spec.ndim - 1)
                                        for _ in (0, 1)]
    jcfg = jparse_args([*argv, "-m", "xla", "--platform", "cpu"])
    jsp = jcfg.resolved_spec()
    jg = jcli.make_grid(jcfg, jsp)
    want = jregistry.get_runner("xla", jcfg, jsp, jg).iterate(
        jg, cfg.iterations)
    got = runner.iterate(grid, cfg.iterations)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL_JAX, rtol=0)


def test_registry_gates_match_jax():
    """A periodic lane dim at k>1 on either kernel, and ``--embed`` or
    ``--slide`` under dynamic walls on the tiled one, refused when the
    runner is made, with the JAX registry's messages."""
    cases = [((16, 16), "jacobi5", "pallas_temporal", dict(periodic=(1,))),
             ((16, 16, 16), "jacobi7", "pallas_temporal",
              dict(periodic=(2,))),
             ((16, 16, 16), "jacobi7", "pallas_tiled",
              dict(periodic=(0,), embed=True)),
             ((16, 16, 16), "jacobi7", "pallas_tiled",
              dict(periodic=(1,), slide=True))]
    for shape, name, method, kw in cases:
        flags = {key: v for key, v in kw.items() if key != "periodic"}
        jbc, tbc = _bcs(len(shape), kw["periodic"])
        jcfg = JRunConfig(size=shape, spec=name, methods=(method,), **flags)
        with pytest.raises(ValueError) as want:
            jregistry.get_runner(method, jcfg, jspec.get_spec(name),
                                 jgrid.HaloGrid.create(shape, bc=jbc))
        tcfg = RunConfig(size=shape, spec=name, methods=(method,),
                         device="cpu", **flags)
        with pytest.raises(ValueError) as got:
            registry.get_runner(method, tcfg, tspec.get_spec(name),
                                tgrid.HaloGrid.create(shape, bc=tbc,
                                                      device="cpu"))
        assert str(got.value) == str(want.value)


def test_cli_lane_periodic_at_depth_reports_unavailable(capsys):
    rc = cli.main(["-s", "16", "16", "-i", "2", "-m", "pallas_temporal",
                   "--periodic", "1", "--device", "cpu"])
    assert rc == 1
    assert "periodic/Neumann lane" in capsys.readouterr().out


def test_chebyshev_modes_refuse_dynamic_walls(rng):
    """The multigrid fine level's modes keep every face pinned."""
    from stencil_tpu_torch.multigrid import nbsum_spec
    from stencil_tpu_torch.ops.tiled import cheby_dual, source_iterate
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

    shape = (8, 8, 8)
    coeffs = ((0.5, 0.1, 0.0, 0.01),) * 2
    plan = make_tiled_plan(nbsum_spec(3), shape, "float32", 2,
                           has_source=True, cheby_coeffs=coeffs)
    _, bc = _bcs(3, periodic=(0,))
    data = torch.zeros(tuple(n + 2 for n in shape))
    src = torch.zeros(plan.layout.padded_shape)
    with pytest.raises(ValueError, match="static Dirichlet walls"):
        source_iterate(plan, data, bc, src)
    dual = make_tiled_plan(nbsum_spec(3), shape, "float32", 2,
                           has_source=True, cheby_coeffs=coeffs,
                           cheby_dual=True)
    with pytest.raises(ValueError, match="static Dirichlet walls"):
        cheby_dual(dual, data, bc, src)
    with pytest.raises(ValueError, match="static Dirichlet walls"):
        tiled_sweep(src, src.clone(), plan, src.clone(), pins=(0, 0, 1, 1))
