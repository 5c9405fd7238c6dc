"""The sharded kernel path of the port: the tiled kernel's tile subsets
(B1f, stencil_tpu_torch/csrc/tiled_sweep.cu through its plain version,
ops/sweep_kernel.py:subset_reference), the interior/edge partition
(ops/tiled.py:partition_tiles), ``ShardedKernelStencil``
(parallel/sharded_kernel.py, method ``sharded_pallas``) and
``PoissonProblem.sharded_runner``, against the float64 golden, JAX's
``ShardedStencil`` on the CPU mesh, JAX's gates and the port's own
single-device runners.

JAX's ``ShardedPallasStencil`` in interpret mode takes 2-17 s per call
(tests/durations.json), so the port is held against JAX's sharded eager
stencil and the single-device kernels instead. The kernels themselves are
held against these plain versions on a card by tests/test_torch_cuda.py.

Tolerances: vs the golden 5e-6 (fp32), 3e-2 (bf16); vs JAX 1e-6 relative;
the overlapped step against the fused one, and the sharded runs against
the single-device tiled and slab runs, bitwise."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu import registry as jregistry
from stencil_tpu.config import RunConfig as JRunConfig
from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.models import poisson as jpoisson
from stencil_tpu.ops.pallas_tiled import build_tiled_sweep
from stencil_tpu.ops.pallas_tiled import make_tiled_plan as jmake_tiled_plan
from stencil_tpu.parallel.halo import ShardedStencil as JShardedStencil
from stencil_tpu.parallel.halo import make_mesh as jmake_mesh
from stencil_tpu.parallel.pallas_sharded import ShardedPallasStencil
from stencil_tpu_torch import cli, convert, registry
from stencil_tpu_torch.config import RunConfig
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.models import poisson
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.eager import apply_spec
from stencil_tpu_torch.ops.layout import pad_source
from stencil_tpu_torch.ops.slab import SlabStencil
from stencil_tpu_torch.ops.sweep_kernel import (
    column_boxes, launch_plans, subset_reference, sweep_reference,
)
from stencil_tpu_torch.ops.tiled import (
    TiledStencil, make_tiled_plan, partition_tiles,
)
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep
from stencil_tpu_torch.parallel.mesh import make_mesh
from stencil_tpu_torch.parallel.sharded_kernel import ShardedKernelStencil

TOL_GOLDEN = 5e-6
TOL_BF16 = 3e-2
TOL_JAX = 1e-6


def _bc(ndim, periodic=(), neumann=()):
    return tgrid.DirichletBC.reference_default(ndim).with_periodic(
        periodic).with_neumann(neumann)


def _grid(shape, radius, bc=None, seed=5, dtype=torch.float32):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    return tgrid.HaloGrid.from_interior(
        torch.from_numpy(x).to(dtype), halo=radius,
        bc=bc if bc is not None else _bc(len(shape)), device="cpu")


def _axes(sizes):
    return ("x", "y")[:len(sizes)]


def _sharded(name, shape, sizes, k, **kw):
    return (ShardedKernelStencil(tspec.get_spec(name), shape,
                                 axis_names=_axes(sizes), sweeps_per_call=k,
                                 **kw),
            make_mesh(sizes, _axes(sizes), device="cpu"))


# ---- the partition and the race-freedom of the in-place exchange -----------


def _windows(plan, columns):
    """The padded-index box of every window of every tile of ``columns``
    (the kernel's arithmetic: origin = clamped start + H - k*r, extent t +
    2*k*r)."""
    kr, h = plan.halo, plan.layout.halo
    nt1 = plan.num_tiles[1]
    for col, s2 in itertools.product(columns, plan.tile_starts(2)):
        starts = (plan.tile_starts(0)[col // nt1],
                  plan.tile_starts(1)[col % nt1], s2)
        yield tuple(slice(s + h - kr, s + h - kr + t + 2 * kr)
                    for s, t in zip(starts, plan.tiles))


GEOMETRY = [  # spec, global shape, mesh, k, periodic, neumann
    ("jacobi7", (40, 36, 20), (2,), 1, (), ()),
    ("jacobi7", (44, 38, 21), (2,), 2, (), (1,)),   # ragged local blocks
    ("jacobi7", (56, 36, 20), (2,), 4, (1,), ()),
    ("star3d_r2", (60, 44, 20), (2,), 2, (0,), ()),
    ("jacobi27", (42, 50, 18), (2, 2), 2, (0,), (1,)),
    ("star3d_r2", (72, 64, 20), (2, 2), 4, (), ()),
    ("jacobi7", (66, 70, 19), (3, 2), 4, (1,), ()),
    ("laplace3d_ho", (64, 60, 20), (2, 2), 2, (), (0, 1)),
]


@pytest.mark.parametrize("name,shape,sizes,k,periodic,neumann", GEOMETRY)
def test_interior_windows_never_read_what_the_exchange_writes(
        name, shape, sizes, k, periodic, neumann):
    """For the full launch and a remainder launch: interior and edge
    columns partition the plan's columns; then every cell that the
    exchange (and the local refresh of an unsharded periodic or Neumann
    dim) writes, found by running it on blocks whose every cell holds a
    value of its own, lies outside every window of every interior column.
    So the interior launch and the in-place exchange can run at once."""
    method, mesh = _sharded(name, shape, sizes, k, tiles=(8, 8, 8))
    bc = _bc(3, periodic, neumann)
    plan = method.local_plan(sizes)
    padded = plan.layout.padded_shape
    for lp in launch_plans(plan, 1, max(k - 1, 1) if k > 1 else 0):
        interior, edge = partition_tiles(lp)
        nt = lp.num_tiles[0] * lp.num_tiles[1]
        assert interior and sorted(interior + edge) == list(range(nt))
        assert not set(interior) & set(edge)
        size = int(np.prod(padded))
        blocks = [torch.arange(size, dtype=torch.float64).reshape(padded)
                  + rank * size for rank in range(mesh.size)]
        before = [b.clone() for b in blocks]
        method.exchange(mesh, blocks, lp, bc)
        for rank, (b, b0) in enumerate(zip(blocks, before)):
            written = b != b0
            # a rank with a live face had its ghosts written
            assert written.any() == (0 in method.pins(mesh, rank, bc))
            for box in _windows(lp, interior):
                assert all(0 <= s.start and s.stop <= p
                           for s, p in zip(box, padded))
                assert not written[box].any(), (lp.sweeps_per_call, rank,
                                                box)


def test_partition_is_jax_rule_on_untiled_d2():
    """The port tiles d2 too; its columns follow JAX's rule per (i0, i1):
    a column is edge exactly when its window meets a d0 or d1 band."""
    plan = make_tiled_plan(tspec.get_spec("jacobi7"), (37, 29, 40),
                           "float32", 3, tiles=(8, 8, 16))
    interior, edge = partition_tiles(plan)
    kr = plan.halo
    for col in interior + edge:
        s0 = plan.tile_starts(0)[col // plan.num_tiles[1]]
        s1 = plan.tile_starts(1)[col % plan.num_tiles[1]]
        touches = (s0 < kr or s0 + 8 + kr > 37 or s1 < kr
                   or s1 + 8 + kr > 29)
        assert (col in edge) == touches
    assert len(interior) == 3 * 2 and len(edge) == 5 * 4 - 6


# ---- B1f: the plain version of a subset launch -----------------------------


def _emulated_subset(plan, cur, nxt, pins, subset, src=None):
    """The kernel's algorithm for a subset launch in torch: each listed
    column's tiles, each its window swept k times over the shrinking
    region where the kernel's update test says, the tile written into a
    copy of ``nxt``."""
    k, r, h = plan.sweeps_per_call, plan.spec.radius, plan.layout.halo
    out = nxt.clone()
    nt1 = plan.num_tiles[1]
    for col, s2 in itertools.product(subset, plan.tile_starts(2)):
        starts = (plan.tile_starts(0)[col // nt1],
                  plan.tile_starts(1)[col % nt1], s2)
        window = [(s + h - k * r, s + h + t + k * r)
                  for s, t in zip(starts, plan.tiles)]
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
                lo = h if d == 2 or pins[2 * d] else w0
                hi = h + plan.interior_shape[d] \
                    if d == 2 or pins[2 * d + 1] else w1
                shape = [1, 1, 1]
                shape[d] = -1
                mask &= ((idx >= lo) & (idx < hi)).reshape(shape)
            win[region] = torch.where(mask, new, win[region])
        out[tuple(slice(s + h, s + h + t)
                  for s, t in zip(starts, plan.tiles))] = \
            win[tuple(slice(k * r, k * r + t) for t in plan.tiles)]
    return out


def _padded_random(plan, seed, ghosts_of=None):
    """A random padded tensor of ``plan``; with ``ghosts_of``, that
    tensor's ghosts (an output's ghosts hold the walls, as the input's)."""
    rng = np.random.default_rng(seed)
    out = torch.from_numpy(rng.random(plan.layout.padded_shape,
                                      dtype=np.float32)).to(
        tgrid.torch_dtype(plan.dtype))
    if ghosts_of is not None:
        idx = plan.layout.interior_index
        out, interior = ghosts_of.clone(), out[idx]
        out[idx] = interior
    return out


@pytest.mark.parametrize("name,shape,k,tiles,pins,source,dtype", [
    ("jacobi7", (37, 29, 21), 3, (8, 8, 16), (1, 0, 0, 1), False,
     "float32"),
    ("jacobi27", (26, 30, 19), 2, (4, 8, 8), (0, 0, 0, 0), True, "float32"),
    ("star3d_r2", (30, 28, 20), 2, (8, 8, 16), (0, 1, 1, 0), True,
     "float32"),
    ("jacobi7", (37, 29, 21), 3, (8, 8, 16), (0, 0, 1, 1), False,
     "bfloat16"),
    ("jacobi7", (40, 36, 20), 4, (8, 8, 16), (1, 1, 0, 0), True,
     "bfloat16"),
])
def test_subset_pair_is_the_full_launch(name, shape, k, tiles, pins, source,
                                        dtype):
    """The interior launch then the edge launch into one output equal the
    full launch bitwise; a subset launch writes its columns only (the
    others keep the output's earlier values), as the kernel's window walk
    does; homogeneous and source modes, fp32 and bf16, with live faces."""
    plan = make_tiled_plan(tspec.get_spec(name), shape, dtype, k,
                           tiles=tiles, has_source=source)
    cur = _padded_random(plan, 1)
    nxt = _padded_random(plan, 2, ghosts_of=cur)
    src = _padded_random(plan, 3) if source else None
    interior, edge = partition_tiles(plan)
    assert interior and edge
    part = tiled_sweep(cur, nxt.clone(), plan, src, pins, subset=interior)
    assert torch.equal(part, _emulated_subset(plan, cur, nxt, pins,
                                              interior, src))
    untouched = torch.ones(plan.layout.padded_shape, dtype=torch.bool)
    for box in column_boxes(plan, interior):
        untouched[box] = False
    assert torch.equal(part[untouched], nxt[untouched])
    assert not torch.equal(part, nxt)
    both = tiled_sweep(cur, part, plan, src, pins, subset=edge)
    full = tiled_sweep(cur, nxt.clone(), plan, src, pins)
    assert torch.equal(both, full)


def test_subset_in_the_other_modes():
    """The Chebyshev, dual and coefficient modes take a subset too; their
    interior + edge pairs equal their full launches."""
    from stencil_tpu_torch.multigrid import nbsum_spec
    from stencil_tpu_torch.ops.tiled import coeff_operand, pad_coeff

    shape = (30, 28, 20)
    cheby = [(0.1, 0.2, -0.05, 0.3), (0.2, 0.1, 0.4, -0.2),
             (0.3, 0.15, 0.05, 0.1)]
    plans = [make_tiled_plan(nbsum_spec(3), shape, "float32", 3,
                             tiles=(8, 8, 16), has_source=True,
                             cheby_coeffs=cheby, cheby_dual=dual)
             for dual in (False, True)]
    plans.append(make_tiled_plan(tspec.get_spec("jacobi7"), shape, "float32",
                                 2, tiles=(8, 8, 16),
                                 coeff_scales=(0.1, 1.0, -0.1)))
    for plan in plans:
        cur = _padded_random(plan, 4)
        nxt = _padded_random(plan, 5, ghosts_of=cur)
        kw = {}
        if plan.cheby_coeffs:
            kw["src"] = _padded_random(plan, 6)
        if plan.cheby_dual:
            kw["out2"] = _padded_random(plan, 7, ghosts_of=cur)
        if plan.has_coeff:
            a = np.random.default_rng(8).random(shape) + 0.5
            kw["coeff"] = coeff_operand(plan, pad_coeff(plan, a, _bc(3)))
        interior, edge = partition_tiles(plan)
        full = tiled_sweep(cur, nxt.clone(), plan, **{
            key: (v.clone() if key == "out2" else v)
            for key, v in kw.items()})
        out2 = kw.pop("out2", None)
        part = tiled_sweep(cur, nxt.clone(), plan, subset=interior,
                           out2=None if out2 is None else out2.clone(), **kw)
        if out2 is None:
            got = tiled_sweep(cur, part, plan, subset=edge, **kw)
            assert torch.equal(got, full)
        else:
            got = tiled_sweep(cur, part[0], plan, subset=edge, out2=part[1],
                              **kw)
            assert torch.equal(got[0], full[0])
            assert torch.equal(got[1], full[1])


def test_subset_refusals_match_jax():
    jsp = jspec.get_spec("jacobi7")
    jbc = jgrid.DirichletBC.reference_default(3)
    sp = tspec.get_spec("jacobi7")
    for two_level, subset in ((True, (0,)), (False, (0, 99))):
        jplan = jmake_tiled_plan(jsp, (16, 16, 128), sweeps_per_call=2,
                                 two_level=two_level)
        with pytest.raises(ValueError) as want:
            build_tiled_sweep(jplan, jbc, interpret=True, subset=subset)
        # JAX's tiles in d0 and d1, so that the column counts agree
        plan = make_tiled_plan(sp, (16, 16, 128), "float32", 2,
                               tiles=(jplan.s0, jplan.t1, 16),
                               two_level=two_level)
        cur = torch.zeros(plan.layout.padded_shape)
        kw = dict(prev=cur.clone(), out2=cur.clone()) if two_level else {}
        with pytest.raises(ValueError) as got:
            tiled_sweep(cur, cur.clone(), plan, subset=subset, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no tile subset"):
        from stencil_tpu_torch.ops.slab import make_slab_plan
        from stencil_tpu_torch.ops.slab_kernel import slab_sweep

        splan = make_slab_plan(tspec.get_spec("jacobi5"), (16, 16))
        z = torch.zeros(splan.layout.padded_shape)
        slab_sweep(z, z.clone(), splan, subset=(0,))


def test_subset_counts():
    plan = make_tiled_plan(tspec.get_spec("jacobi7"), (40, 36, 20),
                           "float32", 2, has_source=True)
    cur = _padded_random(plan, 1)
    interior, edge = partition_tiles(plan)
    tiled_sweep.reset_counts()
    tiled_sweep(cur, cur.clone(), plan, cur.clone(), subset=interior)
    tiled_sweep(cur, cur.clone(), plan, subset=edge)
    # CPU tensors run the plain version, which counts no launch
    assert tiled_sweep.launches == tiled_sweep.subset_launches == 0
    assert tiled_sweep.source_subset_launches == 0
    assert "subset_launches" in tiled_sweep.MODE_COUNTS


# ---- ShardedKernelStencil ---------------------------------------------------


@pytest.mark.parametrize("name,shape,sizes,k,iters", [
    ("jacobi7", (24, 20, 28), (2,), 3, 9),
    ("jacobi7", (24, 20, 28), (4,), 3, 7),          # a remainder
    ("jacobi7", (24, 20, 28), (2, 2), 3, 8),
    ("jacobi27", (16, 20, 12), (2, 2), 2, 5),
    ("star3d_r2", (32, 24, 16), (2, 2), 2, 5),      # radius 2 at k > 1
    ("jacobi7", (26, 22, 17), (2, 2), 2, 5),        # ragged local blocks
])
def test_sharded_kernel_matches_golden_jax_and_single_device(
        name, shape, sizes, k, iters):
    sp = tspec.get_spec(name)
    method, mesh = _sharded(name, shape, sizes, k)
    g = _grid(shape, sp.radius)
    got = method.iterate(g, iters, mesh)
    assert got.bc == g.bc and got.data.shape == g.data.shape
    x0 = g.interior().double().numpy()
    ref = golden.golden_iterate(x0, sp, iters, bc=g.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=TOL_GOLDEN, rtol=0)
    single = TiledStencil(sp, shape, sweeps_per_call=k,
                          device="cpu").iterate(g, iters)
    assert torch.equal(got.interior(), single.interior())
    axes = _axes(sizes) + (None,) * (3 - len(sizes))
    jg = jgrid.HaloGrid.from_interior(
        jnp.asarray(g.interior().numpy()), halo=sp.radius,
        bc=jgrid.DirichletBC.reference_default(3))
    want = JShardedStencil(jspec.get_spec(name), axes).iterate(
        jg, iters, jmake_mesh(sizes, _axes(sizes)))
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()),
                               rtol=TOL_JAX, atol=TOL_JAX)


@pytest.mark.parametrize("sizes", [(2,), (2, 2)])
def test_sharded_kernel_bf16(sizes):
    """bf16 blocks: bitwise the single-device bf16 tiled iterate, and
    within the bf16 bar of the golden."""
    sp = tspec.get_spec("jacobi7")
    shape = (24, 20, 16)
    method, mesh = _sharded("jacobi7", shape, sizes, 3, dtype="bfloat16")
    g = _grid(shape, 1, dtype=torch.bfloat16)
    got = method.iterate(g, 7, mesh)
    assert got.dtype == torch.bfloat16
    single = TiledStencil(sp, shape, "bfloat16", sweeps_per_call=3,
                          device="cpu").iterate(g, 7)
    assert torch.equal(got.interior(), single.interior())
    ref = golden.golden_iterate(g.interior().double().numpy(), sp, 7,
                                bc=g.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=TOL_BF16, rtol=0)


@pytest.mark.parametrize("name,shape,sizes,k,periodic,neumann", [
    ("jacobi7", (48, 80, 16), (2, 2), 3, (), ()),
    ("jacobi27", (96, 40, 12), (4,), 2, (0,), (1,)),
    ("jacobi7", (48, 80, 12), (2, 2), 2, (0, 1), ()),
    ("jacobi27", (48, 80, 12), (2, 2), 2, (), (0, 1)),
])
def test_overlap_is_bitwise_the_fused_step(name, shape, sizes, k, periodic,
                                           neumann):
    """The interior launch, the in-place exchange and the edge launch
    equal the exchange and one launch, over steps and a remainder."""
    sp = tspec.get_spec(name)
    g = _grid(shape, sp.radius, _bc(3, periodic, neumann))
    a, mesh = _sharded(name, shape, sizes, k, overlap=True, tiles=(8, 8, 8))
    b, _ = _sharded(name, shape, sizes, k, overlap=False, tiles=(8, 8, 8))
    assert all(partition_tiles(a.local_plan(sizes)))  # a real split
    assert torch.equal(a.iterate(g, 2 * k + 1, mesh).interior(),
                       b.iterate(g, 2 * k + 1, mesh).interior())


@pytest.mark.parametrize("k,periodic,neumann", [(2, (), ()), (3, (0,), ()),
                                                (2, (), (0,))])
def test_2d_grid_runs_the_slab_kernel_over_d0(k, periodic, neumann):
    """A 2D grid on a 1D mesh: the slab kernel per rank, no split, bitwise
    the single-device slab iterate, and within the golden bar."""
    sp = tspec.get_spec("jacobi5")
    shape = (64, 40)
    g = _grid(shape, 1, _bc(2, periodic, neumann))
    method, mesh = _sharded("jacobi5", shape, (4,), k)
    assert type(method.local_plan((4,))).__name__ == "SlabPlan"
    got = method.iterate(g, 2 * k + 1, mesh)
    single = SlabStencil(sp, shape, sweeps_per_call=k,
                         device="cpu").iterate(g, 2 * k + 1)
    assert torch.equal(got.interior(), single.interior())
    ref = golden.golden_iterate(g.interior().double().numpy(), sp,
                                2 * k + 1, bc=g.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=TOL_GOLDEN, rtol=0)


DYNAMIC = [  # JAX's tests/test_pallas_sharded.py:325-438
    ("jacobi7", (4,), 1, (0,), ()),
    ("jacobi7", (4,), 4, (0,), ()),
    ("jacobi7", (4,), 4, (), (0,)),
    ("jacobi7", (4,), 2, (1,), ()),
    ("jacobi7", (4,), 2, (), (1,)),
    ("jacobi27", (4,), 2, (0,), (1,)),
    ("jacobi7", (4, 2), 2, (0, 1), ()),
    ("jacobi27", (4, 2), 2, (), (0, 1)),
    ("jacobi7", (4, 2), 2, (0,), (1,)),
    ("jacobi7", (1,), 2, (0,), (1,)),               # degenerate mesh
]


@pytest.mark.parametrize("name,sizes,k,periodic,neumann", DYNAMIC)
def test_dynamic_walls_match_golden_and_single_device(name, sizes, k,
                                                      periodic, neumann):
    """Periodic and Neumann walls on sharded and unsharded dims: within the
    golden bar, and bitwise the single-device tiled iterate."""
    sp = tspec.get_spec(name)
    shape = (16, 12, 20)
    g = _grid(shape, sp.radius, _bc(3, periodic, neumann), seed=31)
    method, mesh = _sharded(name, shape, sizes, k)
    iters = 2 * k + 1
    got = method.iterate(g, iters, mesh)
    ref = golden.golden_iterate(g.interior().double().numpy(), sp, iters,
                                bc=g.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=TOL_GOLDEN, rtol=TOL_GOLDEN)
    single = TiledStencil(sp, shape, sweeps_per_call=k,
                          device="cpu").iterate(g, iters)
    assert torch.equal(got.interior(), single.interior())


@pytest.mark.parametrize("periodic,neumann", [((0,), ()), ((), (0,))])
def test_2d_grid_dynamic_d0_matches_jax_sharded(periodic, neumann):
    shape = (64, 40)
    jbc = jgrid.DirichletBC.reference_default(2).with_periodic(
        periodic).with_neumann(neumann)
    tbc = convert.bc_from_arrays(jbc.values, jbc.periodic, jbc.neumann)
    g = _grid(shape, 1, tbc, seed=31)
    method, mesh = _sharded("jacobi5", shape, (4,), 2)
    got = method.iterate(g, 6, mesh)
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(g.interior().numpy()),
                                      halo=1, bc=jbc)
    want = JShardedStencil(jspec.get_spec("jacobi5"), ("x", None)).iterate(
        jg, 6, jmake_mesh((4,), ("x",)))
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()),
                               rtol=TOL_JAX, atol=TOL_JAX)


def _jax_local_plan_error(shape, sizes, name="jacobi7", has_source=False):
    axes = ("x", "y", "z")[:len(sizes)]
    with pytest.raises(ValueError) as want:
        ShardedPallasStencil(jspec.get_spec(name), shape, axis_names=axes,
                             sweeps_per_call=2, interpret=True,
                             has_source=has_source).local_plan(sizes)
    return str(want.value)


@pytest.mark.parametrize("shape,sizes,name,has_source", [
    ((16, 16, 16), (2, 2, 2), "jacobi7", False),   # 3-axis mesh
    ((64, 40), (2, 2), "jacobi5", False),          # 2-axis on a 2D grid
    ((30, 16, 16), (4,), "jacobi7", False),        # indivisible
    ((16, 30, 16), (2, 4), "jacobi7", False),
    ((64, 40), (4,), "jacobi5", True),             # a 2D source
])
def test_local_plan_gates_match_jax(shape, sizes, name, has_source):
    axes = ("x", "y", "z")[:len(sizes)]
    with pytest.raises(ValueError) as got:
        ShardedKernelStencil(tspec.get_spec(name), shape, axis_names=axes,
                             sweeps_per_call=2,
                             has_source=has_source).local_plan(sizes)
    assert str(got.value) == _jax_local_plan_error(shape, sizes, name,
                                                   has_source)


@pytest.mark.parametrize("argv", [
    ["-s", "16", "12", "20", "--spec", "jacobi7", "-k", "2", "--periodic",
     "2"],
    ["-s", "16", "12", "20", "--spec", "laplace3d_ho", "-k", "1",
     "--mesh", "2", "2", "2"],
    ["-s", "16", "12", "20", "--spec", "jacobi7", "--mesh", "3"],
])
def test_registry_gates_match_jax(argv):
    """The eager refusals of ``sharded_pallas`` (a dynamic lane dim, a
    3-axis mesh, an indivisible dim) carry JAX's messages."""
    from stencil_tpu import cli as jcli
    from stencil_tpu.config import parse_args as jparse
    from stencil_tpu_torch.config import parse_args

    if "--mesh" not in argv:
        argv = [*argv, "--mesh", "4"]
    jcfg = jparse([*argv, "-m", "sharded_pallas"])
    jsp = jcfg.resolved_spec()
    with pytest.raises(ValueError) as want:
        jregistry.get_runner("sharded_pallas", jcfg, jsp,
                             jcli.make_grid(jcfg, jsp))
    cfg = parse_args([*argv, "-m", "sharded_pallas", "--device", "cpu"])
    sp = cfg.resolved_spec()
    with pytest.raises(ValueError) as got:
        registry.get_runner("sharded_pallas", cfg, sp, cli.make_grid(cfg, sp))
    assert str(got.value) == str(want.value)


def test_iterate_gates():
    method, mesh = _sharded("jacobi7", (16, 12, 20), (4,), 2)
    g = _grid((16, 12, 20), 1)
    with pytest.raises(ValueError, match="pass source= iff"):
        method.iterate(g, 2, mesh, source=np.zeros((16, 12, 20)))
    with pytest.raises(ValueError, match="grid dtype bfloat16 != plan dtype"):
        method.iterate(_grid((16, 12, 20), 1, dtype=torch.bfloat16), 2, mesh)
    deep, mesh8 = _sharded("jacobi7", (16, 12, 20), (8,), 4)
    with pytest.raises(ValueError, match="below the exchange depth"):
        deep.iterate(g, 4, mesh8)


def test_registry_plan_info_and_default_mesh():
    cfg = RunConfig(size=(24, 20, 28), spec="jacobi7", device="cpu",
                    temporal=3, mesh=(2, 2))
    sp = cfg.resolved_spec()
    runner = registry.get_runner("sharded_pallas", cfg, sp,
                                 cli.make_grid(cfg, sp))
    info = runner.plan_info
    assert runner.name == "sharded_pallas(mesh=2x2,k=3)"
    assert runner.granularity == 3 and info["local_shape"] == [12, 10, 28]
    plan = make_tiled_plan(sp, (12, 10, 28), "float32", 3)
    interior, edge = partition_tiles(plan)
    assert info["tiles"] == list(plan.tiles)
    assert (info["interior_columns"], info["edge_columns"]) == (
        len(interior), len(edge))
    assert info["split"] == bool(interior and edge)
    kr, p2 = 3, 28 + 6
    assert info["exchange_bytes_per_step"] == \
        (2 * kr * 10 * p2 + 2 * kr * (12 + 2 * kr) * p2) * 4
    cfg.mesh = ()  # one rank on the CPU: the fused step, tiled bitwise
    runner = registry.get_runner("sharded_pallas", cfg, sp,
                                 cli.make_grid(cfg, sp))
    assert runner.plan_info["mesh"] == [1] and not runner.plan_info["split"]
    g = cli.make_grid(cfg, sp)
    tiled = registry.get_runner("tiled", cfg, sp, g)
    assert torch.equal(runner.iterate(g, 7).interior(),
                       tiled.iterate(g, 7).interior())


# ---- the sharded Poisson runner ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_poisson_sharded_runner(dtype):
    """(2, 2) mesh, periodic d0 and Neumann d1: bitwise the single-device
    Poisson tiled runner; in fp32 within 1e-6 relative of JAX's ``xla``
    Poisson runner."""
    shape, k, iters = (16, 12, 10), 2, 5
    jbc = jgrid.DirichletBC.zero(3).with_periodic((0,)).with_neumann((1,))
    tbc = convert.bc_from_arrays(jbc.values, jbc.periodic, jbc.neumann)
    rng = np.random.default_rng(11)
    f = rng.normal(size=shape) * 50.0
    u0 = rng.random(shape).astype(np.float32)
    prob = poisson.PoissonProblem(shape=shape, bc=tbc, dtype=dtype,
                                  device="cpu")
    mesh = make_mesh((2, 2), ("x", "y"), device="cpu")
    runner = prob.sharded_runner(f, mesh, sweeps_per_call=k,
                                 axis_names=("x", "y"))
    assert runner.granularity == k and runner.plan_info["mesh"] == [2, 2]
    g = prob.initial_grid(u0)
    got = runner.iterate(g, iters)
    single = prob.runner(f, method="tiled", sweeps_per_call=k).iterate(g,
                                                                       iters)
    assert torch.equal(got.interior(), single.interior())
    if dtype == "float32":
        jprob = jpoisson.PoissonProblem(shape=shape, bc=jbc)
        jg = jprob.initial_grid(jnp.asarray(u0))
        want = jprob.runner(f, method="xla").iterate(jg, iters)
        scale = float(np.abs(np.asarray(want.interior())).max())
        np.testing.assert_allclose(got.interior().numpy(),
                                   np.asarray(want.interior()),
                                   rtol=TOL_JAX, atol=TOL_JAX * scale)


def test_poisson_sharded_source_exchanged_like_pad_source():
    """The source blocks after their one exchange hold, on every cell a
    launch reads, the single-device padded source's values."""
    shape = (16, 12, 10)
    bc = tgrid.DirichletBC.zero(3).with_periodic((0,)).with_neumann((1,))
    f = np.random.default_rng(12).normal(size=shape)
    sp = tspec.star(3, 1)
    mesh = make_mesh((2, 2), ("x", "y"), device="cpu")
    method = ShardedKernelStencil(sp, shape, axis_names=("x", "y"),
                                  sweeps_per_call=2, has_source=True)
    plan = method.local_plan((2, 2))
    blocks = method._scatter_source(plan, mesh, f, -0.01, bc)
    full = pad_source(make_tiled_plan(sp, shape, "float32", 2), f, -0.01, bc)
    h = plan.layout.halo
    for rank, block in enumerate(blocks):
        i0, i1 = mesh.coords(rank)
        n0, n1 = plan.interior_shape[:2]
        # the block's interior and its d0/d1 ghost bands, the d2 interior
        got = block[:, :, h:-h]
        want = full[i0 * n0:i0 * n0 + n0 + 2 * h,
                    i1 * n1:i1 * n1 + n1 + 2 * h, h:-h]
        assert torch.equal(got, want)
