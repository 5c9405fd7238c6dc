"""The ``rma`` method of the port (stencil_tpu_torch/parallel/rma.py, B3's
port ``csrc/rma_iterate.cu`` through its plain version): every rank's
blocks resident for a whole run, strips pushed between ranks inside one
launch. Held against the float64 golden, JAX's ``RmaStencil`` in interpret
mode (tiny cases) and JAX's ``xla`` iterate, the port's single-device
plain results, ``sharded_pallas --no-overlap``, JAX's gates, and, in pure
Python, the tables the kernel and the plain version walk (Dirichlet walls
in fp32; tests/test_torch_rma_pins.py holds periodic and Neumann walls and
bf16). The kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py.

Tolerances: vs the golden and vs JAX 5e-6 (the JAX suite's own,
tests/test_rma.py:32-34); vs the port's single-device and sharded runs
bitwise (the same taps in the same order at every point)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.ops import xla as jxla
from stencil_tpu.parallel.halo import make_mesh as jmake_mesh
from stencil_tpu.parallel.rma import RmaStencil as JRmaStencil
from stencil_tpu.parallel.rma import make_rma_plan as jmake_rma_plan
from stencil_tpu_torch import cli, convert, registry
from stencil_tpu_torch.config import RunConfig, parse_args
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.layout import PaddedLayout
from stencil_tpu_torch.ops.slab import SlabStencil
from stencil_tpu_torch.ops.tiled import TiledStencil
from stencil_tpu_torch.parallel import comm_audit
from stencil_tpu_torch.parallel.mesh import Mesh, make_mesh
from stencil_tpu_torch.parallel.rma import (
    H100_L2_BYTES, RmaStencil, _geometry, buffer_of, cross_card_bytes_per_step,
    device_table, exchange_reference, make_rma_plan, push_bytes_per_step,
    rma_iterate, rma_iterate_reference, rma_tables, rma_tiles,
)
from stencil_tpu_torch.parallel.sharded_kernel import ShardedKernelStencil

TOL = 5e-6
# distinct face values, so a corner that takes the wrong face shows
BC = {2: ((0.5, -1.0), (2.0, 0.25)),
      3: ((0.5, -1.0), (2.0, 0.25), (1.0, 1.5))}


def _spec(name):
    """A spec by name, or ``star:ndim:r``/``box:ndim:r``."""
    if ":" in name:
        kind, ndim, r = name.split(":")
        return getattr(tspec, kind)(int(ndim), int(r))
    return tspec.get_spec(name)


def _jspec(name):
    if ":" in name:
        kind, ndim, r = name.split(":")
        return getattr(jspec, kind)(int(ndim), int(r))
    return jspec.get_spec(name)


def _axes(sizes):
    return ("x", "y")[:len(sizes)]


def _x(shape, seed=3):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _grid(x, radius):
    return tgrid.HaloGrid.from_interior(
        torch.from_numpy(x), halo=radius,
        bc=tgrid.DirichletBC(values=BC[x.ndim]), device="cpu")


def _jgrid(x, radius):
    return jgrid.HaloGrid.from_interior(
        jnp.asarray(x), halo=radius, bc=jgrid.DirichletBC(values=BC[x.ndim]))


def _rma(name, shape, sizes, k, x, iters):
    sp = _spec(name)
    g = _grid(x, sp.radius)
    mesh = make_mesh(sizes, _axes(sizes), device="cpu")
    return g, RmaStencil(sp, shape, sweeps_per_call=k).iterate(g, iters, mesh)


# the JAX suite's cases (tests/test_rma.py:42-124): spec, shape, mesh, k,
# iterations
CASES = [
    ("jacobi5", (64, 40), (4,), 1, 8),            # 2D star
    ("jacobi5", (64, 40), (4,), 1, 7),            # odd: the final slot
    ("star:2:2", (64, 40), (4,), 1, 6),           # radius 2
    ("box:2:1", (64, 40), (4,), 1, 6),            # box
    ("jacobi7", (16, 12, 20), (4,), 1, 6),        # 3D star
    ("jacobi5", (32, 40), (1,), 1, 5),            # a single rank
    ("jacobi5", (32, 40), (2,), 1, 5),            # two ranks
    ("jacobi5", (64, 40), (4,), 2, 8),            # k = 2
    ("jacobi5", (64, 40), (4,), 4, 12),           # k = 4
    ("jacobi5", (64, 40), (4,), 4, 10),           # k = 4, a remainder
    ("box:2:1", (64, 40), (4,), 2, 8),            # a temporal box
    ("jacobi7", (16, 16, 20), (4,), 2, 8),        # temporal 3D
    ("jacobi7", (16, 32, 20), (2, 4), 1, 6),      # 2D mesh
    ("box:3:1", (16, 32, 20), (2, 4), 1, 6),      # 3D box corners
    ("box:3:1", (16, 32, 20), (2, 4), 2, 7),      # ... temporal
    ("jacobi7", (16, 32, 20), (2, 4), 2, 8),      # 2D mesh, temporal
    ("star:3:2", (32, 32, 20), (2, 2), 1, 6),     # radius 2 on (2, 2)
    ("star:3:2", (32, 32, 20), (2, 2), 2, 5),
    ("jacobi5", (32, 256), (2, 2), 1, 6),         # 2D grid on (2, 2)
    ("jacobi5", (32, 256), (2, 2), 2, 8),
]


@pytest.mark.parametrize("name,shape,sizes,k,iters", CASES)
def test_matches_golden_jax_and_single_device(name, shape, sizes, k, iters):
    """Within 5e-6 of the float64 golden and of JAX's ``xla`` iterate;
    bitwise the port's single-device plain result (``tiled`` in 3D,
    ``slab`` in 2D) and, where that method takes the mesh,
    ``sharded_pallas --no-overlap``."""
    sp = _spec(name)
    x = _x(shape)
    g, got = _rma(name, shape, sizes, k, x, iters)
    out = got.interior().double().numpy()
    ref = golden.golden_iterate(x.astype(np.float64), sp, iters, bc=g.bc)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    want = jxla.iterate(_jgrid(x, sp.radius), _jspec(name), iters)
    np.testing.assert_allclose(out, np.asarray(want.interior()), atol=TOL,
                               rtol=TOL)
    single = (TiledStencil if len(shape) == 3 else SlabStencil)(
        sp, shape, sweeps_per_call=k, device="cpu").iterate(g, iters)
    assert torch.equal(got.interior(), single.interior())
    if len(shape) == 3 or len(sizes) == 1:
        sharded = ShardedKernelStencil(sp, shape, axis_names=_axes(sizes),
                                       sweeps_per_call=k, overlap=False)
        mesh = make_mesh(sizes, _axes(sizes), device="cpu")
        assert torch.equal(got.interior(),
                           sharded.iterate(g, iters, mesh).interior())


@pytest.mark.parametrize("name,shape,sizes,k,iters", [
    ("jacobi5", (32, 40), (2,), 1, 5),
    ("jacobi5", (32, 40), (2,), 2, 5),
    ("jacobi7", (16, 16, 20), (2, 2), 2, 2),
])
def test_matches_jax_rma_in_interpret_mode(name, shape, sizes, k, iters):
    """JAX's own ``RmaStencil`` (interpret mode on its CPU mesh, as
    tests/test_rma.py runs it), within 5e-6."""
    sp = _jspec(name)
    x = _x(shape, seed=9)
    _, got = _rma(name, shape, sizes, k, x, iters)
    want = JRmaStencil(sp, shape, sweeps_per_call=k, interpret=True).iterate(
        _jgrid(x, sp.radius), iters, jmake_mesh(sizes, _axes(sizes)))
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=TOL,
                               rtol=TOL)


# ---- the gates --------------------------------------------------------------


def _both_refuse(port_fn, jax_fn):
    with pytest.raises(ValueError) as want:
        jax_fn()
    with pytest.raises(ValueError) as got:
        port_fn()
    return str(got.value), str(want.value)


@pytest.mark.parametrize("shape,sizes,k", [
    ((30, 16, 16), (4,), 1),       # indivisible d0
    ((16, 30, 16), (2, 4), 1),     # indivisible d1
    ((16, 12, 20), (4,), 3),       # local 4 < 2*k*r = 6
    ((16, 12, 20), (2, 2, 1), 1),  # a 3-axis mesh
])
def test_plan_gates_match_jax(shape, sizes, k):
    got, want = _both_refuse(
        lambda: RmaStencil(tspec.get_spec("jacobi7"), shape,
                           sweeps_per_call=k).local_plan(sizes),
        lambda: JRmaStencil(jspec.get_spec("jacobi7"), shape,
                            sweeps_per_call=k).local_plan(sizes))
    assert got == want


def test_a_local_extent_off_the_dma_granule_runs():
    """JAX refuses a sharded local extent off its DMA granule (d1 local 6,
    not a multiple of the 8-row sublane); the port's ghosts are exactly
    k*r deep and it runs, within the golden bar."""
    shape, sizes = (16, 12, 20), (2, 2)
    with pytest.raises(ValueError, match="multiple of the DMA granule 8"):
        JRmaStencil(jspec.get_spec("jacobi7"), shape).local_plan(sizes)
    x = _x(shape)
    g, got = _rma("jacobi7", shape, sizes, 2, x, 5)
    ref = golden.golden_iterate(x.astype(np.float64),
                                tspec.get_spec("jacobi7"), 5, bc=g.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=TOL, rtol=TOL)


def test_budget_refusal_names_the_l2_and_the_way_out():
    """JAX's message with the card's budget: every rank's buffers on one
    card against its L2. 128^3 at k=2 runs (JAX refuses it on a TPU,
    bench.py:102-105); 160^3 is the first size refused on one rank."""
    sp, jsp = tspec.get_spec("jacobi7"), jspec.get_spec("jacobi7")
    plan = make_rma_plan(sp, (128, 128, 128), mesh_shape=(1,),
                         sweeps_per_call=2)
    assert plan.resident_bytes == 3 * 132 ** 3 * 4
    got, want = _both_refuse(
        lambda: make_rma_plan(sp, (160, 160, 160), mesh_shape=(1,),
                              sweeps_per_call=2),
        lambda: jmake_rma_plan(jsp, (1024, 1024, 1024), mesh_shape=(1,),
                               sweeps_per_call=2))
    for msg in (got, want):
        assert re.search(r"exceeds the \w+-resident budget", msg)
        assert msg.endswith("use the sharded_pallas method for blocks "
                            "this large")
    assert "L2-resident budget 52428800" in got
    with pytest.raises(ValueError, match="x4 ranks on one card"):
        make_rma_plan(sp, (96, 96, 128), mesh_shape=(2, 2),
                      sweeps_per_call=2)


@pytest.mark.parametrize("argv", [
    ["--periodic", "0"], ["--neumann", "1"], ["--dtype", "bfloat16"],
])
def test_dynamic_walls_and_bf16_run_through_the_registry(argv):
    """The runs once refused as "not ported yet (B3-pins / B3-bf16)": the
    registry's runner and ``RmaStencil.iterate`` agree bitwise and are
    within the golden's bar (5e-6, bf16 3e-2);
    tests/test_torch_rma_pins.py holds every case of JAX's suite."""
    cfg = parse_args(["-s", "16", "12", "20", "--spec", "jacobi7", "-m",
                      "rma", "--mesh", "2", "-k", "2", "--device", "cpu",
                      *argv])
    sp = cfg.resolved_spec()
    g = cli.make_grid(cfg, sp)
    got = registry.get_runner("rma", cfg, sp, g).iterate(g, 5)
    again = RmaStencil(sp, (16, 12, 20), tgrid.dtype_name(g.dtype),
                       2).iterate(g, 5, make_mesh((2,), ("x",),
                                                  device="cpu"))
    assert torch.equal(got.interior(), again.interior())
    tol = 3e-2 if "bfloat16" in argv else TOL
    ref = golden.golden_iterate(g.interior().double().numpy(), sp, 5,
                                bc=g.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=tol, rtol=tol)


def test_a_mesh_over_two_cards_plans_on_the_cpu():
    """A (2, 2) mesh over cuda:0 and cuda:1 by ``make_mesh``'s round robin
    plans without a CUDA call (the budget passed in): card 0 holds ranks 0
    and 2, card 1 ranks 1 and 3, each card's L2 two ranks' buffers (the
    one-card plan of the same mesh needs four); every pair's source lies
    on its tile's card, and the pairs that cross cards are d1's ghosts,
    since d0's neighbours share a card."""
    mesh = Mesh(shape=(2, 2), axis_names=("x", "y"),
                devices=tuple(torch.device("cuda", i % 2) for i in range(4)))
    method = RmaStencil(tspec.get_spec("jacobi7"), (16, 12, 20),
                        sweeps_per_call=2)
    plan = method.plan_for(mesh, budget=H100_L2_BYTES)
    assert plan.cards == (0, 1, 0, 1) and not plan.virtual
    assert plan.card_ranks == ((0, 2), (1, 3))
    assert plan.device_ranks == (2, 2) and plan.rank_order == (0, 2, 1, 3)
    two = plan.resident_bytes // 2
    assert method.plan_for(mesh, budget=two).cards == plan.cards
    with pytest.raises(ValueError, match="x2 ranks on one card"):
        method.plan_for(mesh, budget=two - 1)
    one = Mesh(shape=(2, 2), axis_names=("x", "y"),
               devices=(torch.device("cuda", 0),) * 4)
    with pytest.raises(ValueError, match="x4 ranks on one card"):
        method.plan_for(one, budget=two)
    tiles = rma_tiles(plan)
    geom = _geometry(plan, 3, 0)
    table = device_table(plan, torch.device("cpu")).numpy()
    pairs = table[geom[30]:geom[30] + 4 * len(tiles.pairs)].reshape(-1, 4)
    block = int(np.prod(plan.block_shape))
    d_rank = tiles.pairs[:, 0] // block
    assert (pairs[:, 0] == np.asarray(plan.cards)[d_rank]).all()
    writer = np.repeat(tiles.card, np.diff(tiles.pair_ptr))
    assert (np.asarray(plan.cards)[tiles.pairs[:, 1] // block]
            == writer).all()
    assert (pairs[:, 1:3] < 2 * plan.num_buffers * block).all()
    cross = writer != pairs[:, 0]
    d1 = np.unravel_index(tiles.pairs[cross, 0] % block,
                          plan.block_shape)[1]
    h, n1 = plan.layout.halo, plan.local_shape[1]
    assert cross.any() and ((d1 < h) | (d1 >= h + n1)).all()
    assert cross_card_bytes_per_step(plan) == cross.sum() * 4


def test_registry_refusals_match_jax():
    """A 3-axis ``--mesh`` through the registry, as JAX's ``make_rma``."""
    from stencil_tpu import cli as jcli
    from stencil_tpu import registry as jregistry
    from stencil_tpu.config import parse_args as jparse

    argv = ["-s", "16", "12", "20", "--spec", "jacobi7", "-m", "rma",
            "--mesh", "2", "2", "1"]
    jcfg = jparse(argv)
    jsp = jcfg.resolved_spec()
    cfg = parse_args([*argv, "--device", "cpu"])
    sp = cfg.resolved_spec()
    got, want = _both_refuse(
        lambda: registry.get_runner("rma", cfg, sp, cli.make_grid(cfg, sp)),
        lambda: jregistry.get_runner("rma", jcfg, jsp,
                                     jcli.make_grid(jcfg, jsp)))
    assert got == want


def test_wrapper_checks():
    plan = make_rma_plan(tspec.get_spec("jacobi7"), (8, 6, 5),
                         mesh_shape=(2,), sweeps_per_call=2)
    bufs = torch.zeros(plan.buffer_shape)
    with pytest.raises(ValueError, match="buffers shape"):
        rma_iterate(bufs[:, :2], plan, 1)
    with pytest.raises(ValueError, match="n_steps 0"):
        rma_iterate(bufs, plan, 0)
    with pytest.raises(ValueError,
                       match="buffers dtype float64 != plan dtype float32"):
        rma_iterate(bufs.double(), plan, 1)
    with pytest.raises(ValueError, match=r"sweeps 3 outside \[1, 2\]"):
        plan.with_sweeps(3)


# ---- the exchange: no ppermute, the bytes it moves --------------------------


def test_iterate_records_no_ppermute():
    """The strips move inside the launch: an audit around an iterate
    records no ``ppermute``, as JAX's jaxpr holds none
    (tests/test_comm_volume.py:109-125)."""
    x = _x((16, 32, 20))
    with comm_audit.audit() as rec:
        _rma("jacobi7", (16, 32, 20), (2, 2), 2, x, 5)
    assert rec.ppermute_count == 0 and rec.ppermute_bytes == 0


@pytest.mark.parametrize("local,sizes,k,name", [
    ((8, 10, 12), (3,), 2, "jacobi7"), ((8, 10, 12), (3, 3), 1, "box:3:1"),
    ((12, 20), (3,), 3, "star:2:2"), ((12, 20), (3, 3), 2, "jacobi5"),
])
def test_push_bytes_are_what_the_plain_version_copies(local, sizes, k, name):
    """``push_bytes_per_step`` is what the mesh-centre rank pushes in the
    plain version's exchange, and the same on a larger mesh (the
    counterpart of tests/test_comm_volume.py:127-157)."""
    sp = _spec(name)
    plan = make_rma_plan(sp, local, mesh_shape=sizes, sweeps_per_call=k)
    centre = plan.ranks // 2
    pushed = exchange_reference(torch.zeros(plan.buffer_shape), plan, 0)
    assert pushed[centre] * 4 == push_bytes_per_step(plan)
    bigger = make_rma_plan(sp, local, mesh_shape=tuple(2 * n for n in sizes),
                           sweeps_per_call=k)
    assert push_bytes_per_step(bigger) == push_bytes_per_step(plan)
    kr, nd = k * sp.radius, len(local)
    full = [n + 2 * kr for n in local]
    want = 2 * kr * np.prod(full[1:]) if len(sizes) == 1 else (
        2 * kr * local[1] * np.prod(full[2:])
        + 2 * kr * full[0] * np.prod(full[2:]))
    assert push_bytes_per_step(plan) == want * 4 and nd in (2, 3)


# ---- the tables (pure Python) -----------------------------------------------

GEOMETRY = [  # spec, local shape, mesh, k
    ("jacobi7", (6, 7, 5), (3,), 2),
    ("box:3:1", (6, 7, 5), (3, 2), 3),
    ("star:3:2", (8, 9, 5), (2, 3), 2),
    ("jacobi5", (6, 9), (2, 3), 3),
    ("box:2:1", (6, 9), (4,), 1),
    ("jacobi7", (9, 8, 4), (3, 3), 4),
]


def _plans(name, local, sizes, k):
    plan = make_rma_plan(_spec(name), local, mesh_shape=sizes,
                         sweeps_per_call=k)
    return [plan.with_sweeps(j) for j in range(1, k + 1)]


def _mask(shape, box):
    m = np.zeros(shape, bool)
    m[box] = True
    return m


def _global_ghost(plan, rank):
    """The cells of a rank's block outside the global interior: the
    Dirichlet constants the scatter fills and nothing ever writes."""
    from stencil_tpu_torch.parallel.rma import _coords

    h = plan.layout.halo
    c = _coords(rank, plan.mesh_shape) + (0,) * (
        len(plan.local_shape) - len(plan.mesh_shape))
    sizes = plan.mesh_shape + (1,) * len(c)
    inside = np.ones(plan.block_shape, bool)
    for d, n in enumerate(plan.local_shape):
        idx = np.arange(plan.block_shape[d]) - h + c[d] * n
        ok = (idx >= 0) & (idx < n * sizes[d])
        shape = [1] * len(plan.local_shape)
        shape[d] = -1
        inside &= ok.reshape(shape)
    return ~inside


@pytest.mark.parametrize("name,local,sizes,k", GEOMETRY)
def test_tables_boxes_in_bounds(name, local, sizes, k):
    """Every strip and every update box grown by the radius lies inside
    the padded block."""
    for plan in _plans(name, local, sizes, k):
        t = rma_tables(plan)
        r = plan.spec.radius
        boxes = [b for pushes in t.strips for pair in pushes for b in pair]
        boxes += [tuple(slice(s.start - r, s.stop + r) for s in b)
                  for rank in t.boxes for b in rank]
        for box in boxes:
            assert all(0 <= s.start < s.stop <= p
                       for s, p in zip(box, plan.block_shape))


@pytest.mark.parametrize("name,local,sizes,k", GEOMETRY)
def test_tables_no_two_strips_of_a_phase_write_one_cell(name, local, sizes,
                                                        k):
    for plan in _plans(name, local, sizes, k):
        t = rma_tables(plan)
        for d, pushes in enumerate(t.strips):
            written = np.zeros((plan.ranks,) + plan.block_shape, int)
            for rank in range(plan.ranks):
                for (_, dst), to in zip(pushes, t.neighbours[rank][d]):
                    if to >= 0:
                        written[(to,) + dst] += 1
            assert written.max() <= 1


@pytest.mark.parametrize("name,local,sizes,k", GEOMETRY)
def test_tables_each_read_is_fresh_or_constant(name, local, sizes, k):
    """Phase by phase, every strip reads cells its sender holds fresh (its
    interior, what an earlier phase wrote, or global ghosts); sweep by
    sweep, every update reads cells the previous sweep wrote into its
    input buffer, or global ghosts; and the last sweep writes the whole
    interior."""
    for plan in _plans(name, local, sizes, k):
        t = rma_tables(plan)
        r = plan.spec.radius
        interior = _mask(plan.block_shape, plan.layout.interior_index)
        fresh = [interior | _global_ghost(plan, rank)
                 for rank in range(plan.ranks)]
        for d, pushes in enumerate(t.strips):
            new = [f.copy() for f in fresh]
            for rank in range(plan.ranks):
                for (src, dst), to in zip(pushes, t.neighbours[rank][d]):
                    if to >= 0:
                        assert fresh[rank][src].all()
                        new[to][dst] = True
            fresh = new
        for rank in range(plan.ranks):
            valid = fresh[rank]
            for box in t.boxes[rank]:
                grown = tuple(slice(s.start - r, s.stop + r) for s in box)
                assert valid[grown].all()
                valid = _mask(plan.block_shape, box) | _global_ghost(plan,
                                                                     rank)
            assert t.boxes[rank][-1] == plan.layout.interior_index


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_buffers_of_a_step(k):
    """Sweep t reads what sweep t-1 wrote: the input slot, the compute
    buffers for t < k (two alternating beyond k = 2), the other slot."""
    plan = make_rma_plan(tspec.get_spec("jacobi5"), (12, 8),
                         mesh_shape=(2,), sweeps_per_call=k)
    for slot in (0, 1):
        seq = [buffer_of(plan, t, slot) for t in range(k + 1)]
        assert seq[0] == slot and seq[-1] == 1 - slot
        assert all(2 <= b < plan.num_buffers for b in seq[1:-1])
        assert all(a != b for a, b in zip(seq, seq[1:]))


@pytest.mark.parametrize("sizes", [(2,), (2, 3)])
def test_scatter_cuts_the_global_padded_grid(sizes):
    """Every buffer of every rank holds its window of the global grid
    padded by k*r, a corner of a physical and a mesh-internal face
    included (where a rank padded alone would let the later dim win)."""
    shape, k = (8, 12, 6), 2
    x = _x(shape)
    g = _grid(x, 1)
    mesh = make_mesh(sizes, _axes(sizes), device="cpu")
    method = RmaStencil(tspec.box(3, 1), shape, sweeps_per_call=k)
    plan = method.plan_for(mesh)
    bufs = method.scatter(g, mesh, plan)
    padded = PaddedLayout.for_halo(shape, k).pad(g.interior(), g.bc)
    for rank in range(mesh.size):
        c = mesh.coords(rank) + (0,) * (3 - len(sizes))
        window = tuple(slice(i * n, i * n + n + 2 * k)
                       for i, n in zip(c, plan.local_shape))
        for b in range(plan.num_buffers):
            assert torch.equal(bufs[rank, b], padded[window])


# ---- the launch, the iterate, the CLI ---------------------------------------


@pytest.mark.parametrize("k,steps", [(1, 3), (2, 2), (3, 3)])
def test_plain_launch_resumes_from_either_slot(k, steps):
    """``n`` steps from slot 0 then ``m`` from slot ``n % 2`` are ``n + m``
    steps from slot 0, whole buffer tensor bitwise (the remainder launch's
    resumption)."""
    plan = make_rma_plan(tspec.get_spec("jacobi7"), (6, 7, 5),
                         mesh_shape=(2, 2), sweeps_per_call=k)
    bufs = torch.from_numpy(_x(plan.buffer_shape, seed=4))
    one = rma_iterate_reference(bufs.clone(), plan, steps + 2)
    two = rma_iterate_reference(bufs.clone(), plan, steps)
    rma_iterate_reference(two, plan, 2, steps % 2)
    assert torch.equal(one, two)


def test_registry_runner_and_plan_info():
    cfg = RunConfig(size=(24, 20, 28), spec="jacobi7", device="cpu",
                    temporal=3, mesh=(2, 2))
    sp = cfg.resolved_spec()
    g = cli.make_grid(cfg, sp)
    runner = registry.get_runner("rma", cfg, sp, g)
    info = runner.plan_info
    assert runner.name == "rma(mesh=2x2,k=3)" and runner.granularity == 3
    assert info["kernel"] == "rma_iterate" and info["mesh"] == [2, 2]
    assert info["local_shape"] == [12, 10, 28]
    assert info["block_shape"] == [18, 16, 34] and info["buffers"] == 4
    assert info["resident_bytes"] == 4 * 4 * 18 * 16 * 34 * 4
    assert info["push_bytes_per_step"] == (2 * 3 * 10 * 34
                                           + 2 * 3 * 18 * 34) * 4
    assert info["live_bytes"] == 4 * 2 * 18 * 16 * 34 * 4
    assert info["cards"] == [4] and info["cross_card_bytes_per_step"] == 0
    assert len(info["tile"]) == 3 and info["tiles"] >= 4
    assert 0 < info["shared_bytes"] <= 232448 and info["waits_per_step"] > 0
    assert "stencil_tpu/parallel/rma.py" in runner.description
    tiled = registry.get_runner("tiled", cfg, sp, g)
    assert torch.equal(runner.iterate(g, 7).interior(),
                       tiled.iterate(g, 7).interior())


def test_cli_rma_prints_the_tiled_runs_error(capsys):
    """``-m tiled rma --mesh 2 2 -k 2 -c`` on the CPU: both pass the golden
    check with the same max abs error."""
    rc = cli.main(["-s", "24", "20", "28", "-i", "9", "--spec", "jacobi7",
                   "-m", "tiled", "rma", "--mesh", "2", "2", "-k", "2",
                   "-c", "--device", "cpu", "--repeat", "1"])
    out = capsys.readouterr().out
    errs = dict(re.findall(r"\[(\w+)\] correctness: OK .* max abs err "
                           r"(\S+),", out))
    assert rc == 0 and set(errs) == {"tiled", "rma"}, out
    assert errs["rma"] == errs["tiled"]


def test_bc_from_jax_round_trip():
    """The faces the tests give both packages are the same."""
    jbc = jgrid.DirichletBC(values=BC[3])
    assert convert.bc_from_arrays(jbc.values) == tgrid.DirichletBC(
        values=BC[3])

