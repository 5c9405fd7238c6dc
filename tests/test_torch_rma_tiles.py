"""The tiled schedule of the in-kernel exchange (csrc/rma_iterate.cu,
stencil_tpu_torch/parallel/rma.py: ``ghost_map``, ``rma_tiles``,
``choose_rma_tile``), in pure Python on the CPU:

- the ghost map reproduces the phased exchange (``exchange_reference``);
- every interior cell is written by exactly one tile per step, every
  ghost-map pair by exactly one producer;
- the dependency sets are symmetric and cover every hazard between one
  step and the next (a tile's writes against another's window);
- an emulation of the kernel's schedule, tile steps in a seeded random
  order that respects only the declared dependencies and epochs, is
  bitwise ``rma_iterate_reference`` on both slots; with one dependency
  removed it is not;
- the kernel's host geometry and device table decode to those tables;
- every plan of ``chip_smoke.py``'s rma cases fits a block's shared
  memory.

The cases are small versions of ``chip_smoke.py``'s ``RMA_CASES`` kinds,
with tiles small enough for several per rank (ragged ones included).
Tolerance: bitwise (the emulation runs the plain version's sweeps on each
tile's window)."""

import importlib.util
import itertools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.parallel.mesh import make_mesh
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.parallel.rma import (
    GEOM_LEN, SHARED_PER_BLOCK, RmaStencil, _geometry, choose_rma_tile,
    device_table, exchange_reference, ghost_map, make_rma_plan,
    rma_iterate_reference, rma_tables, rma_tiles, shared_bytes, tile_cost,
)

FACES = {2: ((0.5, -1.0), (2.0, 0.25)),
         3: ((0.5, -1.0), (2.0, 0.25), (1.0, 1.5))}

CASES = [  # spec, local shape, mesh, k, periodic, neumann, dtype, tile
    ("jacobi7", (6, 7, 5), (1,), 2, (), (), "float32", (4, 3, 5)),
    ("jacobi7", (6, 7, 5), (2,), 2, (), (), "float32", (4, 3, 5)),
    ("jacobi7", (6, 5, 5), (2, 2), 2, (), (), "float32", (4, 3, 5)),
    ("jacobi7", (4, 4, 6), (2, 4), 2, (), (), "float32", (3, 3, 4)),
    ("jacobi7", (6, 7, 5), (1,), 2, (0,), (), "float32", (4, 3, 5)),
    ("jacobi7", (6, 7, 5), (2,), 2, (0,), (), "float32", (4, 3, 5)),
    ("jacobi7", (4, 7, 5), (4,), 2, (0,), (), "float32", (3, 4, 5)),
    ("jacobi7", (6, 6, 5), (2, 2), 2, (), (0, 1), "float32", (4, 4, 3)),
    ("jacobi7", (6, 7, 5), (2,), 2, (), (1,), "float32", (4, 3, 5)),
    ("jacobi7", (6, 7, 5), (2,), 2, (0, 1), (), "float32", (4, 3, 5)),
    ("box:3:1", (6, 6, 5), (2, 2), 2, (1,), (0,), "float32", (4, 4, 3)),
    ("star:3:2", (8, 9, 5), (2, 2), 2, (0,), (1,), "float32", (5, 4, 3)),
    ("jacobi27", (6, 7, 5), (2,), 3, (1,), (0,), "float32", (4, 3, 5)),
    ("jacobi5", (8, 9), (2,), 4, (), (0,), "float32", (3, 4)),
    ("jacobi7", (6, 6, 5), (2, 2), 2, (0,), (1,), "bfloat16", (4, 4, 3)),
]


def _spec(name):
    if ":" in name:
        kind, ndim, r = name.split(":")
        return getattr(tspec, kind)(int(ndim), int(r))
    return tspec.get_spec(name)


def _bc(ndim, periodic, neumann):
    bc = tgrid.DirichletBC(values=FACES[ndim])
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    return bc


def _id(case):
    name, local, sizes, k, per, neu, dtype, _ = case
    return (f"{name}-{'x'.join(map(str, local))}-m"
            f"{'x'.join(map(str, sizes))}-k{k}-p{''.join(map(str, per))}"
            f"-n{''.join(map(str, neu))}-{dtype}")


def _plan(case):
    name, local, sizes, k, per, neu, dtype, tile = case
    bc = _bc(len(local), per, neu)
    return make_rma_plan(_spec(name), local, dtype, sizes, k, bc=bc,
                         tile=tile), bc


def _plans(case):
    """The case's plan and its remainder plans."""
    plan, _ = _plan(case)
    return [plan.with_sweeps(j) for j in range(1, plan.sweeps_per_call + 1)]


def _buffers(plan, bc, seed=3):
    """Every rank's buffers scattered from a random global grid, as
    ``RmaStencil.iterate`` makes them."""
    shape = tuple(n * m for n, m in itertools.zip_longest(
        plan.local_shape, plan.mesh_shape, fillvalue=1))
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    g = tgrid.HaloGrid.from_interior(
        torch.from_numpy(x).to(tgrid.torch_dtype(plan.dtype)),
        halo=plan.spec.radius, bc=bc, device="cpu")
    mesh = make_mesh(plan.mesh_shape, ("x", "y")[:len(plan.mesh_shape)],
                     device="cpu")
    method = RmaStencil(plan.spec, shape, plan.dtype, plan.sweeps_per_call)
    return method.scatter(g, mesh, plan)


def _box_cells(plan, rank, lo, hi):
    """Flat ``rank * block + offset`` indices of the box [lo, hi)."""
    block = math.prod(plan.block_shape)
    idx = np.arange(block).reshape(plan.block_shape)
    box = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    return set((rank * block + idx[box]).reshape(-1).tolist())


def _writes_and_windows(plan):
    tiles = rma_tiles(plan)
    kr = plan.halo
    writes, windows = [], []
    for i in range(tiles.ntiles):
        rank, lo, hi = int(tiles.rank[i]), tiles.lo[i], tiles.hi[i]
        pairs = tiles.pairs[tiles.pair_ptr[i]:tiles.pair_ptr[i + 1]]
        writes.append(_box_cells(plan, rank, lo, hi)
                      | set(pairs[:, 0].tolist()))
        windows.append(_box_cells(plan, rank, lo - kr, hi + kr))
    return tiles, writes, windows


def emulate_schedule(buffers, plan, n_steps, slot=0, rng=None, starve=None,
                     drop=None):
    """The kernel's schedule in Python, on ``buffers`` in place: the
    opening exchange (every ghost-map pair, read from slot ``slot``), then
    tile steps one at a time in an order that respects only the declared
    dependencies and epochs: a tile at step s may run once every tile of
    its ``deps`` has finished step s-1. Each runs as the kernel's block
    does: load its window from the step's input slot, k sweeps in its two
    window copies over the rank's boxes (``eager.apply_spec``), level k
    stored over its interior in the other slot, then its pairs (none in
    the last step). ``rng`` picks among the ready tiles (default: the
    first); ``starve`` runs that tile only when no other is ready; ``drop``
    = (a, b) removes b from a's dependencies. Returns ``buffers``."""
    tiles = rma_tiles(plan)
    tables = rma_tables(plan)
    r, k, kr = plan.spec.radius, plan.sweeps_per_call, plan.halo
    block = math.prod(plan.block_shape)
    per_rank = plan.num_buffers * block
    flat = buffers.view(-1)

    def at(cells, s):
        rank, off = np.divmod(cells, block)
        return torch.from_numpy(rank * per_rank + s * block + off)

    p = tiles.pairs
    flat[at(p[:, 0], slot)] = flat[at(p[:, 1], slot)]
    deps = [set(tiles.deps[tiles.dep_ptr[i]:tiles.dep_ptr[i + 1]].tolist())
            for i in range(tiles.ntiles)]
    if drop is not None:
        deps[drop[0]].discard(drop[1])
    epoch = [0] * tiles.ntiles
    while min(epoch) < n_steps:
        ready = [i for i in range(tiles.ntiles) if epoch[i] < n_steps
                 and all(epoch[j] >= epoch[i] for j in deps[i])]
        if starve is not None and len(ready) > 1 and starve in ready:
            ready.remove(starve)
        i = ready[rng.integers(len(ready))] if rng is not None else ready[0]
        s = epoch[i]
        inp = (slot + s) % 2
        rank = int(tiles.rank[i])
        lo, hi = tiles.lo[i], tiles.hi[i]
        window = tuple(slice(int(a) - kr, int(b) + kr) for a, b in zip(lo, hi))
        win = [buffers[rank, inp][window].clone() for _ in (0, 1)]
        for t in range(1, k + 1):
            box = tables.boxes[rank][t - 1]
            g = (k - t) * r
            reg = [(max(int(a) - g, b.start), min(int(c) + g, b.stop))
                   for a, c, b in zip(lo, hi, box)]
            if any(a >= b for a, b in reg):
                continue
            loc = tuple(slice(a - w.start, b - w.start)
                        for (a, b), w in zip(reg, window))
            grown = tuple(slice(q.start - r, q.stop + r) for q in loc)
            eager.apply_spec(win[(t - 1) % 2][grown], plan.spec, halo=r,
                             out=win[t % 2][loc])
        fin = win[k % 2]
        inner = tuple(slice(kr, kr + int(b) - int(a)) for a, b in zip(lo, hi))
        buffers[rank, 1 - inp][tuple(slice(int(a), int(b))
                                     for a, b in zip(lo, hi))] = fin[inner]
        if s < n_steps - 1:
            q = p[tiles.pair_ptr[i]:tiles.pair_ptr[i + 1]]
            dst = at(q[:, 0], 1 - inp)
            mine = q[:, 2] >= 0
            vals = flat[at(q[:, 1], 1 - inp)]
            padded = torch.zeros(tiles.pitch, dtype=fin.dtype)
            padded[tuple(slice(0, w) for w in fin.shape)] = fin
            vals[torch.from_numpy(mine)] = padded.view(-1)[
                torch.from_numpy(q[mine, 2])]
            flat[dst] = vals
        epoch[i] += 1
    return buffers


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_ghost_map_reproduces_the_exchange(case):
    """Every pair applied at once, each from the values before, gives the
    phased exchange's result on random values, and no source is written."""
    for plan in _plans(case):
        shape = (plan.ranks, 1) + plan.block_shape
        x = torch.from_numpy(np.random.default_rng(5).random(shape)).to(
            tgrid.torch_dtype(plan.dtype))
        want = x.clone()
        exchange_reference(want, plan, 0)
        dst, src = ghost_map(plan)
        got = x.clone().view(-1)
        got[torch.from_numpy(dst)] = x.view(-1)[torch.from_numpy(src)]
        assert torch.equal(got.view(shape), want)
        assert not np.isin(src, dst).any()
        assert len(dst) or (plan.ranks == 1 and not plan.dynamic)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_each_cell_has_one_writer_per_step(case):
    """The tiles cover every interior cell of every rank once; every
    ghost-map pair belongs to one tile, which holds its source in its
    interior, or, for a source no tile writes, is a tile of the
    destination's rank."""
    for plan in _plans(case):
        tiles = rma_tiles(plan)
        block = math.prod(plan.block_shape)
        count = np.zeros((plan.ranks,) + plan.block_shape, int)
        for i in range(tiles.ntiles):
            box = tuple(slice(int(a), int(b))
                        for a, b in zip(tiles.lo[i], tiles.hi[i]))
            count[(int(tiles.rank[i]),) + box] += 1
        interior = np.zeros_like(count, bool)
        interior[(slice(None),) + plan.layout.interior_index] = True
        assert (count[interior] == 1).all() and (count[~interior] == 0).all()
        dst, _ = ghost_map(plan)
        assert sorted(tiles.pairs[:, 0].tolist()) == sorted(dst.tolist())
        owner = np.repeat(np.arange(tiles.ntiles), np.diff(tiles.pair_ptr))
        for (d, s, local), i in zip(tiles.pairs, owner):
            rank = int(tiles.rank[i])
            inside = s in _box_cells(plan, rank, tiles.lo[i], tiles.hi[i])
            assert inside == (local >= 0)
            if not inside:
                assert not interior.reshape(-1)[s]
                assert d // block == rank


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_dependencies_are_symmetric_and_cover_every_hazard(case):
    """B is in D(A) exactly when B's writes meet A's window or A's writes
    meet B's window (cell sets, brute force)."""
    for plan in _plans(case):
        tiles, writes, windows = _writes_and_windows(plan)
        deps = [set(tiles.deps[tiles.dep_ptr[i]:tiles.dep_ptr[i + 1]]
                    .tolist()) for i in range(tiles.ntiles)]
        for a in range(tiles.ntiles):
            want = {b for b in range(tiles.ntiles) if b != a and (
                writes[b] & windows[a] or writes[a] & windows[b])}
            assert deps[a] == want
            assert all(a in deps[b] for b in deps[a])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_emulated_schedule_is_the_plain_version_on_both_slots(case):
    """1, 2 and 3 steps from either slot, then a remainder launch, in a
    seeded random order of ready tiles: both slots bitwise the plain
    version's."""
    plan, bc = _plan(case)
    rem = plan.with_sweeps(max(1, plan.sweeps_per_call - 1))
    start = _buffers(plan, bc)
    for steps, slot in itertools.product((1, 2, 3), (0, 1)):
        rng = np.random.default_rng(steps * 2 + slot)
        got, want = start.clone(), start.clone()
        emulate_schedule(got, plan, steps, slot, rng=rng)
        rma_iterate_reference(want, plan, steps, slot)
        nxt = (slot + steps) % 2
        emulate_schedule(got, rem, 1, nxt, rng=rng)
        rma_iterate_reference(want, rem, 1, nxt)
        assert torch.equal(got[:, :2], want[:, :2]), (steps, slot)


def _strongest_edge(plan):
    """The dependency (a, b) whose window-write overlap is largest."""
    tiles, writes, windows = _writes_and_windows(plan)
    best = None
    for a in range(tiles.ntiles):
        for b in tiles.deps[tiles.dep_ptr[a]:tiles.dep_ptr[a + 1]]:
            n = len(writes[b] & windows[a]) + len(writes[a] & windows[b])
            if best is None or n > best[0]:
                best = (n, a, int(b))
    return best[1:]


@pytest.mark.parametrize("case", [c for c in CASES if c[2] in ((2,), (2, 2))
                                  and c[6] == "float32"][:6], ids=_id)
def test_emulated_schedule_without_one_dependency_fails(case):
    """Drop b from a's dependencies and run b only when nothing else is
    ready: a runs ahead of b and a slot differs from the plain
    version's."""
    plan, bc = _plan(case)
    a, b = _strongest_edge(plan)
    start = _buffers(plan, bc)
    want = rma_iterate_reference(start.clone(), plan, 3)
    ok = emulate_schedule(start.clone(), plan, 3, starve=b)
    assert torch.equal(ok[:, :2], want[:, :2])
    got = emulate_schedule(start.clone(), plan, 3, starve=b, drop=(a, b))
    assert not torch.equal(got[:, :2], want[:, :2])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_kernel_tables_decode_to_the_schedule(case):
    """The host geometry and the device table, read as the kernel reads
    them: the tile grid, the halos, the boxes, and per tile the pairs
    (destination and source in buffer 0 of their rank, the window index)
    and the dependencies."""
    for plan in _plans(case):
        tiles = rma_tiles(plan)
        geom = _geometry(plan, 5, 1)
        table = device_table(plan, torch.device("cpu")).numpy()
        assert len(geom) == GEOM_LEN
        lead = 3 - len(plan.local_shape)
        k = plan.sweeps_per_call
        assert tuple(geom[[0, 1, 5, 6, 7, 8]]) == (
            plan.ranks, plan.num_buffers, k, 5, 1, tiles.ntiles)
        assert tuple(geom[9 + lead:12]) == tiles.tile
        assert tuple(geom[12 + lead:15]) == tiles.grid
        assert tuple(geom[18 + lead:21]) == (plan.halo,) * (3 - lead)
        boxes = table[:plan.ranks * k * 6].reshape(plan.ranks, k, 6)
        for rank, rank_boxes in enumerate(rma_tables(plan).boxes):
            for t, box in enumerate(rank_boxes):
                assert list(boxes[rank, t, 3 - len(box):3]) == [
                    b.start for b in box]
        npairs, ndeps = geom[27], geom[28]
        pair_ptr = table[geom[29]:geom[29] + tiles.ntiles + 1]
        pairs = table[geom[30]:geom[30] + 3 * npairs].reshape(-1, 3)
        dep_ptr = table[geom[31]:geom[31] + tiles.ntiles + 1]
        deps = table[geom[32]:geom[32] + ndeps]
        assert len(table) == geom[32] + ndeps
        assert (pair_ptr == tiles.pair_ptr).all()
        assert (dep_ptr == tiles.dep_ptr).all() and (deps == tiles.deps).all()
        block = math.prod(plan.block_shape)
        for c in (0, 1):
            rank, off = np.divmod(pairs[:, c], plan.num_buffers * block)
            assert (rank * block + off == tiles.pairs[:, c]).all()
        assert (pairs[:, 2] == tiles.pairs[:, 2]).all()


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_every_phase3_plan_fits_shared_memory():
    """Every rma plan ``chip_smoke.py`` launches (phase 3's cases and their
    remainders, the bench cell's walls and meshes, 128^3, 160^3 bf16,
    8x8x16): its tile, grown by k*r, fits a block's 227 KB, and the rule's
    own estimate says so."""
    smoke = _chip_smoke()
    cases = [c[:8] for c in smoke.RMA_CASES]
    for shape in (smoke.RMA_SIZE, smoke.RMA_BIG, smoke.RMA_TINY):
        for sizes in smoke.RMA_MESHES + ((2,),):
            cases.append(("jacobi7", shape, sizes, smoke.RMA_K, 0, (), (),
                          "float32"))
    for name, shape, sizes, k, _, per, neu, dtype in cases:
        sp = smoke.rma_spec(name)
        bc = smoke.rma_walls(len(shape), per, neu)
        plan = RmaStencil(sp, shape, dtype, k).local_plan(sizes, bc=bc)
        for p in (plan, plan.with_sweeps(max(1, k - 1))):
            need = shared_bytes(p.tile, p.ranks, p.sweeps_per_call, p.halo,
                                p.itemsize)
            assert need <= SHARED_PER_BLOCK, (name, shape, sizes, k)
            assert tile_cost(p.local_shape, p.tile, p.ranks,
                             p.sweeps_per_call, sp.radius,
                             p.itemsize) is not None


def test_tile_rule_and_its_refusals():
    """The rule returns a tile of the interior that fits; a tile the
    window of which does not fit, or one larger than the interior, is
    refused."""
    j7 = tspec.get_spec("jacobi7")
    tile = choose_rma_tile((64, 64, 128), 1, 2, 1, 4)
    assert all(1 <= t <= n for t, n in zip(tile, (64, 64, 128)))
    assert tile_cost((64, 64, 128), tile, 1, 2, 1, 4) is not None
    assert make_rma_plan(j7, (64, 64, 128), "float32", (1,), 2).tile == tile
    with pytest.raises(ValueError, match="does not fit"):
        make_rma_plan(j7, (64, 64, 128), "float32", (1,), 2,
                      tile=(64, 64, 128))
    with pytest.raises(ValueError, match="does not fit"):
        make_rma_plan(j7, (8, 8, 16), "float32", (1,), 2, tile=(9, 1, 1))
    assert tile_cost((64, 64, 128), (64, 64, 128), 1, 2, 1, 4) is None


def test_live_bytes_count_the_two_slots():
    """The budget still counts every buffer (JAX's rule); the kernel
    touches the two slots."""
    plan = make_rma_plan(tspec.get_spec("jacobi7"), (12, 10, 28), "float32",
                         (2, 2), 3)
    assert plan.resident_bytes == 4 * 4 * 18 * 16 * 34 * 4
    assert plan.live_bytes == 4 * 2 * 18 * 16 * 34 * 4
