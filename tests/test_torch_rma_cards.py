"""The in-kernel exchange across cards (stencil_tpu_torch/parallel/rma.py,
csrc/rma_iterate.cu): a mesh whose ranks lie on several cards, each card
with its own buffers and flags, the pairs stored into the destination
card's memory and the dependencies mirrored into the waiting card's flags;
on the CPU through virtual cards (``virtual_cards=G``: rank i on card
i % G) and explicit card maps, where the kernel's wrapper runs the plain
version. Held here:

- the geometry, in pure Python: the device table's per-card pairs decode
  to ``ghost_map(plan)`` exactly, every source lies on its writing tile's
  card, every dependency across cards has its flag published into the
  waiting card's array, the cards' peers are those they share a
  dependency with, and ``cross_card_bytes_per_step`` is 0 on one card and
  otherwise the bytes of the phased exchange's cells whose value comes
  from another card (on a 1D Dirichlet mesh: the strips of each cut);
- an emulation of every card's launch read from the geometry and the
  device table (per-card flat buffers, each tile waiting only on its own
  card's flags, publishing into its card's and its publish list's): both
  slots bitwise the plain version's; with one publish dropped it stalls;
- the plain version across cards: both slots bitwise the one-card plain
  version's, for every wall kind, in fp32 and bf16, from both slots and
  with a remainder launch; ``RmaStencil.iterate`` on virtual cards bitwise
  the one-card iterate;
- JAX's ``RmaStencil`` in interpret mode on its CPU mesh (the three cases
  of tests/test_torch_rma.py's interpret-mode test, on 2 virtual cards),
  within 5e-6 (the JAX suite's tolerance, tests/test_rma.py:32-34);
- the planning gates of virtual cards.

The kernel itself across virtual cards is held against its plain version
on a card by tests/test_torch_cuda.py."""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.parallel.halo import make_mesh as jmake_mesh
from stencil_tpu.parallel.rma import RmaStencil as JRmaStencil
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.parallel.mesh import make_mesh
from stencil_tpu_torch.parallel.rma import (
    RmaStencil, _geometry, cross_card_bytes_per_step, device_table,
    exchange_reference, ghost_map, make_rma_plan, rma_iterate,
    rma_iterate_reference, rma_tables, rma_tiles,
)

TOL = 5e-6
FACES = {2: ((0.5, -1.0), (2.0, 0.25)),
         3: ((0.5, -1.0), (2.0, 0.25), (1.0, 1.5))}
WALLS = {"dirichlet": ((), ()), "periodic0": ((0,), ()),
         "periodic01": ((0, 1), ()), "neumann1": ((), (1,))}


def _bc(ndim, walls):
    per, neu = WALLS[walls]
    bc = tgrid.DirichletBC(values=FACES[ndim])
    if per:
        bc = bc.with_periodic(per)
    if neu:
        bc = bc.with_neumann(neu)
    return bc


def _axes(sizes):
    return ("x", "y")[:len(sizes)]


def _round_robin(ranks, g):
    return tuple(i % g for i in range(ranks))


def _contiguous(ranks, g):
    return tuple(i * g // ranks for i in range(ranks))


# the geometry's cases: mesh, card map (round robin = virtual cards by
# make_mesh's rule, or contiguous), card count, walls, k; local (6, 6, 5)
# with tiles of (4, 3, 5), several per rank and ragged
GEOMETRY = [
    (mesh, cmap, g, walls, k)
    for mesh, g in (((2,), 2), ((4,), 2), ((4,), 4), ((2, 2), 2),
                    ((2, 2), 4), ((2, 4), 2), ((2, 4), 4))
    for cmap in ("round_robin", "contiguous")
    for walls in WALLS
    for k in (1, 2)
    if not (cmap == "contiguous" and g == math.prod(mesh))  # the same map
]


def _id(case):
    mesh, cmap, g, walls, k = case
    return f"m{'x'.join(map(str, mesh))}-{cmap}{g}-{walls}-k{k}"


def _plan(mesh, cmap, g, walls, k, local=(6, 6, 5), tile=(4, 3, 5)):
    cards = (_round_robin if cmap == "round_robin" else _contiguous)(
        math.prod(mesh), g)
    return make_rma_plan(tspec.get_spec("jacobi7"), local, "float32", mesh,
                         k, bc=_bc(len(local), walls), tile=tile,
                         cards=cards, virtual=True)


def _decode(plan):
    """The device table's pairs as (destination rank, offset, source rank,
    offset, window index), read as the kernel reads them: the destination
    card in the pair, the source on the writing tile's card, each offset
    ``i * nbuf * block + offset`` for the card's i-th rank."""
    geom = _geometry(plan, 1, 0)
    table = device_table(plan, torch.device("cpu")).numpy()
    ntiles, npairs = int(geom[8]), int(geom[27])
    pairs = table[geom[30]:geom[30] + 4 * npairs].reshape(-1, 4)
    pair_ptr = table[geom[29]:geom[29] + ntiles + 1]
    place = np.repeat(np.arange(ntiles), np.diff(pair_ptr)) // (
        ntiles // plan.ranks)
    first = geom[38:38 + geom[33] + 1]
    writer = np.searchsorted(first, place, side="right") - 1
    per_rank = plan.num_buffers * math.prod(plan.block_shape)
    d_i, d_off = np.divmod(pairs[:, 1], per_rank)
    s_i, s_off = np.divmod(pairs[:, 2], per_rank)
    d_rank = np.asarray([plan.card_ranks[c][i]
                         for c, i in zip(pairs[:, 0], d_i)], np.int64)
    s_rank = np.asarray([plan.card_ranks[c][i]
                         for c, i in zip(writer, s_i)], np.int64)
    return d_rank, d_off, s_rank, s_off, pairs[:, 3], writer


def _cross_bytes_by_phases(plan):
    """The bytes of the cells the phased exchange writes whose value comes
    from a rank on another card: the exchange run on per-card buffers of
    the cells' rank labels."""
    parts = [torch.tensor([float(r) for r in ranks], dtype=torch.float64)
             .reshape(-1, 1, 1, 1, 1).expand(
                 (len(ranks), 1) + plan.block_shape).contiguous()
             .reshape((len(ranks), 1) + plan.block_shape)
             for ranks in plan.card_ranks]
    before = [p.clone() for p in parts]
    exchange_reference(parts, plan, 0)
    cards = torch.tensor(plan.cards)
    n = 0
    for card, (p, b) in enumerate(zip(parts, before)):
        # a cell whose value comes from its own rank keeps its label, and
        # never crosses
        n += int((cards[p[p != b].long()] != card).sum())
    return n * plan.itemsize


@pytest.mark.parametrize("case", GEOMETRY, ids=_id)
def test_split_tables_map_onto_the_ghost_map(case):
    """The per-card pairs are the ghost map exactly; each source lies on
    its writing tile's card; a pair crosses cards where its source's rank
    and its destination's lie on two cards."""
    plan = _plan(*case)
    for p in (plan, plan.with_sweeps(1)):
        d_rank, d_off, s_rank, s_off, _, writer = _decode(p)
        block = math.prod(p.block_shape)
        dst, src = ghost_map(p)
        got = sorted(zip((d_rank * block + d_off).tolist(),
                         (s_rank * block + s_off).tolist()))
        assert got == sorted(zip(dst.tolist(), src.tolist()))
        cards = np.asarray(p.cards)
        assert (cards[s_rank] == writer).all()
        cross = cards[d_rank] != writer
        assert (cross == (cards[s_rank] != cards[d_rank])).all()
        assert cross_card_bytes_per_step(p) == cross.sum() * p.itemsize


@pytest.mark.parametrize("case", GEOMETRY, ids=_id)
def test_cross_card_flags_lie_on_the_waiting_card(case):
    """Every dependency between tiles on two cards has the producer
    publish into the waiting card's flags, and no tile publishes to a card
    none of whose tiles waits on it; the cards' peers are symmetric, the
    cards they share a dependency with."""
    plan = _plan(*case)
    tiles = rma_tiles(plan)
    pub = [set(tiles.pub[tiles.pub_ptr[i]:tiles.pub_ptr[i + 1]].tolist())
           for i in range(tiles.ntiles)]
    want_pub = [set() for _ in range(tiles.ntiles)]
    meet = set()
    for a in range(tiles.ntiles):
        for b in tiles.deps[tiles.dep_ptr[a]:tiles.dep_ptr[a + 1]]:
            if tiles.card[a] != tiles.card[b]:
                want_pub[b].add(int(tiles.card[a]))
                meet.add((int(tiles.card[a]), int(tiles.card[b])))
    assert pub == want_pub
    peers = {(c, int(p)) for c in range(plan.ncards)
             for p in tiles.peers[tiles.peer_ptr[c]:tiles.peer_ptr[c + 1]]}
    assert peers == meet and all((b, a) in peers for a, b in peers)
    assert peers, "every case of several cards exchanges across them"
    assert all(tiles.card[i] == plan.cards[tiles.rank[i]]
               for i in range(tiles.ntiles))
    assert list(tiles.card) == sorted(tiles.card)   # card by card


@pytest.mark.parametrize("case", GEOMETRY, ids=_id)
def test_cross_card_bytes_are_the_cut_cells(case):
    """``cross_card_bytes_per_step`` against the phased exchange on rank
    labels: the cells whose value comes from a rank on another card."""
    plan = _plan(*case)
    assert cross_card_bytes_per_step(plan) == _cross_bytes_by_phases(plan)
    assert cross_card_bytes_per_step(plan.on_one_card) == 0


@pytest.mark.parametrize("mesh,g,walls", [((2,), 2, "dirichlet"),
                                          ((4,), 2, "dirichlet"),
                                          ((4,), 4, "periodic0")])
def test_cross_card_bytes_on_a_1d_mesh_are_the_cut_strips(mesh, g, walls):
    """On a 1D mesh each cut between neighbours on two cards moves one
    strip each way, ``k*r`` rows of the padded extent (the periodic ring
    of 4 on 4 cards cuts every link, the wrap included)."""
    for k in (1, 2):
        plan = _plan(mesh, "round_robin", g, walls, k)
        cards = plan.cards
        links = [(i, i + 1) for i in range(len(cards) - 1)]
        if walls == "periodic0":
            links.append((len(cards) - 1, 0))
        cuts = sum(cards[a] != cards[b] for a, b in links)
        strip = k * math.prod(plan.block_shape[1:])
        assert cross_card_bytes_per_step(plan) == 2 * cuts * strip * 4


# ---- the kernel's schedule across cards, from its tables --------------------


def emulate_cards(parts, plan, n_steps, slot=0, rng=None, drop=None):
    """Every card's launch as the kernel runs it, read from the geometry
    and the device table, on ``parts`` (one tensor per card) in place:
    the opening exchange (each pair, destination through its card, source
    in its writing tile's card, from slot ``slot``), then tile steps in a
    seeded random order that respects only each tile's waits on its own
    card's flags: tile i at step s runs once its card's flag of every
    dependency reads >= s; a step loads the window, runs the k sweeps over
    the rank's boxes, stores level k, writes its pairs (none in the last
    step) and publishes s+1 into its card's flags and its publish list's
    (``drop`` = (tile, card) leaves one publish out). Raises if no tile
    can run."""
    geom = _geometry(plan, n_steps, slot)
    table = device_table(plan, torch.device("cpu")).numpy()
    tiles = rma_tiles(plan)
    tables = rma_tables(plan)
    r, k, kr = plan.spec.radius, plan.sweeps_per_call, plan.halo
    block = math.prod(plan.block_shape)
    ntiles = int(geom[8])
    rank_tiles = ntiles // plan.ranks
    first = geom[38:38 + geom[33] + 1]

    ptr = {name: table[geom[o]:geom[o] + n] for name, o, n in (
        ("pair", 29, ntiles + 1), ("dep", 31, ntiles + 1),
        ("pub", 34, ntiles + 1))}
    pairs = table[geom[30]:geom[30] + 4 * int(geom[27])].reshape(-1, 4)
    deps = table[geom[32]:geom[32] + int(geom[28])]
    pubs = table[geom[35]:geom[36]]
    flat = [p.view(-1) for p in parts]
    flags = [np.zeros(ntiles + plan.ncards, np.int64)
             for _ in range(plan.ncards)]

    def where(t):
        q = t // rank_tiles
        card = int(np.searchsorted(first, q, side="right") - 1)
        return card, int(q - first[card])

    def write_pairs(t, at, fin):
        card, _ = where(t)
        q = pairs[ptr["pair"][t]:ptr["pair"][t + 1]]
        for dcard, doff, soff, loc in q:
            if fin is not None and loc >= 0:
                v = fin.reshape(-1)[loc]
            else:
                v = flat[card][at + soff]
            flat[dcard][at + doff] = v

    for t in range(ntiles):
        write_pairs(t, slot * block, None)
    epoch = [0] * ntiles
    while min(epoch) < n_steps:
        ready = []
        for t in range(ntiles):
            card, _ = where(t)
            if epoch[t] < n_steps and all(
                    flags[card][j] >= epoch[t]
                    for j in deps[ptr["dep"][t]:ptr["dep"][t + 1]]):
                ready.append(t)
        if not ready:
            raise RuntimeError("no tile can run: a flag was never published")
        t = ready[rng.integers(len(ready))] if rng is not None else ready[0]
        s = epoch[t]
        inp = (slot + s) % 2
        card, i = where(t)
        rank = plan.card_ranks[card][i]
        lo, hi = tiles.lo[t], tiles.hi[t]
        window = tuple(slice(int(a) - kr, int(b) + kr)
                       for a, b in zip(lo, hi))
        win = [parts[card][i, inp][window].clone() for _ in (0, 1)]
        for tt in range(1, k + 1):
            box = tables.boxes[rank][tt - 1]
            grow = (k - tt) * r
            reg = [(max(int(a) - grow, b.start), min(int(c) + grow, b.stop))
                   for a, c, b in zip(lo, hi, box)]
            if any(a >= b for a, b in reg):
                continue
            loc = tuple(slice(a - w.start, b - w.start)
                        for (a, b), w in zip(reg, window))
            grown = tuple(slice(x.start - r, x.stop + r) for x in loc)
            eager.apply_spec(win[(tt - 1) % 2][grown], plan.spec, halo=r,
                             out=win[tt % 2][loc])
        fin = win[k % 2]
        inner = tuple(slice(kr, kr + int(b) - int(a))
                      for a, b in zip(lo, hi))
        parts[card][i, 1 - inp][tuple(slice(int(a), int(b))
                                      for a, b in zip(lo, hi))] = fin[inner]
        if s < n_steps - 1:
            padded = torch.zeros(tiles.pitch, dtype=fin.dtype)
            padded[tuple(slice(0, w) for w in fin.shape)] = fin
            write_pairs(t, (1 - inp) * block, padded)
        flags[card][t] = s + 1
        for c in pubs[ptr["pub"][t]:ptr["pub"][t + 1]]:
            if drop != (t, int(c)):
                flags[c][t] = s + 1
        epoch[t] += 1
    return parts


def _scattered(plan, seed=3):
    """Every card's buffers scattered from a random global grid."""
    shape = tuple(n * m for n, m in itertools.zip_longest(
        plan.local_shape, plan.mesh_shape, fillvalue=1))
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    bc = tgrid.DirichletBC(values=FACES[len(shape)])
    if any(plan.periodic):
        bc = bc.with_periodic(tuple(d for d, p in enumerate(plan.periodic)
                                    if p))
    if any(plan.neumann):
        bc = bc.with_neumann(tuple(d for d, p in enumerate(plan.neumann)
                                   if p))
    g = tgrid.HaloGrid.from_interior(
        torch.from_numpy(x).to(tgrid.torch_dtype(plan.dtype)),
        halo=plan.spec.radius, bc=bc, device="cpu")
    mesh = make_mesh(plan.mesh_shape, _axes(plan.mesh_shape), device="cpu")
    method = RmaStencil(plan.spec, shape, plan.dtype, plan.sweeps_per_call)
    parts = method.scatter(g, mesh, plan)
    return parts if isinstance(parts, list) else [parts]


EMULATED = [((2, 2), "round_robin", 2, "dirichlet", 2),
            ((2, 2), "contiguous", 2, "periodic01", 2),
            ((4,), "round_robin", 4, "periodic0", 2),
            ((2,), "round_robin", 2, "neumann1", 2),
            ((2, 4), "round_robin", 4, "dirichlet", 1)]


@pytest.mark.parametrize("case", EMULATED, ids=_id)
def test_emulated_cards_are_the_plain_version_on_both_slots(case):
    """2 steps from either slot, then a remainder launch, every card's
    tiles in one seeded random order that only the waits on each card's
    own flags constrain: every card's slots bitwise the plain version's."""
    plan = _plan(*case, local=(6, 5, 5), tile=(4, 3, 5))
    rem = plan.with_sweeps(1)
    start = _scattered(plan)
    for slot in (0, 1):
        rng = np.random.default_rng(slot)
        got = [p.clone() for p in start]
        want = [p.clone() for p in start]
        emulate_cards(got, plan, 2, slot, rng=rng)
        rma_iterate_reference(want, plan, 2, slot)
        emulate_cards(got, rem, 1, slot, rng=rng)
        rma_iterate_reference(want, rem, 1, slot)
        for a, b in zip(got, want):
            assert torch.equal(a[:, :2], b[:, :2]), slot


def test_emulated_cards_stall_without_a_mirrored_flag():
    """Leave out one tile's publish into a waiting card's flags: a tile of
    that card never sees the epoch and the schedule cannot go on."""
    plan = _plan((2,), "round_robin", 2, "dirichlet", 2, local=(6, 5, 5))
    tiles = rma_tiles(plan)
    t = int(np.nonzero(np.diff(tiles.pub_ptr))[0][0])
    c = int(tiles.pub[tiles.pub_ptr[t]])
    start = _scattered(plan)
    emulate_cards([p.clone() for p in start], plan, 3)
    with pytest.raises(RuntimeError, match="never published"):
        emulate_cards([p.clone() for p in start], plan, 3, drop=(t, c))


# ---- the plain version across cards -----------------------------------------

PLAIN = [  # spec, global shape, mesh, walls, k, iterations, dtype
    (spec, shape, mesh, walls, k, 5, dtype)
    for dtype in ("float32", "bfloat16")
    for spec, shape, mesh, walls, k in (
        ("jacobi7", (12, 12, 10), (2, 2), "dirichlet", 2),
        ("jacobi7", (16, 8, 10), (4,), "periodic0", 2),
        ("jacobi7", (12, 12, 10), (2, 2), "periodic01", 2),
        ("jacobi7", (12, 8, 10), (2,), "neumann1", 2),
        ("box:3:1", (8, 16, 6), (2, 4), "dirichlet", 1),
        ("jacobi5", (24, 12), (4,), "periodic0", 3),
    )
]


def _spec(name):
    if ":" in name:
        kind, ndim, r = name.split(":")
        return getattr(tspec, kind)(int(ndim), int(r))
    return tspec.get_spec(name)


def _pid(case):
    spec, shape, mesh, walls, k, _, dtype = case
    return (f"{spec}-{'x'.join(map(str, shape))}-m"
            f"{'x'.join(map(str, mesh))}-{walls}-k{k}-{dtype}")


@pytest.mark.parametrize("case", PLAIN, ids=_pid)
def test_plain_version_across_cards_is_the_one_card_version(case):
    """On 2 and 4 virtual cards (and a contiguous map): from either slot,
    ``iters // k`` steps and a remainder launch, every rank's two slots
    bitwise the one-card plain version's; ``RmaStencil.iterate`` on
    virtual cards bitwise the one-card iterate."""
    name, shape, sizes, walls, k, iters, dtype = case
    sp = _spec(name)
    bc = _bc(len(shape), walls)
    x = np.random.default_rng(7).random(shape).astype(np.float32)
    g = tgrid.HaloGrid.from_interior(
        torch.from_numpy(x).to(tgrid.torch_dtype(dtype)), halo=sp.radius,
        bc=bc, device="cpu")
    mesh = make_mesh(sizes, _axes(sizes), device="cpu")
    method = RmaStencil(sp, shape, dtype, k)
    one = method.plan_for(mesh, bc)
    ranks = math.prod(sizes)
    maps = [_round_robin(ranks, 2), _round_robin(ranks, min(4, ranks)),
            _contiguous(ranks, 2)]
    n_outer, rem = divmod(iters, k)
    for cards in maps:
        plan = method.local_plan(sizes, bc=bc, cards=cards, virtual=True)
        for slot in (0, 1):
            want = method.scatter(g, mesh, one)
            got = method.scatter(g, mesh, plan)
            rma_iterate(want, one, n_outer, slot)
            rma_iterate(got, plan, n_outer, slot)
            if rem:
                rma_iterate(want, one.with_sweeps(rem), 1,
                            (slot + n_outer) % 2)
                rma_iterate(got, plan.with_sweeps(rem), 1,
                            (slot + n_outer) % 2)
            for rank, (card, i) in enumerate(plan.places):
                assert torch.equal(got[card][i, :2], want[rank, :2]), (
                    cards, slot, rank)
    for cards in (2, min(4, ranks)):
        assert torch.equal(
            method.iterate(g, iters, mesh, virtual_cards=cards).interior(),
            method.iterate(g, iters, mesh).interior())


# ---- against JAX ------------------------------------------------------------


@pytest.mark.parametrize("name,shape,sizes,k,iters", [
    ("jacobi5", (32, 40), (2,), 1, 5),
    ("jacobi5", (32, 40), (2,), 2, 5),
    ("jacobi7", (16, 16, 20), (2, 2), 2, 2),
])
def test_two_virtual_cards_match_jax_rma_in_interpret_mode(name, shape,
                                                           sizes, k, iters):
    """JAX's own ``RmaStencil`` (interpret mode on its CPU mesh, one rank
    per virtual device) against the port on 2 virtual cards, within
    5e-6."""
    x = np.random.default_rng(9).random(shape).astype(np.float32)
    bc = FACES[len(shape)]
    g = tgrid.HaloGrid.from_interior(
        torch.from_numpy(x), halo=1, bc=tgrid.DirichletBC(values=bc),
        device="cpu")
    mesh = make_mesh(sizes, _axes(sizes), device="cpu")
    got = RmaStencil(tspec.get_spec(name), shape, sweeps_per_call=k).iterate(
        g, iters, mesh, virtual_cards=2)
    want = JRmaStencil(jspec.get_spec(name), shape, sweeps_per_call=k,
                       interpret=True).iterate(
        jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=1,
                                     bc=jgrid.DirichletBC(values=bc)),
        iters, jmake_mesh(sizes, _axes(sizes)))
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=TOL,
                               rtol=TOL)


# ---- planning ---------------------------------------------------------------


def test_virtual_cards_planning_and_gates():
    """Virtual cards put rank i on card i % G of the mesh's one device,
    share its L2 (the budget counts every rank), and are refused on a mesh
    of two devices or outside [1, ranks]; a plan of one card is the plan
    of before cards, with its one tensor."""
    method = RmaStencil(tspec.get_spec("jacobi7"), (16, 12, 20),
                        sweeps_per_call=2)
    mesh = make_mesh((2, 2), ("x", "y"), device="cpu")
    plan = method.plan_for(mesh, virtual_cards=4)
    assert plan.cards == (0, 1, 2, 3) and plan.virtual
    assert plan.device_ranks == (4,) and plan.ncards == 4
    with pytest.raises(ValueError, match="x4 ranks on one card"):
        method.plan_for(mesh, virtual_cards=2,
                        budget=plan.resident_bytes - 1)
    assert method.plan_for(mesh, virtual_cards=1).cards == (0,) * 4
    assert not method.plan_for(mesh, virtual_cards=1).virtual
    for bad in (0, 5):
        with pytest.raises(ValueError, match="outside"):
            method.plan_for(mesh, virtual_cards=bad)
    two = type(mesh)(shape=(2,), axis_names=("x",),
                     devices=(torch.device("cuda", 0),
                              torch.device("cuda", 1)))
    with pytest.raises(ValueError, match="spans 2"):
        RmaStencil(tspec.get_spec("jacobi7"), (16, 12, 20)).plan_for(
            two, virtual_cards=2, budget=1 << 30)
    one = method.plan_for(mesh)
    assert one.cards == (0,) * 4 and one.card_ranks == ((0, 1, 2, 3),)
    g = tgrid.HaloGrid.from_interior(torch.zeros(16, 12, 20), halo=1,
                                     device="cpu")
    assert isinstance(method.scatter(g, mesh, one), torch.Tensor)
    parts = method.scatter(g, mesh, plan)
    assert [tuple(p.shape) for p in parts] == [plan.card_shape(c)
                                               for c in range(4)]
    with pytest.raises(ValueError, match="2 buffer tensors for 4 cards"):
        rma_iterate(parts[:2], plan, 1)
    with pytest.raises(ValueError, match="17 cards"):
        make_rma_plan(tspec.get_spec("jacobi5"), (4, 40), "float32", (17,),
                      1, cards=range(17))
