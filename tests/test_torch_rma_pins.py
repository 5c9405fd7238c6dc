"""The ``rma`` method on periodic and Neumann walls and in bfloat16
(stencil_tpu_torch/parallel/rma.py through its plain version, the walk the
kernel csrc/rma_iterate.cu makes): rings on 1D and 2D meshes, Neumann
mirrors, the local refresh of an unsharded dynamic dim, mixed walls and
JAX's seeded fuzz, each with distinct Dirichlet face values.

Held against the float64 golden at every case of JAX's tests/test_rma.py
(:229, :274-516), the port's single-device ``tiled``/``slab`` runs, JAX's
``RmaStencil`` in interpret mode at six cases, JAX's gate messages word for
word, and, in pure Python, the tables: every copy of a phase inside the
block, no cell written twice or read and written in one phase, every
value a sweep reads the golden's own (tracked as labels of the global
padded grid), and the kernel's pairs, read from its geometry and device
table as it reads them, that must give what the plain version's copies
give. The kernel itself is held against the
plain version on a card by tests/test_torch_cuda.py.

Tolerances: fp32 5e-6 against the golden and JAX (JAX's own,
tests/test_rma.py:32-34; a Neumann ghost at k>1 sums its mirrored taps in
another order than the interior cell it mirrors, so a run agrees with one
that refreshes every sweep to rounding, not bitwise); bf16 3e-2
(tests/test_rma.py:243); bitwise against the port's single-device kernel
runs, which recompute the same ghosts in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu import registry as jregistry
from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.ops import golden as jgolden
from stencil_tpu.parallel.halo import make_mesh as jmake_mesh
from stencil_tpu.parallel.rma import RmaStencil as JRmaStencil
from stencil_tpu.parallel.rma import make_rma_plan as jmake_rma_plan
from stencil_tpu_torch import cli, convert, registry
from stencil_tpu_torch.config import RunConfig
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.slab import SlabStencil
from stencil_tpu_torch.ops.tiled import TiledStencil
from stencil_tpu_torch.parallel.mesh import make_mesh
from stencil_tpu_torch.parallel.rma import (
    RmaStencil, _geometry, buffer_of, device_table, exchange_reference,
    ghost_map, make_rma_plan, phase_copies, rma_iterate,
    rma_iterate_reference, rma_tables,
)

TOL = 5e-6
BF16_TOL = 3e-2
FACES = {2: ((0.5, -1.0), (2.0, 0.25)),
         3: ((0.5, -1.0), (2.0, 0.25), (1.0, 1.5))}
ASYM = [((-1, 0), 0.5), ((1, 0), 0.1), ((0, -1), 0.2), ((0, 1), 0.2)]


def _spec(name, pkg=tspec):
    """A spec by name, ``star:ndim:r``/``box:ndim:r`` or ``asym2d`` (JAX's
    ``test_neumann_asymmetric_spec_gates_at_temporal`` spec)."""
    if name == "asym2d":
        return pkg.weighted(2, ASYM, name="asym2d")
    if ":" in name:
        kind, ndim, r = name.split(":")
        return getattr(pkg, kind)(int(ndim), int(r))
    return pkg.get_spec(name)


def _axes(sizes):
    return ("x", "y")[:len(sizes)]


def _bc(pkg, ndim, periodic=(), neumann=(), faces=True):
    bc = (pkg.DirichletBC(values=FACES[ndim]) if faces
          else pkg.DirichletBC.reference_default(ndim))
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    return bc


def _x(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _grid(x, radius, bc, dtype="float32"):
    return tgrid.HaloGrid.from_interior(
        torch.from_numpy(x).to(tgrid.torch_dtype(dtype)), halo=radius,
        bc=bc, device="cpu")


def _rma(name, shape, sizes, k, iters, periodic=(), neumann=(),
         dtype="float32", seed=43, faces=True):
    sp = _spec(name)
    x = _x(shape, seed)
    g = _grid(x, sp.radius, _bc(tgrid, len(shape), periodic, neumann, faces),
              dtype)
    mesh = make_mesh(sizes, _axes(sizes), device="cpu")
    got = RmaStencil(sp, shape, dtype=dtype, sweeps_per_call=k).iterate(
        g, iters, mesh)
    return x, g, got


def _fuzz_case(seed):
    """JAX's ``test_fuzz_random_bc_modes_rma`` case for ``seed``: its
    mesh, k, shape, walls and iterations from the same generator."""
    rng = np.random.default_rng(2000 + seed)
    sizes = (2, 2) if rng.integers(0, 2) else (int(rng.choice([2, 4])),)
    k = int(rng.choice([1, 2]))
    kr = k * 1
    shape = [int(m * max(2 * kr, rng.integers(4, 8))) for m in sizes]
    if len(sizes) == 2:
        shape[1] = int(sizes[1] * 8 * rng.integers(1, 3))
    shape = tuple(shape) + tuple(
        int(rng.integers(max(2 * kr, 8), 24))
        for _ in range(3 - len(sizes) - 1)) + (20,)
    modes = [int(rng.integers(0, 3)) for _ in range(2)] + [0]
    per = tuple(d for d in range(2) if modes[d] == 1)
    neu = tuple(d for d in range(2) if modes[d] == 2)
    iters = int(rng.integers(1, 3)) * k
    return ("jacobi7", shape, sizes, k, iters, per, neu, "float32",
            3000 + seed)


# JAX's cases (tests/test_rma.py): spec, shape, mesh, k, iterations,
# periodic dims, Neumann dims, dtype, seed
CASES = [
    # rings (:274-327)
    ("jacobi5", (64, 40), (4,), 1, 3, (0,), (), "float32", 41),
    ("jacobi5", (64, 40), (4,), 2, 5, (0,), (), "float32", 41),
    ("jacobi5", (32, 40), (1,), 1, 5, (0,), (), "float32", 41),  # ring of 1
    ("jacobi7", (16, 12, 20), (4,), 2, 5, (0,), (), "float32", 41),
    ("jacobi27", (16, 32, 20), (2, 2), 2, 4, (0, 1), (), "float32", 41),
    ("jacobi7", (16, 32, 20), (2, 2), 2, 5, (0,), (), "float32", 41),
    ("jacobi5", (32, 40), (4,), 2, 4, (0,), (), "float32", 41),
    ("jacobi5", (32, 40), (2,), 2, 5, (0,), (), "float32", 41),  # ring of 2
    # Neumann mirrors (:340-438)
    ("jacobi5", (64, 40), (4,), 1, 3, (), (0,), "float32", 43),
    ("jacobi5", (64, 40), (4,), 2, 5, (), (0,), "float32", 43),
    ("jacobi5", (32, 40), (1,), 2, 5, (), (0,), "float32", 43),
    ("jacobi7", (16, 12, 20), (4,), 2, 5, (), (0,), "float32", 43),
    ("jacobi27", (16, 32, 20), (2, 2), 2, 4, (), (0, 1), "float32", 43),
    ("jacobi7", (16, 32, 20), (2, 2), 2, 5, (0,), (1,), "float32", 43),
    ("jacobi7", (16, 32, 20), (2, 2), 2, 4, (), (0, 1), "float32", 43),
    ("asym2d", (64, 40), (4,), 1, 3, (), (0,), "float32", 7),
    # the local refresh of an unsharded dynamic dim (:451-506)
    ("jacobi7", (16, 16, 20), (4,), 1, 3, (1,), (), "float32", 43),
    ("jacobi7", (16, 16, 20), (4,), 2, 5, (1,), (), "float32", 43),
    ("jacobi7", (16, 16, 20), (4,), 1, 3, (), (1,), "float32", 43),
    ("jacobi7", (16, 16, 20), (4,), 2, 5, (), (1,), "float32", 43),
    ("jacobi27", (16, 16, 20), (2,), 2, 4, (0,), (1,), "float32", 43),
    ("jacobi7", (16, 16, 20), (2,), 2, 5, (0, 1), (), "float32", 43),
    ("jacobi7", (16, 16, 20), (2,), 4, 9, (), (1,), "float32", 11),
    ("jacobi7", (16, 16, 20), (2,), 2, 4, (0,), (1,), "float32", 43),
    # a remainder launch, radius 2, a box on a ring of 1 with a refresh
    ("jacobi7", (16, 16, 20), (2,), 3, 7, (0,), (1,), "float32", 5),
    ("star:3:2", (16, 16, 20), (2, 2), 2, 5, (0,), (1,), "float32", 5),
    ("star:3:2", (16, 16, 20), (2,), 2, 3, (), (0, 1), "float32", 5),
    ("box:3:1", (12, 10, 8), (1,), 2, 5, (0,), (1,), "float32", 5),
    # bf16 (:229), Dirichlet and on dynamic walls
    ("jacobi5", (64, 40), (2,), 2, 4, (), (), "bfloat16", 43),
    ("jacobi7", (16, 32, 20), (2, 2), 2, 4, (0,), (1,), "bfloat16", 43),
    ("jacobi7", (16, 16, 20), (2,), 2, 4, (), (0, 1), "bfloat16", 43),
] + [_fuzz_case(seed) for seed in range(6)]


def _id(case):
    name, shape, sizes, k, iters, per, neu, dtype, _ = case
    return (f"{name}-{'x'.join(map(str, shape))}-m{'x'.join(map(str, sizes))}"
            f"-k{k}-i{iters}-p{''.join(map(str, per))}"
            f"-n{''.join(map(str, neu))}-{dtype}")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_matches_golden(case):
    """Within 5e-6 (bf16 3e-2) of the float64 golden on the same walls and
    distinct face values."""
    name, shape, sizes, k, iters, per, neu, dtype, seed = case
    x, g, got = _rma(name, shape, sizes, k, iters, per, neu, dtype, seed)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    ref = golden.golden_iterate(x.astype(np.float64), _spec(name), iters,
                                bc=g.bc)
    np.testing.assert_allclose(got.interior().double().numpy(), ref,
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_matches_single_device(case):
    """Bitwise the port's single-device kernel run (``tiled`` in 3D,
    ``slab`` in 2D) at the same k and dtype: both recompute a live ghost
    band from ghosts wrapped or mirrored k*r deep, with the same taps in
    the same order."""
    name, shape, sizes, k, iters, per, neu, dtype, seed = case
    _, g, got = _rma(name, shape, sizes, k, iters, per, neu, dtype, seed)
    single = (TiledStencil if len(shape) == 3 else SlabStencil)(
        _spec(name), shape, dtype, sweeps_per_call=k,
        device="cpu").iterate(g, iters)
    assert torch.equal(got.interior(), single.interior())


# ---- JAX's RmaStencil in interpret mode -------------------------------------


@pytest.mark.parametrize("name,shape,sizes,k,iters,per,neu,faces", [
    ("jacobi5", (32, 40), (1,), 1, 5, (0,), (), True),      # ring of 1
    ("jacobi5", (32, 40), (4,), 2, 4, (0,), (), True),      # ring
    ("jacobi5", (32, 40), (2,), 2, 5, (), (0,), True),      # mirrors
    ("jacobi7", (16, 16, 20), (2, 2), 2, 3, (0,), (1,), True),
    # a dynamic unsharded dim: JAX's corners want the default faces
    ("jacobi7", (16, 16, 20), (2,), 2, 4, (), (1,), False),
    ("jacobi27", (16, 16, 20), (2,), 2, 4, (0,), (1,), False),
])
def test_matches_jax_rma_in_interpret_mode(name, shape, sizes, k, iters,
                                           per, neu, faces):
    """JAX's own ``RmaStencil`` (interpret mode on its CPU mesh, as
    tests/test_rma.py runs it), within 5e-6."""
    x, _, got = _rma(name, shape, sizes, k, iters, per, neu, seed=9,
                     faces=faces)
    jsp = _spec(name, jspec)
    jg = jgrid.HaloGrid.from_interior(
        jnp.asarray(x), halo=jsp.radius,
        bc=_bc(jgrid, len(shape), per, neu, faces))
    want = JRmaStencil(jsp, shape, sweeps_per_call=k,
                       interpret=True).iterate(
        jg, iters, jmake_mesh(sizes, _axes(sizes)))
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("name,shape,k,iters,per,neu", [
    ("jacobi7", (16, 16, 20), 2, 4, (1,), ()),
    ("jacobi27", (16, 12, 20), 1, 2, (1,), ()),
    ("jacobi27", (16, 12, 20), 1, 2, (), (1,)),
    ("jacobi27", (16, 12, 20), 2, 4, (), (1,)),
])
def test_corner_of_a_sharded_dirichlet_face_and_the_refreshed_dim(
        record_property, name, shape, k, iters, per, neu):
    """Where d0's Dirichlet face (sharded over (2,)) meets the refreshed
    d1, the golden holds d0's face value. The port matches the golden
    within 5e-6 and its single-device ``tiled`` run bitwise, with distinct
    faces and with the default ones. JAX's rma keeps d1's nominal face
    value there (its pad lets the later dim win and nothing rewrites the
    corner): its error against the golden is recorded, not asserted; with
    the default faces, where d0's value and d1's nominal one are both 0,
    it agrees within 5e-6."""
    sp, jsp = _spec(name), _spec(name, jspec)
    for faces in (True, False):
        x, g, got = _rma(name, shape, (2,), k, iters, per, neu, seed=3,
                         faces=faces)
        ref = golden.golden_iterate(x.astype(np.float64), sp, iters, bc=g.bc)
        out = got.interior().double().numpy()
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
        single = TiledStencil(sp, shape, sweeps_per_call=k,
                              device="cpu").iterate(g, iters)
        assert torch.equal(got.interior(), single.interior())
        jbc = _bc(jgrid, 3, per, neu, faces)
        want = JRmaStencil(jsp, shape, sweeps_per_call=k,
                           interpret=True).iterate(
            jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=1, bc=jbc),
            iters, jmake_mesh((2,), ("x",)))
        jerr = float(np.max(np.abs(np.asarray(want.interior(), np.float64)
                                   - ref)))
        record_property(f"jax_rma_vs_golden_{'faces' if faces else 'default'}",
                        jerr)
        if not faces:
            assert jerr <= TOL


# ---- the gates --------------------------------------------------------------


def _walls_grids(shape, periodic, neumann):
    tg = tgrid.HaloGrid.create(shape, halo=1, bc=_bc(tgrid, len(shape),
                                                     periodic, neumann),
                               device="cpu")
    jg = jgrid.HaloGrid.create(shape, halo=1,
                               bc=_bc(jgrid, len(shape), periodic, neumann))
    return tg, jg


GATES = [  # spec, shape, mesh, k, periodic, neumann
    ("jacobi7", (16, 12, 20), (4,), 1, (2,), ()),       # a periodic lane
    ("jacobi7", (16, 12, 20), (4,), 1, (), (2,)),       # a Neumann lane
    ("asym2d", (64, 40), (4,), 2, (), (0,)),            # asymmetric at k>1
    ("jacobi7", (16, 3, 20), (2,), 4, (1,), ()),        # shallow d1
    ("jacobi7", (16, 3, 20), (2,), 4, (0, 1), (2,)),    # three problems
]


@pytest.mark.parametrize("name,shape,sizes,k,per,neu", GATES)
def test_iterate_gates_match_jax(name, shape, sizes, k, per, neu):
    """``RmaStencil.iterate`` refuses with JAX's message (:830-871), every
    problem joined in its order."""
    tg, jg = _walls_grids(shape, per, neu)
    with pytest.raises(ValueError) as want:
        JRmaStencil(_spec(name, jspec), shape, sweeps_per_call=k,
                    interpret=True).iterate(jg, k,
                                            jmake_mesh(sizes, _axes(sizes)))
    with pytest.raises(ValueError) as got:
        RmaStencil(_spec(name), shape, sweeps_per_call=k).iterate(
            tg, k, make_mesh(sizes, _axes(sizes), device="cpu"))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(
        "periodic/Neumann BCs on the 'rma' method: ")


@pytest.mark.parametrize("name,shape,sizes,k,per,neu", GATES)
def test_registry_gates_match_jax(name, shape, sizes, k, per, neu):
    """``make_rma`` refuses with JAX's ``make_rma`` message
    (registry.py:415-445), the first problem only, "by 'rma'" and
    "at -k {k}" in its words."""
    tg, jg = _walls_grids(shape, per, neu)
    from stencil_tpu.config import RunConfig as JRunConfig

    with pytest.raises(ValueError) as want:
        jregistry.make_rma(JRunConfig(size=shape, temporal=k, mesh=sizes),
                           _spec(name, jspec), jg)
    with pytest.raises(ValueError) as got:
        registry.make_rma(RunConfig(size=shape, temporal=k, mesh=sizes,
                                    device="cpu"), _spec(name), tg)
    assert str(got.value) == str(want.value)


def test_no_not_implemented_error_is_left():
    """Periodic, Neumann and bf16 runs on ``rma`` raise nothing through
    the registry (the refusals that went: "not ported yet (B3-pins /
    B3-bf16)")."""
    for per, neu, dtype in (((0,), (), "float32"), ((), (1,), "float32"),
                            ((), (), "bfloat16"), ((0,), (1,), "bfloat16")):
        cfg = RunConfig(size=(16, 12, 20), spec="jacobi7", temporal=2,
                        mesh=(2,), device="cpu", periodic=per, neumann=neu,
                        dtype=dtype)
        sp = cfg.resolved_spec()
        runner = registry.get_runner("rma", cfg, sp, cli.make_grid(cfg, sp))
        assert runner.plan_info["kernel"] == "rma_iterate"


# ---- the budget in bf16 -----------------------------------------------------


def test_bf16_budget_admits_160_cubed_on_one_rank():
    """The L2 budget counts 2-byte buffers: 160^3 at k=2 on (1,) is
    26,465,664 B in bf16 and runs; in fp32 it is 52,931,328 B and refused.
    JAX refuses the same bf16 shape: its VMEM budget is 41,943,040 B, and
    its lane and sublane rounding pads the block to 164x192x256,
    48,365,568 B over three buffers."""
    sp, jsp = tspec.get_spec("jacobi7"), jspec.get_spec("jacobi7")
    plan = make_rma_plan(sp, (160, 160, 160), "bfloat16", (1,), 2)
    assert plan.resident_bytes == 26_465_664 == 3 * 164 ** 3 * 2
    with pytest.raises(ValueError, match="52931328 B exceeds the L2"):
        make_rma_plan(sp, (160, 160, 160), "float32", (1,), 2)
    with pytest.raises(ValueError) as jax_refusal:
        jmake_rma_plan(jsp, (160, 160, 160), "bfloat16", (1,), 2)
    assert ("(164, 192, 256) x3 buffers = 48365568 B exceeds the "
            "VMEM-resident budget 41943040" in str(jax_refusal.value))


# ---- the tables (pure Python) -----------------------------------------------

GEOMETRY = [  # spec, local shape, mesh, k, periodic, neumann
    ("jacobi7", (6, 7, 5), (3,), 2, (0,), ()),
    ("jacobi7", (6, 7, 5), (1,), 3, (0,), ()),           # a ring of 1
    ("jacobi7", (6, 7, 5), (2,), 2, (0,), (1,)),         # a ring of 2
    ("box:3:1", (6, 7, 5), (3, 2), 3, (1,), (0,)),
    ("box:3:1", (6, 7, 5), (2, 2), 2, (0, 1), ()),
    ("star:3:2", (8, 9, 5), (2, 3), 2, (), (0, 1)),
    ("star:3:2", (8, 9, 5), (2,), 2, (), (1,)),          # the refresh
    ("jacobi27", (6, 7, 5), (3,), 3, (1,), ()),
    ("jacobi27", (6, 7, 5), (1,), 2, (), (0, 1)),
    ("jacobi5", (6, 9), (2, 3), 3, (0,), ()),
    ("box:2:1", (6, 9), (4,), 1, (), (0,)),
    ("jacobi7", (9, 8, 4), (3, 3), 4, (0,), (1,)),
    ("jacobi7", (8, 6, 5), (2,), 2, (), ()),             # Dirichlet too
]


def _plans(name, local, sizes, k, per, neu):
    bc = _bc(tgrid, len(local), per, neu)
    plan = make_rma_plan(_spec(name), local, "float64", sizes, k, bc=bc)
    return bc, [plan.with_sweeps(j) for j in range(1, k + 1)]


def _ids(case):
    name, local, sizes, k, per, neu = case
    return (f"{name}-{'x'.join(map(str, local))}-m"
            f"{'x'.join(map(str, sizes))}-k{k}-p{''.join(map(str, per))}"
            f"-n{''.join(map(str, neu))}")


def _cells(plan, box):
    """The flat offsets of ``box`` in a padded block."""
    idx = np.arange(int(np.prod(plan.block_shape))).reshape(plan.block_shape)
    return set(idx[box].reshape(-1).tolist())


@pytest.mark.parametrize("case", GEOMETRY, ids=_ids)
def test_tables_boxes_in_bounds(case):
    """Every copy of every phase and every update box grown by the radius
    lies inside the padded block; a copy's source and destination have one
    shape."""
    _, plans = _plans(*case)
    for plan in plans:
        r = plan.spec.radius
        boxes = [tuple(slice(s.start - r, s.stop + r) for s in b)
                 for rank in rma_tables(plan).boxes for b in rank]
        for phase in phase_copies(plan):
            for cp in phase:
                boxes += [cp.src, cp.dst]
                assert ([s.stop - s.start for s in cp.src]
                        == [s.stop - s.start for s in cp.dst])
        for box in boxes:
            assert all(0 <= s.start < s.stop <= p
                       for s, p in zip(box, plan.block_shape))


@pytest.mark.parametrize("case", GEOMETRY, ids=_ids)
def test_tables_no_cell_written_twice_or_read_and_written_in_a_phase(case):
    """In each phase (the refresh, then each sharded dim's pushes and
    mirrors), no two copies write one cell and no copy reads a cell that
    another writes: the kernel runs a phase's copies at once, the plain
    version one after another, and both give one result. A ring of 2 (the
    lo and hi neighbour one rank) and of 1 (the rank itself) included."""
    _, plans = _plans(*case)
    for plan in plans:
        for phase in phase_copies(plan):
            written, read = {}, {}
            for cp in phase:
                for c in _cells(plan, cp.dst):
                    key = (cp.dst_rank, c)
                    assert key not in written
                    written[key] = True
                for c in _cells(plan, cp.src):
                    read[(cp.src_rank, c)] = True
            assert not set(written) & set(read)


def _labels(plan, bc, local, sizes):
    """The global grid as labels: interior cell i holds i, a Dirichlet
    face of dim d side s holds -(2d+s+1). Returns the method and mesh to
    scatter it with, the label grid, and each rank's window of it padded
    by the launch's full depth in the golden's order (``fill_halo``),
    stacked: what every buffer cell should hold."""
    shape = tuple(n * m for n, m in zip(local, sizes + (1,) * len(local)))
    kr = plan.layout.halo
    values = tuple((-(2.0 * d + 1), -(2.0 * d + 2))
                   for d in range(len(shape)))
    lbc = tgrid.DirichletBC(values=values, periodic=bc.periodic,
                            neumann=bc.neumann)
    padded = torch.zeros(tuple(n + 2 * kr for n in shape),
                         dtype=torch.float64)
    padded[tuple(slice(kr, kr + n) for n in shape)] = torch.arange(
        float(np.prod(shape)), dtype=torch.float64).reshape(shape)
    tgrid.fill_halo(padded, kr, lbc)
    mesh = make_mesh(sizes, _axes(sizes), device="cpu")
    method = RmaStencil(plan.spec, shape, "float64",
                        plan.sweeps_per_call)
    windows = []
    for rank in range(plan.ranks):
        window = tuple(slice(s.start, s.stop + 2 * kr)
                       for s in method._block(mesh, plan, rank))
        windows.append(padded[window])
    g = tgrid.HaloGrid.from_interior(
        padded[tuple(slice(kr, kr + n) for n in shape)].clone(), halo=1,
        bc=lbc, device="cpu")
    return method, mesh, g, torch.stack(windows)


@pytest.mark.parametrize("case", GEOMETRY, ids=_ids)
def test_tables_every_read_is_the_goldens_value(case):
    """Labels stand for values: each interior cell of the global grid its
    own number, each Dirichlet face its own negative code, padded in the
    golden's order. The scatter of that grid, with every live ghost cell
    poisoned (NaN) in every buffer, then one step of every launch depth:
    the phases as the plain version runs them, and each sweep writing into
    its update box the labels the golden holds there. Every cell a sweep
    reads must hold the golden's label: what a phase wrote this step,
    what the last sweep wrote, or a Dirichlet constant from the scatter
    (corners of a Dirichlet band and a live band included). The last
    sweep writes the interior, and no Dirichlet cell changes."""
    name, local, sizes, k, per, neu = case
    bc, plans = _plans(*case)
    for plan in plans:
        method, mesh, g, want = _labels(plan, bc, local, sizes)
        bufs = method.scatter(g, mesh, plan)
        constant = want < 0  # a Dirichlet face's code
        for rank in range(plan.ranks):
            for b in range(plan.num_buffers):
                inside = torch.zeros(plan.block_shape, dtype=torch.bool)
                inside[plan.layout.interior_index] = True
                poison = ~(inside | constant[rank])
                assert torch.equal(bufs[rank, b][~poison],
                                   want[rank][~poison])
                bufs[rank, b][poison] = float("nan")
        slot, r = 1, plan.spec.radius
        exchange_reference(bufs, plan, slot)
        for t in range(1, plan.sweeps_per_call + 1):
            src, dst = buffer_of(plan, t - 1, slot), buffer_of(plan, t, slot)
            for rank in range(plan.ranks):
                box = rma_tables(plan).boxes[rank][t - 1]
                grown = tuple(slice(s.start - r, s.stop + r) for s in box)
                assert torch.equal(bufs[rank, src][grown], want[rank][grown])
                bufs[rank, dst][box] = want[rank][box]
        for rank in range(plan.ranks):
            assert rma_tables(plan).boxes[rank][-1] == \
                plan.layout.interior_index
            out = bufs[rank, 1 - slot][plan.layout.interior_index]
            assert torch.equal(out, want[rank][plan.layout.interior_index])
            for b in range(plan.num_buffers):
                assert torch.equal(bufs[rank, b][constant[rank]],
                                   want[rank][constant[rank]])


def _kernel_pairs(plan, geom, table):
    """The exchange as the kernel applies it (rma_iterate.cu: the opening
    exchange, and each tile's pairs after its level k): the pairs of the
    device table at the geometry's offsets, each (destination rank,
    offset, source rank, offset) in a padded block, the kernel's per-card
    ``i * nbuf * block + offset`` indices (the card's i-th rank; the
    destination's card in the pair, the source on the writing tile's
    card, found from the geometry's first rank of each card) decoded."""
    per_rank = int(geom[1]) * int(np.prod(plan.block_shape))
    npairs, start, ntiles = int(geom[27]), int(geom[30]), int(geom[8])
    pairs = table[start:start + 4 * npairs].reshape(-1, 4)
    pair_ptr = table[geom[29]:geom[29] + ntiles + 1]
    place = np.repeat(np.arange(ntiles), np.diff(pair_ptr)) // (
        ntiles // plan.ranks)
    first = geom[38:38 + geom[33] + 1]
    writer = np.searchsorted(first, place, side="right") - 1
    d_i, d_off = np.divmod(pairs[:, 1], per_rank)
    s_i, s_off = np.divmod(pairs[:, 2], per_rank)
    d_rank = [plan.card_ranks[c][i] for c, i in zip(pairs[:, 0], d_i)]
    s_rank = [plan.card_ranks[c][i] for c, i in zip(writer, s_i)]
    return sorted(zip(d_rank, d_off.tolist(), s_rank, s_off.tolist()))


@pytest.mark.parametrize("case", GEOMETRY, ids=_ids)
def test_kernel_geometry_gives_the_plain_versions_copies(case):
    """The kernel's geometry (``_geometry``) and device table
    (``device_table``), read as the kernel reads them, give the copies of
    :func:`phase_copies` cell for cell: each phase walked in order on the
    cells' own labels (the mirrors' flip included, corners riding through
    earlier phases), every cell the phases write paired with the cell
    whose value it ends up holding."""
    _, plans = _plans(*case)
    for plan in plans:
        geom = _geometry(plan, 1, 0)
        table = device_table(plan, torch.device("cpu")).numpy()
        block = int(np.prod(plan.block_shape))
        label = np.arange(plan.ranks * block).reshape(
            (plan.ranks,) + plan.block_shape)
        written = np.zeros(label.shape, bool)
        for phase in phase_copies(plan):
            new = label.copy()
            for cp in phase:
                src = torch.from_numpy(label[(cp.src_rank,) + cp.src])
                if cp.flip is not None:
                    src = torch.flip(src, (cp.flip,))
                new[(cp.dst_rank,) + cp.dst] = src.numpy()
                written[(cp.dst_rank,) + cp.dst] = True
            label = new
        d_rank, d_off = np.divmod(np.nonzero(written.reshape(-1))[0], block)
        s_rank, s_off = np.divmod(label.reshape(-1)[written.reshape(-1)],
                                  block)
        keep = (d_rank * block + d_off) != (s_rank * block + s_off)
        want = sorted(zip(d_rank[keep].tolist(), d_off[keep].tolist(),
                          s_rank[keep].tolist(), s_off[keep].tolist()))
        assert _kernel_pairs(plan, geom, table) == want


def test_ring_neighbours():
    """A ring of 2 has the other rank on both sides, a ring of 1 itself; a
    Neumann face is a mirror, a Dirichlet face keeps its ghosts."""
    def nbrs(sizes, per, neu):
        bc = _bc(tgrid, 3, per, neu)
        plan = make_rma_plan(tspec.get_spec("jacobi7"), (6, 6, 5), "float32",
                             sizes, 1, bc=bc)
        return rma_tables(plan).neighbours

    assert nbrs((2,), (0,), ()) == (((1, 1),), ((0, 0),))
    assert nbrs((1,), (0,), ()) == (((0, 0),),)
    assert nbrs((3,), (), (0,)) == (((-2, 1),), ((0, 2),), ((1, -2),))
    assert nbrs((2, 2), (1,), (0,)) == (((-2, 2), (1, 1)),
                                        ((-2, 3), (0, 0)),
                                        ((0, -2), (3, 3)),
                                        ((1, -2), (2, 2)))
    assert nbrs((2,), (), ()) == (((-1, 1),), ((0, -1),))


def test_the_refresh_is_d1_of_a_3d_grid_on_a_1d_mesh_only():
    """At most one dim is dynamic and unsharded: d1 of a 3D grid on a 1D
    mesh. A dynamic lane dim and a refreshed dim shallower than k*r are
    refused by the plan."""
    j7 = tspec.get_spec("jacobi7")
    plan = make_rma_plan(j7, (6, 6, 5), "float32", (2,), 2,
                         bc=_bc(tgrid, 3, (0, 1), ()))
    assert plan.refresh_dim == 1
    # the refresh wraps: a lo ghost row of d1 takes the last interior row
    dst, src = ghost_map(plan)
    h, (p0, p1, p2) = plan.layout.halo, plan.block_shape
    cell = (h * p1 + h - 1) * p2 + h
    assert dict(zip(dst.tolist(), src.tolist()))[cell] == \
        (h * p1 + h + 5) * p2 + h
    for sizes, per in (((2, 2), (0, 1)), ((2,), (0,))):
        assert make_rma_plan(j7, (6, 6, 5), "float32", sizes, 1,
                             bc=_bc(tgrid, 3, per, ())).refresh_dim is None
    assert make_rma_plan(tspec.get_spec("jacobi5"), (6, 9), "float32", (2,),
                         1, bc=_bc(tgrid, 2, (0,), ())).refresh_dim is None
    with pytest.raises(ValueError, match="lane"):
        make_rma_plan(j7, (6, 6, 5), "float32", (2,), 1,
                      bc=_bc(tgrid, 3, (2,), ()))
    with pytest.raises(ValueError, match="shallower than k\\*r = 3"):
        make_rma_plan(j7, (6, 2, 5), "float32", (1,), 3,
                      bc=_bc(tgrid, 3, (), (1,)))


# ---- the launch: resumption, counts, bf16 conversion ------------------------


@pytest.mark.parametrize("sizes,k,steps,per,neu,dtype", [
    ((2,), 2, 2, (0,), (1,), "float32"),
    ((2, 2), 3, 3, (1,), (0,), "float32"),
    ((1,), 1, 3, (), (0, 1), "float32"),
    ((2,), 2, 3, (0, 1), (), "bfloat16"),
])
def test_plain_launch_resumes_from_either_slot(sizes, k, steps, per, neu,
                                               dtype):
    """``n`` steps from slot 0 then ``m`` from slot ``n % 2`` are ``n + m``
    steps from slot 0, whole buffer tensor bitwise, with dynamic walls (the
    refresh and the mirrors read the slot they resume from)."""
    bc = _bc(tgrid, 3, per, neu)
    plan = make_rma_plan(tspec.get_spec("jacobi7"), (6, 7, 5), dtype, sizes,
                         k, bc=bc)
    bufs = torch.from_numpy(_x(plan.buffer_shape, seed=4)).to(
        tgrid.torch_dtype(dtype))
    one = rma_iterate_reference(bufs.clone(), plan, steps + 2)
    two = rma_iterate_reference(bufs.clone(), plan, steps)
    rma_iterate_reference(two, plan, 2, steps % 2)
    assert torch.equal(one, two)


def test_counts_move_only_on_a_launch():
    """The plain version on a CPU tensor counts no launch, whatever the
    walls and dtype."""
    rma_iterate.reset_counts()
    _rma("jacobi7", (16, 16, 20), (2,), 2, 5, (0,), (1,), "bfloat16")
    assert (rma_iterate.launches, rma_iterate.pins_launches,
            rma_iterate.bf16_launches) == (0, 0, 0)


def test_convert_bf16_grid_through_rma():
    """A JAX bf16 grid on dynamic walls, carried across by
    ``convert.grid_from_arrays`` (as uint16 bits), through ``rma`` in bf16,
    and back: within 3e-2 of JAX's ``RmaStencil`` on the same grid
    (interpret mode) and of the golden."""
    shape, sizes, k, iters = (16, 16, 20), (2,), 2, 4
    x = _x(shape, 12)
    jbc = _bc(jgrid, 3, (0,), (), faces=True)
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x, jnp.bfloat16), halo=1,
                                      bc=jbc)
    tg = convert.grid_from_arrays(np.asarray(jg.data), jg.halo,
                                  jg.bc.values, jg.bc.periodic,
                                  jg.bc.neumann, device="cpu")
    assert tg.dtype == torch.bfloat16
    got = RmaStencil(tspec.get_spec("jacobi7"), shape, "bfloat16",
                     k).iterate(tg, iters, make_mesh(sizes, ("x",),
                                                     device="cpu"))
    want = JRmaStencil(jspec.get_spec("jacobi7"), shape, "bfloat16", k,
                       interpret=True).iterate(jg, iters,
                                               jmake_mesh(sizes, ("x",)))
    out = got.interior().float().numpy()
    np.testing.assert_allclose(
        out, np.asarray(want.interior(), np.float32), atol=BF16_TOL,
        rtol=BF16_TOL)
    ref = jgolden.golden_iterate(
        np.asarray(jg.interior(), np.float64), jspec.get_spec("jacobi7"),
        iters, bc=jbc)
    np.testing.assert_allclose(out, ref, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("argv", [
    ["--periodic", "0"], ["--neumann", "0"], ["--dtype", "bfloat16"],
    ["--periodic", "1", "--neumann", "0"],
])
def test_cli_rma_beside_tiled_on_dynamic_walls(capsys, argv):
    """``-m tiled rma --mesh 2 -k 2 -c`` with dynamic walls or in bf16 on
    the CPU: both pass the golden check (bf16 at its 3e-2 bar) and print
    the same max abs error."""
    import re

    rc = cli.main(["-s", "16", "16", "16", "-i", "4", "--spec", "jacobi7",
                   "-m", "tiled", "rma", "--mesh", "2", "-k", "2", "-c",
                   "--device", "cpu", "--repeat", "1", *argv])
    out = capsys.readouterr().out
    errs = dict(re.findall(r"\[(\w+)\] correctness: OK .* max abs err "
                           r"(\S+),", out))
    assert rc == 0 and set(errs) == {"tiled", "rma"}, out
    assert errs["rma"] == errs["tiled"]
