"""The tiled kernel's two-level (leapfrog) mode on the d0 march
(csrc/tiled_march.cu), on the CPU: a pure-Python emulation of the march's
two-level steps (the rings at the kernel's depth of 2r+3 planes, their
slots, ``prev`` at level 1, the subtrahend from level s-2's ring, the
second output from level k-1's centre plane) against the plain version
(``sweep_reference``) bitwise on both outputs; a proof over the slot
tables that no step reads a ring slot written in that step, which 2r+2
slots would break; the plan rule and the rings' bytes; and
``WaveEquation.simulate(method="tiled")`` on a march plan against JAX's
``WaveEquation`` on its tiled kernel in interpret mode and against the
float64 golden loop. The kernel itself is held against its plain version
and the window's launch on a card by tests/test_torch_cuda.py.

The emulation follows the kernel's index arithmetic: level s computes
plane m at step m + L_s, L_s = s(r+1) - 1; plane m of level s lives in
slot (m + L_{s+1}) mod S; at step j every level reads slots j-r .. j+r of
the level below, the subtrahend from slot j-r-1 of the level two below,
and writes slot j+r+1.

Tolerances: emulation vs plain version bitwise (``torch.equal``); the
wave on a march plan 5e-6 from JAX's tiled kernel and 5e-4 from the
float64 golden loop, the bars of tests/test_torch_wave.py."""

import itertools

import numpy as np
import pytest
import torch

from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.models import wave as jwave
from stencil_tpu_torch import convert, tile_sweep
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.models import wave as twave
from stencil_tpu_torch.multigrid import nbsum_spec
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
from stencil_tpu_torch.ops.tiled import (
    _MARCH_T_CANDIDATES, MARCH_T0_CANDIDATES, MARCH_TWO_LEVEL_COST_CONSTANTS,
    SMEM_LIMIT, choose_march_tiles, make_tiled_plan, march_fits, march_slots,
    march_smem_bytes, wave_iterate,
)
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

TOL = 5e-6
GOLDEN_TOL = 5e-4
CFG9 = (256, 256, 256)


def _lag(s: int, r: int) -> int:
    """Steps level s runs behind the input: L_s = s(r+1) - 1."""
    return s * (r + 1) - 1


def two_level_schedule(t0: int, k: int, r: int, S: int):
    """The kernel's steps of one block at ring depth ``S``: a list, per
    step j = -1 .. last, of (level, plane, write slot, tap slots,
    subtrahend slot) tuples; level 0 is the input plane's fetch, level k
    writes no slot, level 1 takes its subtrahend from ``prev`` (None)."""
    planes = t0 + 2 * k * r
    last = t0 + k * r - 1 + _lag(k, r)
    steps = [[(0, 0, r % S, (), None)]]
    for j in range(last + 1):
        c, w = j % S, (j + r + 1) % S
        step = [(0, j + 1, w, (), None)] if j + 1 < planes else []
        for s in range(1, k + 1):
            m = j - _lag(s, r)
            if s * r <= m < planes - s * r:
                step.append((s, m, w if s < k else None,
                             tuple((c + d) % S for d in range(-r, r + 1)),
                             (j - r - 1) % S if s >= 2 else None))
        steps.append(step)
    return steps


def races(t0: int, k: int, r: int, S: int):
    """The (step, level, ring, slot) of every read in the schedule at depth
    ``S`` that hits a slot some level writes in the same step, or that
    finds another plane than the one it wants; asserts every read finds a
    plane written in an earlier step."""
    held = {}  # (ring, slot) -> (plane, step)
    found = []
    for j, step in enumerate(two_level_schedule(t0, k, r, S), -1):
        writes = {(s, w) for s, _, w, _, _ in step if w is not None}
        for s, m, _, taps, sb in step:
            reads = [(s - 1, q, m + d)
                     for d, q in zip(range(-r, r + 1), taps)]
            if sb is not None:
                reads.append((s - 2, sb, m))
            for ring, q, want in reads:
                plane, done = held[(ring, q)]
                assert done < j
                if (ring, q) in writes or plane != want:
                    found.append((j, s, ring, q))
        for s, m, w, _, _ in step:
            if w is not None:
                held[(s, w)] = (m, j)
    return found


def emulate(plan, cur, prev, pins=(1, 1, 1, 1)):
    """One two-level launch of the march ``plan`` as the kernel runs it,
    block by block and step by step through per-level rings of
    ``march_slots(r, True)`` planes: returns ``(out, out2)``, clones of
    ``cur`` and ``prev`` with the tiles written. Asserts every read finds
    the plane it wants, written in an earlier step and not in this one."""
    k, r = plan.sweeps_per_call, plan.spec.radius
    S, H = march_slots(r, True), plan.layout.halo
    n0, n1, n2 = plan.interior_shape
    t0, t1, t2 = plan.tiles
    nt0, nt1, nt2 = plan.num_tiles
    kr = k * r
    out, out2 = cur.clone(), prev.clone()
    rows = [t1 + 2 * (k - s) * r for s in range(k + 1)]
    cols = [t2 + 2 * (k - s) * r for s in range(k + 1)]
    steps = two_level_schedule(t0, k, r, S)
    for i0 in range(nt0):
        for i1 in range(nt1):
            for i2 in range(nt2):
                a0 = min(i0 * t0, n0 - t0) + H - kr
                o1 = min(i1 * t1, n1 - t1) + H - kr
                o2 = min(i2 * t2, n2 - t2) + H - kr
                rings = [torch.zeros((S, rows[s], cols[s]), dtype=cur.dtype)
                         for s in range(k)]
                tags = [[None] * S for _ in range(k)]
                for j, step in enumerate(steps, -1):
                    written = {(s, w) for s, _, w, _, _ in step
                               if w is not None}

                    def read(ring, q, plane):
                        assert (ring, q) not in written, (j, ring, q)
                        assert tags[ring][q][0] == plane, (j, ring, q)
                        assert tags[ring][q][1] < j
                        return rings[ring][q]

                    for s, m, w, taps, sb in step:
                        if s == 0:
                            rings[0][w] = cur[a0 + m, o1:o1 + rows[0],
                                              o2:o2 + cols[0]]
                            tags[0][w] = (m, j)
                            continue
                        block = torch.stack([
                            read(s - 1, q, m + d)
                            for d, q in zip(range(-r, r + 1), taps)])
                        v = eager.apply_spec(block, plan.spec, halo=r)[0]
                        p0, r1, r2 = a0 + m, o1 + s * r, o2 + s * r
                        box = (p0, slice(r1, r1 + rows[s]),
                               slice(r2, r2 + cols[s]))
                        if s == 1:
                            v = v - prev[box]
                        else:
                            v = v - read(s - 2, sb, m)[
                                2 * r:2 * r + rows[s], 2 * r:2 * r + cols[s]]
                        y = torch.arange(r1, r1 + rows[s])[:, None]
                        x = torch.arange(r2, r2 + cols[s])[None, :]
                        upd = ((not pins[0] or p0 >= H)
                               and (not pins[1] or p0 < H + n0)) \
                            & ((y >= H) | (not pins[2])) \
                            & ((y < H + n1) | (not pins[3])) \
                            & (x >= H) & (x < H + n2)
                        centre = block[r, r:r + rows[s], r:r + cols[s]]
                        v = torch.where(upd, v, centre)
                        if s < k:
                            rings[s][w] = v
                            tags[s][w] = (m, j)
                        else:
                            assert bool(upd.all())  # the tile: interior
                            out[box] = v
                            out2[box] = centre
    return out, out2


def _wave_spec(dt=0.5):
    """The wave spec (7 taps, two groups); dt = 0.5 keeps its centre
    weight (2 - 6 s^2 = 0.5) nonzero."""
    return twave.WaveEquation(shape=(8, 8, 8), dt=dt, device="cpu").spec


def _padded(plan, rng, dtype):
    """A random padded level; the live faces' ghosts random too (standing
    in for a refresh: the kernel and the plain version read them alike)."""
    return torch.from_numpy(rng.standard_normal(plan.layout.padded_shape)
                            .astype(np.float32)).to(dtype)


CASES = [  # spec, interior, k, tiles, pins, dtype
    ("wave", (10, 9, 11), 1, (4, 4, 8), (1, 1, 1, 1), "float32"),
    ("wave", (10, 9, 11), 2, (4, 4, 8), (0, 0, 1, 1), "float32"),
    ("wave", (11, 10, 9), 3, (5, 4, 4), (1, 1, 0, 0), "float32"),
    ("wave", (9, 8, 10), 5, (4, 4, 4), (0, 0, 0, 0), "float32"),
    ("wave", (9, 8, 10), 8, (4, 3, 5), (1, 1, 1, 1), "float32"),
    ("star3d_r2", (10, 9, 11), 2, (4, 4, 8), (0, 0, 0, 0), "float32"),
    ("star3d_r2", (11, 9, 10), 3, (5, 4, 4), (1, 1, 1, 1), "float32"),
    ("jacobi27", (9, 10, 11), 2, (3, 4, 8), (1, 1, 0, 0), "float32"),
    ("wave", (10, 9, 11), 1, (4, 4, 8), (0, 0, 0, 0), "bfloat16"),
    ("wave", (10, 9, 11), 3, (4, 4, 8), (0, 0, 1, 1), "bfloat16"),
    ("wave", (9, 10, 8), 8, (4, 4, 4), (1, 1, 0, 0), "bfloat16"),
    ("star3d_r2", (9, 10, 8), 2, (4, 8, 4), (1, 1, 1, 1), "bfloat16"),
    ("star3d_r2", (10, 9, 11), 5, (3, 4, 5), (0, 0, 1, 1), "bfloat16"),
]


@pytest.mark.parametrize("name,shape,k,tiles,pins,dtype", CASES)
def test_emulation_is_the_plain_version(name, shape, k, tiles, pins, dtype):
    """The march's two-level steps reproduce the plain version bitwise on
    both outputs (L_{n+k} and L_{n+k-1}): ragged grids (clamped tiles and
    chunks), k = 1, 2, 3, 5, 8, radius 1 and 2, the wave spec unrolled and
    a table spec, every kind of pins, fp32 and bf16."""
    rng = np.random.default_rng(11)
    spec = _wave_spec() if name == "wave" else get_spec(name)
    plan = make_tiled_plan(spec, shape, dtype, k, tiles=tiles,
                           two_level=True, schedule="march")
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cur, prev = _padded(plan, rng, tdt), _padded(plan, rng, tdt)
    if all(pins):  # Dirichlet walls: both levels hold the same ghosts
        idx = plan.layout.interior_index
        both = cur.clone()
        both[idx] = prev[idx]
        prev = both
    got = emulate(plan, cur, prev, pins)
    want = sweep_reference(cur, plan, prev=prev, pins=pins)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("r", [1, 2, 3])
def test_slots_race_free_at_2r_plus_3_and_not_at_2r_plus_2(r):
    """For k = 1 .. 16: with the kernel's 2r+3 slots no step reads a ring
    slot that a level writes in that step, and every read finds its plane;
    with 2r+2 slots the subtrahend (level s-2's plane, slot j-r-1) is the
    slot level s-2 writes in the same step, from k = 2 on."""
    for k in range(1, 17):
        t0 = 3 + k
        assert march_slots(r, True) == 2 * r + 3
        assert not races(t0, k, r, 2 * r + 3), k
        bad = races(t0, k, r, 2 * r + 2)
        assert bool(bad) == (k >= 2), k
        assert all(ring == s - 2 and q == (j + r + 1) % (2 * r + 2)
                   for j, s, ring, q in bad)


def test_plan_rule_and_ring_bytes():
    """A two-level plan marches where its deeper rings fit (cfg9 at 256^3
    k=8, fp32 and bf16), ``schedule="window"`` still gives the window,
    ``schedule="march"`` is accepted; the Chebyshev and dual plans march
    on the same 2r+3-plane rings. The rings take 2r+3 planes per
    level."""
    spec = twave.WaveEquation(shape=CFG9, device="cpu").spec
    assert march_smem_bytes((128, 32, 32), 8, 1, 4, True) == 272_320
    assert march_smem_bytes((128, 32, 24), 8, 1, 4, True) == 219_840
    assert march_smem_bytes((64, 32, 64), 8, 1, 2, True) == 241_120
    assert march_smem_bytes((128, 32, 32), 8, 1) == 217_856
    assert march_fits((128, 32, 32), 8, 1, 4)
    assert not march_fits((128, 32, 32), 8, 1, 4, True)
    assert march_fits((128, 32, 24), 8, 1, 4, True)
    assert not march_fits((64, 32, 64), 8, 1, 2, True)
    for dtype in ("float32", "bfloat16"):
        item = 2 if dtype == "bfloat16" else 4
        plan = make_tiled_plan(spec, CFG9, dtype, 8, two_level=True)
        assert plan.schedule == "march" and plan.two_level
        assert plan.tiles == choose_march_tiles(
            spec, CFG9, 8, dtype=dtype, deep=True,
            constants=MARCH_TWO_LEVEL_COST_CONSTANTS)
        assert plan.smem_bytes == march_smem_bytes(
            plan.tiles, 8, 1, item, True) <= SMEM_LIMIT
        assert make_tiled_plan(spec, CFG9, dtype, 8, two_level=True,
                               schedule="march") == plan
        window = make_tiled_plan(spec, CFG9, dtype, 8, two_level=True,
                                 schedule="window")
        assert window.schedule == "window"
        assert window.layout == plan.layout
        assert plan.with_sweeps(3).schedule == "march"
        assert plan.with_sweeps(1).schedule == "march"  # the remainder
        # one sweep takes the window, unless the march is asked for
        assert make_tiled_plan(spec, CFG9, dtype, 1,
                               two_level=True).schedule == "window"
        assert make_tiled_plan(spec, CFG9, dtype, 1, two_level=True,
                               schedule="march").schedule == "march"
        assert make_tiled_plan(spec, CFG9, dtype, 2,
                               two_level=True).schedule == "march"
    # the plain march's tile at cfg9 is refused for the two-level rings
    with pytest.raises(ValueError, match="do not fit the march"):
        make_tiled_plan(spec, CFG9, "float32", 8, tiles=(128, 32, 32),
                        two_level=True, schedule="march")
    nb = nbsum_spec(3)
    co = ((1.0, 0.1, 0.0, -0.1), (0.9, 0.2, -0.1, -0.2))
    for dual in (False, True):
        cheby = make_tiled_plan(nb, (16, 16, 16), "float32", 2,
                                has_source=True, cheby_coeffs=co,
                                cheby_dual=dual)
        assert cheby.schedule == "march"
        march = make_tiled_plan(nb, (16, 16, 16), "float32", 2,
                                has_source=True, cheby_coeffs=co,
                                cheby_dual=dual, schedule="march")
        assert march.schedule == "march" and march.reads_older
        assert march.smem_bytes == march_smem_bytes(march.tiles, 2, 1, 4,
                                                    True)


def test_chooser_and_rule_on_the_committed_rows():
    """On the two-level tile sweep at cfg9 (H100,
    ``data/march_two_level_tiles_h100.csv``: every candidate that fits,
    and the window's own tile) the chooser picks the fastest measured tile
    of every case, and the plan marches exactly where the march's pick
    beat the window (from k=2 on); on the held-out 257^3 k=8, never
    fitted, its pick is within 1.2x of the fastest tile."""
    rows = tile_sweep.read_two_level_rows(
        tile_sweep.DATA_DIR / "march_two_level_tiles_h100.csv")
    assert set(rows) == set(tile_sweep.TWO_LEVEL_CASES)
    for r in tile_sweep.score_two_level(rows):
        name, shape, k, dtype, _ = r["case"]
        item = 2 if dtype == "bfloat16" else 4
        measured = rows[r["case"]]["march"]
        assert all(march_fits(t, k, 1, item, True) for t in measured)
        assert len(measured) == sum(
            march_fits(t, k, 1, item, True) for t in {
                tuple(min(c, n) for c, n in zip(cand, shape))
                for cand in itertools.product(
                    MARCH_T0_CANDIDATES, _MARCH_T_CANDIDATES,
                    _MARCH_T_CANDIDATES)})
        assert r["ratio"] == 1.0, r
        window_ms = r["window"][1]
        assert r["schedule"] == ("march" if r["pick_ms"] < window_ms
                                 else "window"), r
    held = tile_sweep.read_two_level_rows(
        tile_sweep.DATA_DIR / "march_two_level_tiles_h100_held_out.csv")
    assert set(held) == set(tile_sweep.TWO_LEVEL_HELD_OUT)
    for r in tile_sweep.score_two_level(held):
        assert r["ratio"] <= 1.2 and r["schedule"] == "march", r
        assert r["pick_ms"] < r["window"][1]


def test_two_level_fit_keeps_the_committed_constants():
    """The refit over the march fit grid (``tile_sweep.fit_two_level``)
    ranks first the committed two-level constants: of the constants that
    pick the fastest tile of every case, the nearest to the homogeneous
    mode's."""
    rows = tile_sweep.read_two_level_rows(
        tile_sweep.DATA_DIR / "march_two_level_tiles_h100.csv")
    ranked = tile_sweep.fit_two_level(rows)
    assert ranked[0][1] == MARCH_TWO_LEVEL_COST_CONSTANTS
    assert ranked[0][0] == 1.0


@pytest.mark.parametrize("pins,n_outer,rem", [((1, 1, 1, 1), 2, 1),
                                              ((0, 0, 1, 1), 1, 2)])
def test_emulated_launches_are_wave_iterate(pins, n_outer, rem):
    """``wave_iterate``'s rotation of four padded tensors over ``n_outer``
    march launches and a remainder launch (``with_sweeps``), each launch
    emulated, is the plain version's ``wave_iterate`` bitwise."""
    spec, shape, k = _wave_spec(), (10, 9, 11), 3
    plan = make_tiled_plan(spec, shape, "float32", k, tiles=(4, 4, 8),
                           two_level=True)
    assert plan.schedule == "march"
    bc = DirichletBC.zero(3)
    if not pins[0]:
        bc = bc.with_periodic((0,))
    rng = np.random.default_rng(5)
    h1 = [torch.nn.functional.pad(torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)), (1,) * 6)
        for _ in range(2)]
    want = wave_iterate(plan, h1[0], h1[1], bc, n_outer, rem=rem)
    from stencil_tpu_torch.ops.layout import refresh_dynamic_layout

    cur = plan.layout.pad(h1[0][1:-1, 1:-1, 1:-1], bc)
    prev = plan.layout.pad(h1[1][1:-1, 1:-1, 1:-1], bc)
    launches = [plan] * n_outer + [plan.with_sweeps(rem)]
    for lp in launches:
        assert lp.schedule == "march"
        refresh_dynamic_layout(cur, plan.layout, bc, lp.halo)
        refresh_dynamic_layout(prev, plan.layout, bc, lp.halo)
        cur, prev = emulate(lp, cur, prev, pins)
    for got, w in zip((cur, prev), want):
        assert torch.equal(plan.layout.unpad(got), w[1:-1, 1:-1, 1:-1])


def _waves(shape):
    """The same wave problem in both packages (zero walls)."""
    jbc = JBC.zero(len(shape))
    jw = jwave.WaveEquation(shape=shape, bc=jbc)
    tw = convert.wave_from_arrays(shape, jw.c, jw.h, jw.dt, jbc.values,
                                  jbc.periodic, jbc.neumann, device="cpu")
    return jw, tw


@pytest.mark.parametrize("shape,k,steps", [((12, 14, 16), 4, 5),
                                           ((13, 11, 9), 3, 4)])
def test_wave_on_a_march_plan_matches_jax_and_golden(shape, k, steps):
    """``WaveEquation.simulate(method="tiled")`` on a march plan (the
    plan ``make_tiled_plan`` gives it) against JAX's ``WaveEquation`` on
    its tiled kernel in interpret mode, and against the float64 golden
    loop; no kernel launch on the CPU."""
    rng = np.random.default_rng(0)
    jw, tw = _waves(shape)
    assert make_tiled_plan(tw.spec, shape, "float32", k,
                           two_level=True).schedule == "march"
    u0 = rng.normal(size=shape)
    want = jw.simulate_interior(u0, steps, method="pallas_tiled",
                                sweeps_per_call=k, interpret=True)
    before = tiled_sweep.launches
    got = tw.simulate_interior(u0, steps, method="tiled", sweeps_per_call=k)
    assert tiled_sweep.launches == before
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    golden = twave.golden_wave(u0, tw.spec, steps, tw.bc,
                               dt=tw.courant * tw.h / tw.c)
    np.testing.assert_allclose(got, golden, atol=GOLDEN_TOL, rtol=0)
