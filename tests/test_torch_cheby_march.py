"""The tiled kernel's Chebyshev and dual modes on the d0 march
(csrc/tiled_march.cu), on the CPU: a pure-Python emulation of the march's
Chebyshev steps (the rings at the kernel's depth of 2r+3 planes, their
slots, f at the point, u_{t-2} from level s-2's ring from level 2 on, the
dual output from level k-1's centre plane, tile subsets) against the plain
version (``sweep_reference``, ``subset_reference``) bitwise; a proof over
the slot tables that no step reads a ring slot written in that step, which
2r+2 slots would break; the plan rule and the rings' bytes; the chooser
and the schedule rule on the committed tile sweep; a march plan's launches
through their plain version against JAX's tiled kernel in interpret mode
(``_cached_cheby_dual_fn`` and the Chebyshev sweep); and a multigrid cycle
on a marching fine level against JAX's. The kernel itself is held against
its plain version and the window's launch on a card by
tests/test_torch_cuda.py.

The emulation follows the kernel's index arithmetic: level s computes
plane m at step m + L_s, L_s = s(r+1) - 1; plane m of level s lives in
slot (m + L_{s+1}) mod S; at step j every level reads slots j-r .. j+r of
the level below, level s >= 2 its u_{t-2} from slot j-r-1 of the level two
below, and writes slot j+r+1. Each update is the plain version's
``((n*S(u) + c*u) + s*f) + pv*prev``, one torch op at a time.

Tolerances: emulation vs plain version bitwise (``torch.equal``); against
JAX's tiled kernel in interpret mode 5e-6 in fp32 (the two may round the
same steps in another order; the residual output scaled by its 1/h^2) and
3e-2 in bf16 (the repo's bf16 bar); the multigrid cycle 5e-6, the bar of
tests/test_torch_multigrid.py's tiled fine level."""

import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.multigrid import nbsum_spec as jnbsum_spec
from stencil_tpu.ops import pallas_tiled as jpt
from stencil_tpu_torch import convert, tile_sweep
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.multigrid import _cheby_sweep_coeffs, nbsum_spec
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.ops.layout import pad_source
from stencil_tpu_torch.ops.sweep_kernel import (
    cheby_of, subset_reference, sweep_reference,
)
from stencil_tpu_torch.ops.tiled import (
    _MARCH_T_CANDIDATES, MARCH_COST_CONSTANTS, MARCH_T0_CANDIDATES,
    SMEM_LIMIT, cheby_dual, choose_march_tiles, make_tiled_plan,
    march_constants, march_fits, march_slots, march_smem_bytes,
    partition_tiles,
)
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

TOL = 5e-6
BF16_TOL = 3e-2
NB = nbsum_spec(3)
BC = ((0.5, -1.0), (2.0, 0.25), (1.0, 1.5))


def _lag(s: int, r: int) -> int:
    """Steps level s runs behind the input: L_s = s(r+1) - 1."""
    return s * (r + 1) - 1


def cheby_schedule(t0: int, k: int, r: int, S: int):
    """The kernel's steps of one block at ring depth ``S``: a list, per
    step j = -1 .. last, of (level, plane, write slot, tap slots, u_{t-2}
    slot) tuples; level 0 is the input plane's fetch, level k writes no
    slot, level 1 has no u_{t-2} term (None)."""
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
    for j, step in enumerate(cheby_schedule(t0, k, r, S), -1):
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


def emulate(plan, cur, src, nxt=None, out2=None, subset=None):
    """One Chebyshev or dual launch of the march ``plan`` as the kernel
    runs it, block by block and step by step through per-level rings of
    ``march_slots(r, True)`` planes, over every tile column or the column
    ids of ``subset``: returns the output (and in the dual mode the pair
    with the second output), clones of ``nxt`` and ``out2`` (default
    ``cur``) with the columns' tiles written. Asserts every read finds the
    plane it wants, written in an earlier step and not in this one."""
    k, r = plan.sweeps_per_call, plan.spec.radius
    S, H = march_slots(r, True), plan.layout.halo
    n0, n1, n2 = plan.interior_shape
    t0, t1, t2 = plan.tiles
    nt0, nt1, nt2 = plan.num_tiles
    kr = k * r
    co = cheby_of(plan)
    out = (cur if nxt is None else nxt).clone()
    second = (cur if out2 is None else out2).clone()
    rows = [t1 + 2 * (k - s) * r for s in range(k + 1)]
    cols = [t2 + 2 * (k - s) * r for s in range(k + 1)]
    steps = cheby_schedule(t0, k, r, S)
    columns = range(nt0 * nt1) if subset is None else subset
    for col, i2 in itertools.product(columns, range(nt2)):
        i0, i1 = divmod(col, nt1)
        a0 = min(i0 * t0, n0 - t0) + H - kr
        o1 = min(i1 * t1, n1 - t1) + H - kr
        o2 = min(i2 * t2, n2 - t2) + H - kr
        rings = [torch.zeros((S, rows[s], cols[s]), dtype=cur.dtype)
                 for s in range(k)]
        tags = [[None] * S for _ in range(k)]
        for j, step in enumerate(steps, -1):
            written = {(s, w) for s, _, w, _, _ in step if w is not None}

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
                centre = block[r, r:r + rows[s], r:r + cols[s]]
                p0, r1, r2 = a0 + m, o1 + s * r, o2 + s * r
                box = (p0, slice(r1, r1 + rows[s]), slice(r2, r2 + cols[s]))
                c, n, pv, sf = co[s - 1]
                v = eager.apply_spec(block, plan.spec, halo=r)[0] * n
                v = v + centre * c
                v = v + src[box] * sf
                if s >= 2:
                    v = v + read(s - 2, sb, m)[
                        2 * r:2 * r + rows[s], 2 * r:2 * r + cols[s]] * pv
                y = torch.arange(r1, r1 + rows[s])[:, None]
                x = torch.arange(r2, r2 + cols[s])[None, :]
                upd = (H <= p0 < H + n0) & (y >= H) & (y < H + n1) \
                    & (x >= H) & (x < H + n2)
                v = torch.where(upd, v, centre)
                if s < k:
                    rings[s][w] = v
                    tags[s][w] = (m, j)
                else:
                    assert bool(upd.all())  # the tile: interior
                    out[box] = v
                    second[box] = centre
    return (out, second) if plan.cheby_dual else out


def _coeffs(shape, k, dual, smoother):
    """The multigrid fine level's tuples at ``shape`` (h = 1/(n0+1)): k
    sweeps of the smoother, the last the residual in the dual mode."""
    h = 1.0 / (shape[0] + 1)
    nu = k - 1 if dual else k
    if smoother == "chebyshev":
        co = _cheby_sweep_coeffs(nu, 4.0, 3, h)
    else:
        w = 2.0 / 3.0
        co = ((1.0 - w, w / 6, 0.0, -(w / 6) * h * h),) * nu
    return co + (((6.0 / h ** 2, -1.0 / h ** 2, 0.0, 1.0),) if dual else ())


def _plan(shape, k, dual, smoother="chebyshev", dtype="float32", **kw):
    return make_tiled_plan(NB, shape, dtype, k, has_source=True,
                           cheby_coeffs=_coeffs(shape, k, dual, smoother),
                           cheby_dual=dual, **kw)


def _inputs(plan, rng):
    """A random padded u (its ghosts too: the walls are the ghosts) and the
    padded raw f of a random interior, in the plan's dtype."""
    tdt = torch.bfloat16 if plan.dtype == "bfloat16" else torch.float32
    cur = torch.from_numpy(rng.random(plan.layout.padded_shape)
                           .astype(np.float32)).to(tdt)
    f = rng.normal(size=plan.interior_shape)
    return cur, pad_source(plan, f, 1.0, DirichletBC(values=BC))


CASES = [  # shape, k, dual, smoother, tiles, dtype
    ((12, 10, 9), 1, False, "chebyshev", (4, 4, 4), "float32"),
    ((12, 10, 9), 2, False, "chebyshev", (5, 4, 8), "float32"),
    ((11, 10, 9), 2, True, "wjacobi", (4, 3, 5), "float32"),
    ((12, 10, 9), 3, True, "chebyshev", (5, 4, 4), "float32"),
    ((9, 8, 10), 4, False, "chebyshev", (4, 4, 4), "float32"),
    ((9, 10, 8), 5, True, "wjacobi", (3, 4, 5), "float32"),
    ((9, 8, 10), 8, True, "chebyshev", (4, 3, 5), "float32"),
    ((12, 10, 9), 2, False, "chebyshev", (5, 4, 8), "bfloat16"),
    ((12, 10, 9), 3, True, "chebyshev", (4, 4, 4), "bfloat16"),
    ((9, 10, 8), 5, True, "wjacobi", (3, 4, 5), "bfloat16"),
]


@pytest.mark.parametrize("shape,k,dual,smoother,tiles,dtype", CASES)
def test_emulation_is_the_plain_version(shape, k, dual, smoother, tiles,
                                        dtype):
    """The march's Chebyshev steps reproduce the plain version bitwise, on
    both outputs in the dual mode: ragged grids (clamped tiles and
    chunks), k = 1 .. 5 and 8, the Chebyshev and weighted-Jacobi tuples,
    fp32 and bf16."""
    plan = _plan(shape, k, dual, smoother, dtype, tiles=tiles,
                 schedule="march")
    assert plan.schedule == "march"
    cur, src = _inputs(plan, np.random.default_rng(k))
    got = emulate(plan, cur, src)
    want = sweep_reference(cur, plan, src)
    for g, w in zip(got if dual else (got,), want if dual else (want,)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dual,dtype", [(False, "float32"),
                                        (True, "float32"),
                                        (True, "bfloat16")])
def test_emulated_subsets_are_the_plain_version(dual, dtype):
    """A subset launch (the interior columns, then the edge columns into
    the same outputs) reproduces ``subset_reference`` bitwise at each
    launch, and the pair the full launch."""
    plan = _plan((12, 10, 9), 3, dual, dtype=dtype, tiles=(3, 3, 4),
                 schedule="march")
    cur, src = _inputs(plan, np.random.default_rng(3))
    inner, edge = partition_tiles(plan)
    assert inner and edge
    nxt = torch.zeros_like(cur)
    out2 = torch.zeros_like(cur) if dual else None
    for subset in (inner, edge):
        got = emulate(plan, cur, src, nxt, out2, subset)
        want = subset_reference(cur, nxt, plan, subset, src, out2=out2)
        for g, w in zip(got if dual else (got,), want if dual else (want,)):
            assert torch.equal(g, w)
        nxt, out2 = (got[0], got[1]) if dual else (got, None)
    full = sweep_reference(cur, plan, src)
    for g, w in zip((nxt, out2) if dual else (nxt,),
                    full if dual else (full,)):
        idx = plan.layout.interior_index
        assert torch.equal(g[idx], w[idx])


@pytest.mark.parametrize("r", [1, 2])
def test_slots_race_free_at_2r_plus_3_and_not_at_2r_plus_2(r):
    """For k = 1 .. 16: with the kernel's 2r+3 slots no step reads a ring
    slot that a level writes in that step, and every read finds its plane;
    with 2r+2 slots the u_{t-2} read (level s-2's plane, slot j-r-1) is
    the slot level s-2 writes in the same step, from k = 2 on."""
    for k in range(1, 17):
        t0 = 3 + k
        assert march_slots(r, True) == 2 * r + 3
        assert not races(t0, k, r, 2 * r + 3), k
        bad = races(t0, k, r, 2 * r + 2)
        assert bool(bad) == (k >= 2), k
        assert all(ring == s - 2 and q == (j + r + 1) % (2 * r + 2)
                   for j, s, ring, q in bad)


def test_plan_rule_and_ring_bytes():
    """A Chebyshev or dual plan marches from k=2 on (cfg13's two launches,
    cfg17's and cfg10's at 255^3, in fp32 and bf16) on rings of 2r+3
    planes, with the tiles of the deep rings' chooser at the homogeneous
    constants; a
    Chebyshev plan of one sweep takes the window; ``schedule=`` gives
    either at the same layout; the remainder plan (``with_sweeps``) keeps
    the march."""
    assert march_smem_bytes((64, 32, 32), 3, 1, 4, True) == 77_920
    assert march_smem_bytes((64, 32, 32), 5, 1, 4, True) == 145_200
    shape = (255, 255, 255)
    for dtype in ("float32", "bfloat16"):
        item = 2 if dtype == "bfloat16" else 4
        assert _plan(shape, 1, False, dtype=dtype).schedule == "window"
        for k, dual in ((1, False), (2, False), (3, True), (4, False),
                        (5, True)):
            plan = _plan(shape, k, dual, dtype=dtype)
            march = _plan(shape, k, dual, dtype=dtype, schedule="march")
            window = _plan(shape, k, dual, dtype=dtype, schedule="window")
            assert plan == (window if k == 1 else march)
            assert march.tiles == choose_march_tiles(
                NB, shape, k, dtype=dtype, deep=True,
                constants=MARCH_COST_CONSTANTS)
            assert march.smem_bytes == march_smem_bytes(
                march.tiles, k, 1, item, True) <= SMEM_LIMIT
            assert march_fits(march.tiles, k, 1, item, True)
            assert window.schedule == "window"
            assert window.layout == march.layout
            if k > 1:
                assert march.with_sweeps(k - 1).schedule == "march"
    with pytest.raises(ValueError, match="do not fit the march"):
        _plan(shape, 5, True, tiles=(64, 64, 64), schedule="march")


def _candidates(shape, k, dtype):
    """Every march candidate that fits the deep rings, clamped."""
    item = 2 if dtype == "bfloat16" else 4
    return {t for t in {tuple(min(c, n) for c, n in zip(cand, shape))
                        for cand in itertools.product(
                            MARCH_T0_CANDIDATES, _MARCH_T_CANDIDATES,
                            _MARCH_T_CANDIDATES)}
            if march_fits(t, k, 1, item, True)}


def test_chooser_and_rule_on_the_committed_rows():
    """On the Chebyshev tile sweep at 255^3 (H100,
    ``data/march_cheby_tiles_h100_fit.csv``: every candidate that fits,
    and the window's own tile) the chooser picks the fastest measured tile
    of every case, and the plan takes the schedule that measured faster
    at every depth: the window at k=1, the march from k=2 on. On the
    held-out cases, never fitted (cfg17's two launches, cfg10's, the FMG
    path's at 63^3, the bf16 dual launch), its picks are within 1.10x of
    the fastest tile (geometric mean) and the march beats the window."""
    rows = tile_sweep.read_cheby_rows(
        tile_sweep.DATA_DIR / "march_cheby_tiles_h100_fit.csv")
    assert set(rows) == set(tile_sweep.CHEBY_CASES)
    for case, rec in rows.items():
        _, shape, k, dtype, _ = case
        assert set(rec["march"]) == _candidates(shape, k, dtype)
        assert rec["window"][0] == tile_sweep.cheby_plan(
            case, schedule="window").tiles
    for r in tile_sweep.score_cheby(rows):
        assert r["ratio"] == 1.0, r
        assert r["schedule"] == ("march" if r["pick_ms"] < r["window"][1]
                                 else "window"), r
    held = tile_sweep.read_cheby_rows(
        tile_sweep.DATA_DIR / "march_cheby_tiles_h100_held_out.csv")
    assert set(held) == set(tile_sweep.CHEBY_HELD_OUT)
    results = tile_sweep.score_cheby(held)
    assert tile_sweep.geomean(results) <= 1.10
    for r in results:
        assert r["schedule"] == "march" and r["pick_ms"] < r["window"][1]


def test_cheby_fit_keeps_the_committed_constants():
    """The refit over the march fit grid (``tile_sweep.fit_cheby``) ranks
    first the committed constants: of those that pick the fastest tile of
    every case, the nearest to the homogeneous mode's, which are those
    constants themselves."""
    rows = tile_sweep.read_cheby_rows(
        tile_sweep.DATA_DIR / "march_cheby_tiles_h100_fit.csv")
    ranked = tile_sweep.fit_cheby(rows)
    assert ranked[0] == (1.0, MARCH_COST_CONSTANTS)
    assert march_constants(False) == MARCH_COST_CONSTANTS


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A march plan's launch on CPU tensors is the plain version, counted
    nowhere; the march's Chebyshev counts exist beside the others."""
    plan = _plan((12, 10, 9), 3, True, tiles=(4, 4, 4), schedule="march")
    cur, src = _inputs(plan, np.random.default_rng(0))
    tiled_sweep.reset_counts()
    got = tiled_sweep(cur, cur.clone(), plan, src, out2=cur.clone())
    want = sweep_reference(cur, plan, src)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tiled_sweep.launches == 0
    tiled_sweep.count_launch(plan, src, (1, 1, 1, 1), out2=cur)
    assert (tiled_sweep.march_dual_launches, tiled_sweep.dual_launches,
            tiled_sweep.march_launches, tiled_sweep.march_cheby_launches,
            tiled_sweep.march_dual_bf16_launches) == (1, 1, 1, 0, 0)
    tiled_sweep.reset_counts()
    with pytest.raises(ValueError, match="static Dirichlet"):
        tiled_sweep(cur, cur.clone(), plan, src, pins=(0, 0, 1, 1),
                    out2=cur.clone())


# ---- the slice against JAX on the CPU --------------------------------------

JAX_SHAPE = (9, 10, 8)


def _jax_grid(rng, shape, dtype="float32"):
    """A random interior in both packages' grids, the walls of BC."""
    x = rng.random(shape).astype(np.float32)
    jbc = jgrid.DirichletBC(values=BC)
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x).astype(dtype), halo=1,
                                      bc=jbc)
    tg = convert.grid_from_arrays(np.asarray(jg.data), 1, BC, device="cpu")
    return jbc, jg, tg


@pytest.mark.parametrize("k", [2, 3])
def test_march_dual_matches_jax_cheby_dual_fn(k):
    """``cheby_dual`` on a march plan (its launch through the plain
    version) against JAX's ``_cached_cheby_dual_fn`` in interpret mode:
    the smoothed iterate and the residual, fp32."""
    rng = np.random.default_rng(k)
    f = rng.normal(size=JAX_SHAPE).astype(np.float32)
    jbc, jg, tg = _jax_grid(rng, JAX_SHAPE)
    co = _coeffs(JAX_SHAPE, k, True, "chebyshev")
    jplan = jpt.make_tiled_plan(jnbsum_spec(3), JAX_SHAPE, "float32", k,
                                has_source=True, cheby_coeffs=co,
                                cheby_dual=True)
    ju, jr = jpt._cached_cheby_dual_fn(jplan, jbc, True)(
        jg.data, jpt.pad_source(jplan, f, 1.0, jbc))
    plan = _plan(JAX_SHAPE, k, True)
    assert plan.schedule == "march"
    u, r = cheby_dual(plan, tg.data, tg.bc, pad_source(plan, f, 1.0, tg.bc))
    h2 = (1.0 / (JAX_SHAPE[0] + 1)) ** 2
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=TOL, rtol=0)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=TOL / h2,
                               rtol=TOL)


@pytest.mark.parametrize("k,dtype,shape", [(2, "float32", JAX_SHAPE),
                                           (3, "float32", JAX_SHAPE),
                                           (2, "bfloat16", (12, 16, 16))])
def test_march_cheby_matches_jax_tiled_interpret(k, dtype, shape):
    """A march Chebyshev launch (``TiledStencil`` on a march plan, one
    launch, through the plain version) against JAX's Chebyshev tiled
    sweep in interpret mode; in bf16 at a shape JAX's bf16 tiles take."""
    from stencil_tpu.ops.pallas_tiled import TiledPallasStencil
    from stencil_tpu_torch.ops.tiled import TiledStencil

    rng = np.random.default_rng(10 + k)
    f = rng.normal(size=shape).astype(np.float32)
    _, jg, tg = _jax_grid(rng, shape, dtype)
    co = _coeffs(shape, k, False, "chebyshev")
    want = TiledPallasStencil(jnbsum_spec(3), shape, dtype,
                              sweeps_per_call=k, source=f, source_scale=1.0,
                              cheby_coeffs=co, interpret=True).iterate(jg, k)
    stencil = TiledStencil(NB, shape, dtype, sweeps_per_call=k,
                           device="cpu", source=f, cheby_coeffs=co)
    assert stencil.plan.schedule == "march"
    got = stencil.iterate(tg, k)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    np.testing.assert_allclose(
        got.data.float().numpy(), np.asarray(want.data).astype(np.float32),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("smoother", ["chebyshev", "wjacobi"])
def test_multigrid_on_a_marching_fine_level_matches_jax(smoother,
                                                         monkeypatch):
    """``Multigrid(fine_method="tiled")`` at 15^3, V(2,2): its fine level's
    Chebyshev and dual plans march, and two cycles (through the plain
    versions) match JAX's cycle."""
    from stencil_tpu import multigrid as jmg
    from stencil_tpu.models.poisson import PoissonProblem as JPoisson
    from stencil_tpu_torch import multigrid as tmg

    shape = (15, 15, 15)
    jp = JPoisson(shape=shape)
    tp = convert.poisson_from_arrays(jp.shape, jp.h, jp.bc.values,
                                     device="cpu")
    f = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    kw = dict(nu1=2, nu2=2, smoother=smoother)
    mg = tmg.Multigrid(tp, fine_method="tiled", **kw)
    pre, _, post, fused = mg._fine_ops()
    assert fused.plan.schedule == "march" and fused.plan.cheby_dual
    if smoother == "chebyshev":
        assert pre.plan.schedule == post.plan.schedule == "march"
    want = jmg.Multigrid(jp, **kw).runner(f).iterate(jp.initial_grid(), 2)
    run = mg.runner(f)
    assert run.plan_info["fine_schedules"]["fused"] == "march"
    got = run.iterate(tp.initial_grid(), 2)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=TOL)
    # every fine plan on the window (the plan maker asked for it), the
    # same cycle
    from stencil_tpu_torch.ops import tiled

    monkeypatch.setattr(tiled, "make_tiled_plan", functools.partial(
        tiled.make_tiled_plan, schedule="window"))
    window = tmg.Multigrid(tp, fine_method="tiled", **kw)
    assert all(op is None or op.plan.schedule == "window"
               for op in window._fine_ops())
    assert torch.equal(window.runner(f).iterate(tp.initial_grid(), 2).data,
                       got.data)
