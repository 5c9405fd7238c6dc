"""The d0 march schedule of the 3D tiled kernel (csrc/tiled_march.cu) on
the CPU: a pure-Python emulation of the kernel's schedule (per step, which
plane each sweep level computes, its ring slot and the slots it reads)
and of its arithmetic, plane by plane through the rings, against the
plain version (``sweep_reference``, ``subset_reference``) bitwise; the
chooser's fit and the schedule rule; and a ``-m tiled -c`` run through a
march plan against JAX's ``pallas_temporal`` (its Pallas kernel in
interpret mode).

The emulation follows the kernel's own index arithmetic: level s computes
plane m at step m + s(r+1) - 1 (the input plane m arrives in step m-1),
plane m of level s lives in ring slot (m + L_{s+1}) mod (2r+2), so at step
j every level reads slots j-r .. j+r and writes slot j+r+1; a point is
updated where it lies in the interior or beyond a live face, else copies
its centre. Each plane's taps are ``eager.apply_spec`` over the 2r+1
planes read from the ring, which is the kernel's per-point order.

Tolerances: emulation vs plain version bitwise (``torch.equal``); the
march ``-c`` run within 5e-6 of the float64 golden and of JAX's run in
fp32 (3e-2 in bf16, the suite's bf16 bar)."""

import json

import numpy as np
import pytest
import torch

from stencil_tpu import cli as jcli
from stencil_tpu import registry as jregistry
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu_torch import cli, registry, tile_sweep
from stencil_tpu_torch.config import parse_args
from stencil_tpu_torch.core.spec import StencilSpec, get_spec
from stencil_tpu_torch.multigrid import nbsum_spec
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.ops.sweep_kernel import (
    subset_reference, sweep_reference, tap_table,
)
from stencil_tpu_torch.ops import tiled_kernel
from stencil_tpu_torch.ops.tiled import (
    MARCH_THREADS, SCHEDULES, SMEM_LIMIT,
    choose_march_tiles, make_tiled_plan, march_fits, march_smem_bytes,
    partition_tiles,
)

TOL = 5e-6
BF16_TOL = 3e-2


def _lag(s: int, r: int) -> int:
    """Steps level s runs behind the input: L_s = s(r+1) - 1."""
    return s * (r + 1) - 1


def march_schedule(plan):
    """The kernel's schedule of one block: a list, per step j = -1 .. last,
    of (level, plane, write slot, read slots) tuples; level 0 is the input
    plane's fetch (its reads empty)."""
    k, r = plan.sweeps_per_call, plan.spec.radius
    S, planes = 2 * r + 2, plan.tiles[0] + 2 * k * r
    last = plan.tiles[0] + k * r - 1 + _lag(k, r)
    steps = [[(0, 0, r % S, ())]]
    for j in range(last + 1):
        c, w = j % S, (j + r + 1) % S
        step = [(0, j + 1, w, ())] if j + 1 < planes else []
        for s in range(1, k + 1):
            m = j - _lag(s, r)
            if s * r <= m < planes - s * r:
                step.append((s, m, w if s < k else None,
                             tuple((c + d) % S for d in range(-r, r + 1))))
        steps.append(step)
    return steps


def emulate(plan, cur, src=None, pins=(1, 1, 1, 1), subset=None, out=None):
    """One launch of ``plan`` as the march kernel runs it, block by block
    and step by step through per-level rings: returns ``out`` (a clone of
    ``cur`` by default) with the swept columns written, and the count of
    writes of each point of ``out``. Asserts every read hits a plane
    completed in an earlier step and stored where the schedule says, and
    that every fetch lies inside the padded array."""
    k, r = plan.sweeps_per_call, plan.spec.radius
    S, H = 2 * r + 2, plan.layout.halo
    n0, n1, n2 = plan.interior_shape
    t0, t1, t2 = plan.tiles
    nt0, nt1, nt2 = plan.num_tiles
    kr = k * r
    out = (cur if out is None else out).clone()
    writes = torch.zeros(cur.shape, dtype=torch.int32)
    rows = [t1 + 2 * (k - s) * r for s in range(k + 1)]
    cols = [t2 + 2 * (k - s) * r for s in range(k + 1)]
    steps = march_schedule(plan)
    for col in (range(nt0 * nt1) if subset is None else subset):
        i0, i1 = divmod(col, nt1)
        for i2 in range(nt2):
            a0 = min(i0 * t0, n0 - t0) + H - kr
            o1 = min(i1 * t1, n1 - t1) + H - kr
            o2 = min(i2 * t2, n2 - t2) + H - kr
            rings = [torch.zeros((S, rows[s], cols[s]), dtype=cur.dtype)
                     for s in range(k)]
            tags = [[None] * S for _ in range(k)]  # (plane, step written)
            for j, step in enumerate(steps, -1):
                for s, m, w, reads in step:
                    if s == 0:
                        box = (a0 + m, slice(o1, o1 + rows[0]),
                               slice(o2, o2 + cols[0]))
                        assert 0 <= a0 + m < cur.shape[0]
                        assert o1 >= 0 and o1 + rows[0] <= cur.shape[1]
                        assert o2 >= 0 and o2 + cols[0] <= cur.shape[2]
                        rings[0][w] = cur[box]
                        tags[0][w] = (m, j)
                        continue
                    for d, slot in zip(range(-r, r + 1), reads):
                        plane, done = tags[s - 1][slot]
                        assert plane == m + d and done < j, (s, m, d, j)
                    block = torch.stack([rings[s - 1][q] for q in reads])
                    v = eager.apply_spec(block, plan.spec, halo=r)[0]
                    p0, r1, r2 = a0 + m, o1 + s * r, o2 + s * r
                    box = (p0, slice(r1, r1 + rows[s]),
                           slice(r2, r2 + cols[s]))
                    if src is not None:
                        v.add_(src[box])
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
                        assert bool(upd.all())  # the tile: all interior
                        out[box] = v
                        writes[box] += 1
    return out, writes


def _padded(plan, rng, pins=(1, 1, 1, 1), dtype=torch.float32):
    """A random padded input; the live faces' ghosts random too (standing
    in for a refresh: the kernel and the plain version read them alike)."""
    x = torch.from_numpy(rng.standard_normal(plan.layout.padded_shape)
                         .astype(np.float32)).to(dtype)
    return x


CASES = [  # spec, interior, k, tiles, pins, source, dtype
    ("jacobi7", (10, 9, 11), 1, (4, 4, 8), (1, 1, 1, 1), False, "float32"),
    ("jacobi7", (10, 9, 11), 3, (4, 4, 8), (1, 1, 1, 1), True, "float32"),
    ("jacobi7", (12, 10, 9), 5, (8, 5, 4), (0, 0, 1, 1), False, "float32"),
    ("jacobi7", (9, 8, 10), 8, (4, 4, 4), (0, 1, 0, 1), False, "float32"),
    ("jacobi27", (9, 10, 11), 2, (3, 4, 8), (1, 0, 0, 1), True, "float32"),
    ("star3d_r2", (10, 9, 11), 2, (4, 4, 8), (1, 1, 1, 1), False,
     "float32"),
    ("star3d_r2", (11, 9, 10), 3, (5, 4, 4), (0, 0, 0, 0), True, "float32"),
    ("laplace3d_ho", (8, 9, 10), 2, (8, 9, 10), (1, 1, 0, 0), False,
     "float32"),
    ("jacobi7", (10, 9, 11), 4, (4, 4, 8), (0, 0, 0, 0), True, "bfloat16"),
    ("star3d_r2", (9, 10, 8), 2, (4, 8, 4), (1, 0, 1, 0), False,
     "bfloat16"),
]


@pytest.mark.parametrize("name,shape,k,tiles,pins,source,dtype", CASES)
def test_emulation_is_the_plain_version(name, shape, k, tiles, pins, source,
                                        dtype):
    """The march's rings, lags and slots reproduce the plain version
    bitwise on ragged grids (clamped tiles and chunks), at k = 1 .. 8,
    radius 1 and 2, pins and the source mode, fp32 and bf16; every read
    in bounds and of a completed plane; every interior point written, by
    one block or, in a clamped overlap, by two with the same value."""
    rng = np.random.default_rng(7)
    spec = get_spec(name)
    plan = make_tiled_plan(spec, shape, dtype, k, tiles=tiles,
                           has_source=source)
    assert plan.schedule == "march"
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cur = _padded(plan, rng, pins, tdt)
    src = _padded(plan, rng, pins, tdt) if source else None
    got, writes = emulate(plan, cur, src, pins)
    want = sweep_reference(cur, plan, src, pins=pins)
    assert torch.equal(got, want)
    idx = plan.layout.interior_index
    assert bool((writes[idx] >= 1).all())
    ghosts = torch.ones_like(writes, dtype=torch.bool)
    ghosts[idx] = False
    assert not bool(writes[ghosts].any())  # the ghosts of out: never
    exact = all(n % t == 0 for n, t in zip(shape, tiles))
    assert bool((writes[idx] == 1).all()) or not exact


@pytest.mark.parametrize("name,shape,k,tiles,pins,source", [
    ("jacobi7", (12, 12, 10), 2, (4, 4, 5), (1, 0, 1, 0), False),
    ("jacobi7", (12, 12, 10), 2, (4, 4, 5), (0, 0, 0, 0), True),
    ("star3d_r2", (16, 12, 9), 1, (4, 4, 9), (1, 0, 1, 0), False)])
def test_emulated_subsets_pair_is_the_full_launch(name, shape, k, tiles, pins,
                                                  source):
    """An interior then an edge subset launch (``partition_tiles``) into
    one output: each bitwise ``subset_reference``, the pair the full
    launch; each column written exactly once."""
    rng = np.random.default_rng(3)
    plan = make_tiled_plan(get_spec(name), shape, "float32", k, tiles=tiles,
                           has_source=source)
    assert plan.schedule == "march"
    cur = _padded(plan, rng, pins)
    src = _padded(plan, rng, pins) if source else None
    interior, edge = partition_tiles(plan)
    assert interior and edge
    base = torch.full_like(cur, -1.0)
    mid, w1 = emulate(plan, cur, src, pins, interior, base)
    assert torch.equal(mid, subset_reference(cur, base, plan, interior, src,
                                             pins=pins))
    got, w2 = emulate(plan, cur, src, pins, edge, mid)
    assert torch.equal(got, subset_reference(cur, mid, plan, edge, src,
                                             pins=pins))
    full = sweep_reference(cur, plan, src, pins=pins)
    idx = plan.layout.interior_index
    assert torch.equal(got[idx], full[idx])
    assert bool(((w1 + w2)[idx] == 1).all())


@pytest.mark.parametrize("r,k", [(1, 1), (1, 8), (2, 3), (2, 8), (3, 5)])
def test_schedule_reads_completed_planes_once_per_step(r, k):
    """Every level's read slots hold the planes m-r .. m+r, written in an
    earlier step and not overwritten since; a step's writes (one slot,
    j+r+1) never hit a slot read in that step; each level computes each
    plane of its range once."""
    plan = make_tiled_plan(get_spec("star3d_r2" if r == 2 else "jacobi7")
                           if r < 3 else _star(r), (16, 16, 16), "float32",
                           k, tiles=(6, 8, 8))
    S = 2 * r + 2
    held = {}  # (level, slot) -> (plane, step)
    seen = {}
    for j, step in enumerate(march_schedule(plan), -1):
        wslots = {w for _, _, w, _ in step if w is not None}
        assert len(wslots) <= 1
        for s, m, w, reads in step:
            seen.setdefault(s, []).append(m)
            for d, slot in zip(range(-r, r + 1), reads):
                assert slot not in wslots
                plane, done = held[(s - 1, slot)]
                assert plane == m + d and done < j
        for s, m, w, _ in step:
            if w is not None:
                held[(s, w)] = (m, j)
    planes = plan.tiles[0] + 2 * k * r
    for s in range(k + 1):
        assert seen[s] == list(range(s * r, planes - s * r))
    assert S == 2 * r + 2


def _star(r):
    from stencil_tpu_torch.core.spec import star
    return star(3, r)


def test_thread_start_division_is_exact():
    """The kernel's start row of thread t in a plane of w columns,
    trunc(fp32(t + 0.5) * fp32(1/w)), is t // w for every thread and
    every width a plan can give."""
    t = np.arange(MARCH_THREADS, dtype=np.float32) + np.float32(0.5)
    for w in range(1, 2048):
        inv = np.float32(1.0) / np.float32(w)
        got = np.trunc(t * inv).astype(np.int64)
        assert np.array_equal(got, np.arange(MARCH_THREADS) // w), w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chooser_fits_and_schedule_rule(dtype):
    """Every chosen march plan fits 232,448 bytes (and, in bf16, the
    kernel's 8192-point staged plane); plain, source, two-level and (fp32)
    coefficient plans march, and so do the Chebyshev and dual modes (but
    a Chebyshev plan of one sweep)."""
    for name, shape, k in [("jacobi7", (256, 256, 256), 8),
                           ("jacobi7", (256, 256, 256), 1),
                           ("jacobi7", (257, 257, 257), 8),
                           ("jacobi7", (256, 256, 1024), 8),
                           ("jacobi27", (57, 50, 46), 3),
                           ("star3d_r2", (64, 64, 64), 8),
                           ("laplace3d_ho", (384, 384, 384), 4),
                           ("jacobi7", (512, 512, 1024), 8),
                           ("jacobi7", (9, 7, 5), 16)]:
        spec = get_spec(name)
        item = 2 if dtype == "bfloat16" else 4
        for source in (False, True):
            plan = make_tiled_plan(spec, shape, dtype, k, has_source=source)
            assert plan.schedule == "march", (name, shape, k)
            assert plan.tiles == choose_march_tiles(spec, shape, k,
                                                    dtype=dtype)
            assert march_fits(plan.tiles, k, spec.radius, item)
            assert plan.smem_bytes == march_smem_bytes(
                plan.tiles, k, spec.radius, item) <= SMEM_LIMIT
    nb = nbsum_spec(3)
    co = ((1.0, 0.1, 0.0, -0.1), (0.9, 0.2, -0.1, -0.2))
    others = [
        make_tiled_plan(nb, (16, 16, 16), dtype, 2, has_source=True,
                        cheby_coeffs=co),
        make_tiled_plan(nb, (16, 16, 16), dtype, 2, has_source=True,
                        cheby_coeffs=co, cheby_dual=True)]
    if dtype == "float32":
        assert make_tiled_plan(get_spec("jacobi7"), (16, 16, 16), dtype, 2,
                               coeff_scales=(1, 1, -6)).schedule == "march"
    assert make_tiled_plan(get_spec("jacobi7"), (16, 16, 16), dtype, 2,
                           two_level=True).schedule == "march"
    # the Chebyshev and dual plans march too (from k=2 on); either
    # schedule on request
    for p in others:
        assert p.schedule == "march"
        for schedule in SCHEDULES:
            assert make_tiled_plan(
                nb, (16, 16, 16), dtype, 2, has_source=True,
                cheby_coeffs=co, cheby_dual=p.cheby_dual,
                schedule=schedule).schedule == schedule
    # a plain plan takes the window when asked; beyond 16 sweeps neither
    # kernel takes a launch
    assert make_tiled_plan(get_spec("jacobi7"), (40, 40, 40), dtype, 8,
                           schedule="window").schedule == "window"
    with pytest.raises(ValueError, match="fits"):
        make_tiled_plan(get_spec("jacobi7"), (40, 40, 40), dtype, 17)
    # the march's tiles are (chunk, t1, t2), the subset unit unchanged
    plan = make_tiled_plan(get_spec("jacobi7"), (64, 64, 64), dtype, 8,
                           t0_fixed=16)
    assert plan.schedule == "march" and plan.tiles[0] == 16
    interior, edge = partition_tiles(plan)
    assert sorted(interior + edge) == list(range(plan.num_tiles[0]
                                                 * plan.num_tiles[1]))


def test_march_chooser_scores_on_its_rows():
    """Every case of the committed march tile sweep (H100,
    ``data/march_tiles_h100_fit.csv``) has rows, every row's tiles fit,
    and the committed cost constants pick the fastest measured tile of
    each case, as ``choose_march_tiles`` does among all its candidates."""
    cases = tile_sweep.read_march_rows(
        tile_sweep.DATA_DIR / "march_tiles_h100_fit.csv")
    assert set(cases) == set(tile_sweep.MARCH_CASES)
    for (name, shape, k, dtype), measured in cases.items():
        item = 2 if dtype == "bfloat16" else 4
        assert all(march_fits(t, k, get_spec(name).radius, item)
                   and ms > 0 for t, ms in measured.items())
        assert choose_march_tiles(get_spec(name), shape, k,
                                  dtype=dtype) in measured
    results = tile_sweep.score_march(cases)
    assert all(r["ratio"] == 1.0 for r in results)
    assert sum(map(len, cases.values())) == 170


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_tiled_cli_on_a_march_plan_matches_jax_pallas_temporal(tmp_path,
                                                               dtype, tol):
    """``-m tiled -k 4 -c`` through a march plan passes the golden check
    and agrees with JAX's ``pallas_temporal`` (its kernel in interpret
    mode) on the same grid."""
    args = ["-s", "8", "16", "16", "-i", "4", "--spec", "jacobi7", "-k",
            "4", "--dtype", dtype]
    out = tmp_path / "out.jsonl"
    rc = cli.main([*args, "-m", "tiled", "-c", "--device", "cpu",
                   "--json-out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["plan"]["schedule"] == "march"
    assert rec["plan"]["chunk"] == rec["plan"]["tiles"][0]
    assert rec["check"]["ok"] and rec["check"]["max_abs_err"] < tol
    tcfg = parse_args([*args, "-m", "tiled", "--device", "cpu"])
    jcfg = jparse_args([*args, "-m", "pallas_temporal"])
    tspec, jspec = tcfg.resolved_spec(), jcfg.resolved_spec()
    tgrid, jgrid = cli.make_grid(tcfg, tspec), jcli.make_grid(jcfg, jspec)
    trun = registry.get_runner("tiled", tcfg, tspec, tgrid)
    assert trun.plan_info["schedule"] == "march"
    jrun = jregistry.get_runner("pallas_temporal", jcfg, jspec, jgrid)
    got = trun.iterate(tgrid, 4).interior().float().numpy()
    want = np.asarray(jrun.iterate(jgrid, 4).interior()).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# ---- the point-table kernel (tiled_march_kernel_tables) ---------------------

# jacobi7's taps in weight_groups order, the order the kernel compiles in
J7_TAPS = tuple(map(tuple, tap_table(get_spec("jacobi7"))[0].reshape(
    -1, 3).tolist()))

def _levels(plan):
    """(rows, cols) of each level s = 0 .. k's plane, and each level s < k's
    ring offset in a slot, in elements."""
    k = plan.sweeps_per_call
    _, t1, t2 = plan.tiles
    rows = [t1 + 2 * (k - s) for s in range(k + 1)]
    cols = [t2 + 2 * (k - s) for s in range(k + 1)]
    ring = np.cumsum([0] + [rows[s] * cols[s] for s in range(k)])
    return rows, cols, [int(v) for v in ring]


def _block_origin(plan, col, i2):
    """The padded origin (a0, o1, o2) of a block's input region, clamped as
    the kernels clamp it."""
    k, H = plan.sweeps_per_call, plan.layout.halo
    (n0, n1, n2), (t0, t1, t2) = plan.interior_shape, plan.tiles
    i0, i1 = divmod(col, plan.num_tiles[1])
    return (min(i0 * t0, n0 - t0) + H - k, min(i1 * t1, n1 - t1) + H - k,
            min(i2 * t2, n2 - t2) + H - k)


def table_passes(plan):
    """Passes of 512 threads the emulated instance holds at each level s
    = 0 .. k: one more than the level's plane needs, since an instance
    sized for the chooser's largest tile computes passes that hold no
    point of a smaller plane (which must then store nothing)."""
    rows, cols, _ = _levels(plan)
    n = [rows[0] * cols[0]] + [rows[s] * cols[s - 1] - 2
                               for s in range(1, len(rows))]
    return [-(-v // MARCH_THREADS) + 1 for v in n]


def point_tables_of(plan, col, i2, pins):
    """The point-table kernel's tables of one block, every thread at once
    (index [u, tid]), in its byte arithmetic, the rings starting at 0:
    ``load`` (the input plane's fetch offsets), ``home`` (per level s < k,
    the slot-0 address a point is stored at), ``put`` (level k's offsets
    in ``out``), ``keep`` and ``inner`` (per level s = 1 .. k, bool: the
    point lies in the plane; level s updates it in d1 and d2), ``point``
    (per level, the flattened point (y, x) = divmod(i, cols[s-1]) an entry
    holds, the index clamped), ``raw`` (per level, the index tid + 512u of
    each of its ``table_passes`` passes), ``lim`` (per pass of the input
    plane's fetch, its points less 512u) and ``end`` (per level, the last
    walked point's slot-0 address, where a thread past the end clamps its
    loads)."""
    k, H = plan.sweeps_per_call, plan.layout.halo
    n1, n2 = plan.interior_shape[1:]
    p2 = plan.layout.padded_shape[2]
    rows, cols, ring = _levels(plan)
    a0, o1, o2 = _block_origin(plan, col, i2)
    passes = table_passes(plan)
    raw = [np.arange(P)[:, None] * MARCH_THREADS + np.arange(MARCH_THREADS)
           for P in passes]
    n = [rows[0] * cols[0]] + [rows[s] * cols[s - 1] - 2
                               for s in range(1, k + 1)]
    lim = n[0] - MARCH_THREADS * np.arange(passes[0])
    y0, x0 = np.divmod(np.minimum(raw[0], n[0] - 1), cols[0])
    load = (y0 * p2 + x0) * 4
    home, keep, inner, point, end = {}, {}, {}, {}, {}
    for s in range(1, k + 1):
        ws, wp = cols[s], cols[s - 1]
        y, x = np.divmod(np.minimum(raw[s], n[s] - 1), wp)
        point[s] = (y, x)
        keep[s] = (raw[s] < n[s]) & (x < ws)
        end[s] = (n[s] - 1) * 4
        r1, r2 = o1 + s, o2 + s
        ylo = H - r1 if pins[2] else -2**31
        yhi = H + n1 - r1 if pins[3] else 2**31 - 1
        inner[s] = (y >= ylo) & (y < yhi) & (x >= H - r2) \
            & (x < H - r2 + n2)
        if s < k:
            home[s] = (ring[s] + y * ws + x) * 4
        else:
            put = (y * p2 + x) * 4
    return dict(load=load, home=home, put=put, keep=keep, inner=inner,
                point=point, raw=raw, lim=lim, end=end, origin=(a0, o1, o2))


def present_kernel_points(plan, s, col, i2, pins):
    """tiled_march_kernel's points of level s < k in one block, every
    thread's passes in order, as it walks them: the start row by the fp32
    reciprocal, then the carried (row, column); each with its update test
    in d1 and d2. Returns {flattened point: updated}."""
    k, H = plan.sweeps_per_call, plan.layout.halo
    n1, n2 = plan.interior_shape[1:]
    rows, cols, _ = _levels(plan)
    _, o1, o2 = _block_origin(plan, col, i2)
    ws, n = cols[s], rows[s] * cols[s]
    inv = np.float32(1.0) / np.float32(ws)
    r1, r2 = o1 + s, o2 + s
    ylo = H - r1 if pins[2] else -2**31
    yhi = H + n1 - r1 if pins[3] else 2**31 - 1
    out = {}
    for tid in range(MARCH_THREADS):
        y = int(np.trunc((np.float32(tid) + np.float32(0.5)) * inv))
        x = tid - y * ws
        for i in range(tid, n, MARCH_THREADS):
            assert i not in out
            out[i] = ylo <= y < yhi and H - r2 <= x < H - r2 + n2
            x += MARCH_THREADS % ws
            y += MARCH_THREADS // ws
            if x >= ws:
                x -= ws
                y += 1
    return out


def emulate_tables(plan, cur, pins=(1, 1, 1, 1), subset=None, out=None):
    """One launch of the point-table kernel, block by block and step by
    step: a flat float32 shared memory of 4 slots; each of level s's
    ``table_passes`` passes u reads the six taps (``J7_TAPS`` order,
    then the one multiply) at the thread's address min(4*(tid + 512u),
    end) plus the step's slot and the level's tap offset, takes the centre
    where a point is not updated and stores it where ``keep`` says.
    Returns ``out`` (a clone of ``cur`` by default) with the swept columns
    written and the count of writes of each point; asserts every shared access in the rings and every global
    one in the padded array."""
    k, S = plan.sweeps_per_call, 4
    P = table_passes(plan)
    H = plan.layout.halo
    n0 = plan.interior_shape[0]
    t0 = plan.tiles[0]
    pad = plan.layout.padded_shape
    pstride = pad[1] * pad[2]
    rows, cols, ring = _levels(plan)
    q = ring[-1]
    q4, pass4 = q * 4, MARCH_THREADS * 4
    weight = torch.tensor(tap_table(plan.spec)[4], dtype=torch.float32)
    flat_in = cur.reshape(-1)
    out = (cur if out is None else out).clone()
    flat_out = out.reshape(-1)
    writes = torch.zeros(out.numel(), dtype=torch.int32)
    tid = torch.arange(MARCH_THREADS)
    lo0 = H if pins[0] else -2**31
    hi0 = H + n0 if pins[1] else 2**31 - 1
    planes = t0 + 2 * k
    last = t0 + k - 1 + 2 * k - 1
    tcols = range(plan.num_tiles[0] * plan.num_tiles[1]) if subset is None \
        else subset
    for col in tcols:
        for i2 in range(plan.num_tiles[2]):
            tb = point_tables_of(plan, col, i2, pins)
            a0, o1, o2 = tb["origin"]
            gin = a0 * pstride + o1 * pad[2] + o2
            gout = a0 * pstride + (o1 + k) * pad[2] + o2 + k
            smem = torch.zeros(S * q, dtype=torch.float32)

            def lds(addr):
                addr = torch.as_tensor(addr)
                assert bool((addr >= 0).all() and (addr < S * q4).all())
                assert bool((addr % 4 == 0).all())
                return smem[addr // 4]

            def fetch(m, w):
                for u in range(P[0]):
                    ok = tid < int(tb["lim"][u])
                    g = gin + m * pstride + torch.as_tensor(
                        tb["load"][u]) // 4
                    assert bool((g[ok] >= 0).all()
                                and (g[ok] < flat_in.numel()).all())
                    dst = (w * q4 + tid * 4 + u * pass4) // 4
                    assert bool((dst[ok] < w * q + rows[0] * cols[0]).all())
                    smem[dst[ok]] = flat_in[g[ok]]

            fetch(0, 1)
            c = 0
            for j in range(last + 1):
                w = (c + 2) % S
                if j + 1 < planes:
                    fetch(j + 1, w)
                below, centre, above = ((c + 3) % S) * q4, c * q4, \
                    ((c + 1) % S) * q4
                for s in range(1, k + 1):
                    m = j - (2 * s - 1)
                    if m < s or m >= planes - s:
                        continue
                    wp = cols[s - 1]
                    ctr = (ring[s - 1] + wp + 1) * 4
                    slot = {-1: below, 0: centre, 1: above}
                    offs = [slot[d0] + ctr + (d1 * wp + d2) * 4
                            for d0, d1, d2 in J7_TAPS]
                    v, at = {}, {}
                    for u in range(P[s]):
                        at[u] = torch.clamp(tid * 4 + u * pass4,
                                            max=tb["end"][s])
                        acc = lds(at[u] + offs[0])
                        for o in offs[1:]:
                            acc = acc + lds(at[u] + o)
                        v[u] = acc * weight
                    if s < k:
                        live0 = lo0 <= a0 + m < hi0
                        for u in v:
                            due = torch.as_tensor(tb["inner"][s][u]) \
                                & live0
                            val = torch.where(due, v[u],
                                              lds(at[u] + centre + ctr))
                            ok = torch.as_tensor(tb["keep"][s][u])
                            dst = (torch.as_tensor(tb["home"][s][u])
                                   + w * q4) // 4
                            assert bool((dst[ok] >= w * q + ring[s]).all()
                                        and (dst[ok] < w * q + ring[s]
                                             + rows[s] * cols[s]).all())
                            smem[dst[ok]] = val[ok]
                    else:
                        for u in v:
                            ok = torch.as_tensor(tb["keep"][k][u])
                            g = gout + m * pstride + torch.as_tensor(
                                tb["put"][u]) // 4
                            flat_out[g[ok]] = v[u][ok]
                            writes[g[ok]] += 1
                c = (c + 1) % S
    return out, writes.reshape(out.shape)


TABLE_CASES = [  # shape, k, tiles, pins: the cells' depths and tile
    # ratios cut small (.long: k=8, a d0 chunk of half the grid; .step:
    # k=1, square d1/d2 tiles), ragged clamped tiles, live d0/d1 faces
    ((12, 10, 11), 8, (6, 4, 4), (1, 1, 1, 1)),
    ((10, 12, 12), 1, (5, 6, 6), (1, 1, 1, 1)),
    ((9, 10, 11), 3, (4, 4, 8), (0, 0, 1, 1)),
    ((12, 10, 9), 5, (8, 5, 4), (0, 1, 0, 1)),
    ((9, 8, 10), 2, (4, 3, 7), (1, 0, 0, 0)),
    ((40, 48, 50), 2, (8, 40, 48), (1, 1, 1, 1)),
]


@pytest.mark.parametrize("shape,k,tiles,pins", TABLE_CASES)
def test_point_tables_cover_each_point_once(shape, k, tiles, pins):
    """At every level of every block, the threads x passes that ``keep``
    admits hold each point of the level's plane exactly once (the columns
    walked past the plane's width, the entries past its end and a whole
    pass past it never); ``home`` and ``put`` place each kept point where
    tiled_march_kernel stores it; every tap a thread reads,
    clamped or not, lies inside level s-1's plane. The input plane's
    fetch covers its plane once."""
    plan = make_tiled_plan(get_spec("jacobi7"), shape, "float32", k,
                           tiles=tiles)
    assert plan.schedule == "march"
    rows, cols, ring = _levels(plan)
    p2 = plan.layout.padded_shape[2]
    tid = np.arange(MARCH_THREADS)
    for col in range(plan.num_tiles[0] * plan.num_tiles[1]):
        for i2 in range(plan.num_tiles[2]):
            tb = point_tables_of(plan, col, i2, pins)
            fetched = tb["raw"][0][tid[None, :] < tb["lim"][:, None]]
            assert sorted(fetched.tolist()) == list(
                range(rows[0] * cols[0]))
            for s in range(1, k + 1):
                y, x = tb["point"][s]
                kept = tb["keep"][s]
                flat = (y * cols[s] + x)[kept]
                assert sorted(flat.tolist()) == list(range(rows[s]
                                                           * cols[s]))
                if s < k:
                    assert np.array_equal(tb["home"][s][kept] // 4,
                                          ring[s] + flat)
                else:
                    assert np.array_equal(tb["put"][kept],
                                          ((y * p2 + x) * 4)[kept])
                wp = cols[s - 1]
                at = np.minimum(tb["raw"][s], tb["end"][s] // 4)
                for _, d1, d2 in J7_TAPS:
                    q = at + wp + 1 + d1 * wp + d2
                    assert q.min() >= 0 and q.max() < rows[s - 1] * wp


@pytest.mark.parametrize("shape,k,tiles,pins", TABLE_CASES[:5])
def test_interior_bits_are_the_present_kernels_test(shape, k, tiles, pins):
    """Each point's interior bit equals tiled_march_kernel's per-point
    test of d1 and d2, carried row and column and all, on ragged clamped
    tiles and with live d0/d1 faces."""
    plan = make_tiled_plan(get_spec("jacobi7"), shape, "float32", k,
                           tiles=tiles)
    for col in range(plan.num_tiles[0] * plan.num_tiles[1]):
        for i2 in range(plan.num_tiles[2]):
            tb = point_tables_of(plan, col, i2, pins)
            for s in range(1, k):
                want = present_kernel_points(plan, s, col, i2, pins)
                y, x = tb["point"][s]
                kept = tb["keep"][s]
                got = dict(zip((y * _levels(plan)[1][s] + x)[kept].tolist(),
                               tb["inner"][s][kept].tolist()))
                assert got == want


@pytest.mark.parametrize("shape,k,tiles,pins", TABLE_CASES)
def test_table_march_is_the_plain_version(shape, k, tiles, pins):
    """The launch stepped through the point tables equals the plain
    version bitwise at the cells' depths and tile ratios cut small, on
    ragged clamped tiles and live faces; every interior point written,
    the ghosts never; an interior then an edge subset launch each
    ``subset_reference``, the pair the full launch."""
    rng = np.random.default_rng(11)
    plan = make_tiled_plan(get_spec("jacobi7"), shape, "float32", k,
                           tiles=tiles)
    assert plan.schedule == "march"
    cur = _padded(plan, rng, pins)
    got, writes = emulate_tables(plan, cur, pins)
    assert torch.equal(got, sweep_reference(cur, plan, pins=pins))
    idx = plan.layout.interior_index
    assert bool((writes[idx] >= 1).all())
    ghosts = torch.ones_like(writes, dtype=torch.bool)
    ghosts[idx] = False
    assert not bool(writes[ghosts].any())
    interior, edge = partition_tiles(plan)
    if interior and edge:
        base = torch.full_like(cur, -1.0)
        mid, _ = emulate_tables(plan, cur, pins, interior, base)
        assert torch.equal(mid, subset_reference(cur, base, plan, interior,
                                                 pins=pins))
        both, _ = emulate_tables(plan, cur, pins, edge, mid)
        assert torch.equal(both, subset_reference(cur, mid, plan, edge,
                                                  pins=pins))
        assert torch.equal(both[idx], got[idx])


def _route_cases():
    j7, nb = get_spec("jacobi7"), nbsum_spec(3)
    co = ((1.0, 0.1, 0.0, -0.1), (0.9, 0.2, -0.1, -0.2))
    big = (512, 512, 512)
    src = object()
    return [  # label, plan, src, asks the library
        ("jacobi7 512^3 k=8 (.long)", make_tiled_plan(j7, big, "float32", 8),
         None, True),
        ("jacobi7 512^3 k=1 (.step)", make_tiled_plan(j7, big, "float32", 1),
         None, True),
        ("jacobi27 k=2", make_tiled_plan(get_spec("jacobi27"), (64,) * 3,
                                         "float32", 2), None, True),
        ("k=9", make_tiled_plan(j7, (64,) * 3, "float32", 9), None, True),
        ("source (Poisson)", make_tiled_plan(j7, big, "float32", 8,
                                             has_source=True), src, False),
        ("Chebyshev", make_tiled_plan(nb, (64,) * 3, "float32", 2,
                                      has_source=True, cheby_coeffs=co),
         src, False),
        ("dual", make_tiled_plan(nb, (64,) * 3, "float32", 2,
                                 has_source=True, cheby_coeffs=co,
                                 cheby_dual=True), src, False),
        ("two-level", make_tiled_plan(j7, (64,) * 3, "float32", 2,
                                      two_level=True), None, False),
        ("coefficient", make_tiled_plan(j7, (64,) * 3, "float32", 2,
                                        coeff_scales=(1, 1, -6)),
         None, False),
        ("bf16", make_tiled_plan(j7, big, "bfloat16", 8), None, False),
        ("window schedule", make_tiled_plan(j7, big, "float32", 8,
                                            schedule="window"), None, False),
    ]


@pytest.mark.parametrize("case", range(len(_route_cases())))
def test_point_table_routing(case, monkeypatch):
    """The predicate that sends a march launch to the point-table kernel
    decides the mode and leaves the plan to the march library: a
    homogeneous float32 march launch asks the library (once per plan,
    whatever its taps and depth), and runs the point-table kernel where
    the library says it fits; the source, Chebyshev, dual, two-level and
    coefficient modes, bf16 and the window schedule stay on their kernels
    without asking. The library's own answers are held on the card
    (``tests/test_torch_cuda.py::test_march_tables_routing``)."""
    label, plan, src, asks = _route_cases()[case]
    asked = []

    def fit(p):
        asked.append(p)
        return True

    monkeypatch.setattr(tiled_kernel, "_tables_fit", fit)
    assert tiled_kernel.point_tables(plan, src) == asks, label
    assert asked == ([plan] if asks else []), label
    asked.clear()
    monkeypatch.setattr(tiled_kernel, "_tables_fit", lambda p: False)
    assert not tiled_kernel.point_tables(plan, src), label


def test_point_table_launches_are_counted_apart():
    """A launch the wrapper sends to the point-table kernel counts in
    ``march_table_launches`` beside ``launches`` and the homogeneous
    mode's counts, and in no other mode's count; any other launch leaves
    it alone."""
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

    plan = make_tiled_plan(get_spec("jacobi7"), (64,) * 3, "float32", 4)
    for tables in (True, False):
        tiled_sweep.reset_counts()
        tiled_sweep.count_launch(plan, None, (1, 0, 1, 1), tables=tables)
        counts = {c: getattr(tiled_sweep, c)
                  for c in tiled_sweep.MODE_COUNTS if getattr(tiled_sweep, c)}
        want = {"march_launches": 1, "march_pins_launches": 1,
                "pins_launches": 1}
        if tables:
            want["march_table_launches"] = 1
        assert (tiled_sweep.launches, counts) == (1, want)
    tiled_sweep.reset_counts()
