"""The d0 march schedule of the 2D slab kernel (csrc/slab_march.cu) on the
CPU: a pure-Python emulation of the kernel's index arithmetic (per block
and step, the active levels, the ring slots, each level's row in the
input row's columns, the source ring, the bf16 rows' word copies and
their shift, the edge columns' garbage kept inside their rows) and of its
arithmetic, row by row through one flat shared-memory array, against the
plain version (``sweep_reference``)
bitwise; the plan's fit and schedule rule; the chooser on its committed
H100 rows; and ``-m pallas_temporal`` through a 2D march plan against
JAX's ``pallas_temporal`` (its Pallas slab kernel in interpret mode) and
the float64 golden.

The emulation follows the kernel: level s computes row m at step m +
s(r+1) - 1; input row m is issued kAhead = 3 steps before its first use
and complete at the end of step m-1; row m of level s lives in ring slot
(m + L_{s+1}) mod (2r+4), L_s = s(r+1) - 1. Every shared element carries
a tag (level, row, first step it may be read), so a read of a row not yet
complete, or of a slot overwritten since, fails. Each row's taps are
``eager.apply_spec`` over the 2r+1 rows read from the array at the
kernel's addresses, which is the kernel's per-point order.

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
from stencil_tpu_torch.core.spec import get_spec, star, weighted
from stencil_tpu_torch.ops import eager, slab
from stencil_tpu_torch.ops.slab import (
    SLAB_MARCH_AHEAD, SMEM_LIMIT, choose_slab_march_tiles,
    choose_tiles, make_slab_plan, slab_march_fits, slab_march_smem_bytes,
)
from stencil_tpu_torch.ops.sweep_kernel import sweep_reference

TOL = 5e-6
BF16_TOL = 3e-2
SLACK = slab.SLAB_MARCH_SLACK


def _lag(s: int, r: int) -> int:
    """Steps level s runs behind the input: L_s = s(r+1) - 1."""
    return s * (r + 1) - 1


def _spec(name):
    if name == "star2d_r1":
        return star(2, 1)
    if name == "upwind3":  # three taps: the kernel's table loop
        return weighted(2, [((0, 0), 0.5), ((-1, 0), 0.25), ((0, -1), 0.25)])
    return get_spec(name)


def ring_geometry(plan):
    """The kernel's per-launch constants (``march_entry``): slots S, input
    rows a block walks, threads (one per column of the input row, whole
    warps), the row pitch W (level s >= 1's row at s*W in a slot, in the
    input row's columns) and the slot size Q in elements."""
    k, r = plan.sweeps_per_call, plan.spec.radius
    _, t1 = plan.tiles
    p1 = plan.layout.padded_shape[1]
    nth = (t1 + 2 * k * r + 31) // 32 * 32
    pitch = nth + 4
    q = k * pitch
    if plan.itemsize == 2 and (q ^ p1) & 1:
        q += 1
    return (2 * r + 1 + SLAB_MARCH_AHEAD, plan.tiles[0] + 2 * k * r, nth,
            pitch, q)


def active_levels(plan, j, planes):
    """The levels a step computes, the kernel's s_lo .. s_hi."""
    k, r = plan.sweeps_per_call, plan.spec.radius
    return range(max(1, j + 2 - planes), min(k, (j + 1) // (2 * r + 1)) + 1)


def emulate(plan, cur, src=None, pins=(1, 1)):
    """One launch of ``plan`` as the march kernel runs it, block by block
    and step by step through one flat shared-memory array per block:
    returns a clone of ``cur`` with the tiles written, and the count of
    writes of each point. Asserts every read of the array hits the row the
    kernel means, complete before the step; every global read in bounds;
    in bf16 every word copy aligned on both sides and inside level 0's
    region; every thread's reads inside the array and its writes inside its
    level's row."""
    k, r = plan.sweeps_per_call, plan.spec.radius
    H = plan.layout.halo
    n0, n1 = plan.interior_shape
    t0, t1 = plan.tiles
    nt0, nt1 = plan.num_tiles
    p0, p1 = plan.layout.padded_shape
    total = p0 * p1
    kr = k * r
    bf16 = plan.itemsize == 2
    S, planes, nth, W, Q = ring_geometry(plan)
    w0 = t1 + 2 * kr
    assert nth >= w0  # a thread for every column of the input row
    flat_in = cur.reshape(-1)
    flat_src = None if src is None else src.reshape(-1)
    out = cur.clone()
    flat_out = out.view(-1)
    writes = torch.zeros(total, dtype=torch.int32)
    last = t0 + kr - 1 + _lag(k, r)
    lo0 = H if pins[0] else -(1 << 30)
    hi0 = H + n0 if pins[1] else 1 << 30
    cols = torch.arange(nth)  # every thread's column, level 0's coordinates
    for block in range(nt0 * nt1):
        i0, i1 = divmod(block, nt1)
        a0 = min(i0 * t0, n0 - t0) + H - kr
        o1 = min(i1 * t1, n1 - t1) + H - kr
        base0 = 1 + (((a0 & p1) ^ o1 ^ (r & Q) ^ 1) & 1) if bf16 else 0
        smem = torch.zeros(S * Q, dtype=cur.dtype)
        tags = [None] * (S * Q)  # (level, row, first step readable)
        # the source mode's ring: row m in slot m mod D, shifted in bf16
        D = k * (r + 1) + SLAB_MARCH_AHEAD
        stags = [None] * D  # (row, first step readable)

        def fetch(m):
            if m >= planes:
                return
            if src is not None:
                stags[m % D] = (m, m)
            w = (m + r) % S
            dst = w * Q + base0
            e0 = (a0 + m) * p1 + o1
            assert 0 <= a0 + m < p0 and o1 >= 0 and o1 + w0 <= p1
            if not bf16:
                for x in range(w0):
                    smem[dst + x] = flat_in[e0 + x]
                    tags[dst + x] = (0, m, m)
                return
            odd = e0 & 1
            first = e0 - odd
            for i in range(((w0 + odd + 1) >> 1)):
                pos = dst - odd + 2 * i
                assert pos % 2 == 0 and first % 2 == 0
                assert w * Q <= pos and pos + 1 < w * Q + W  # level 0's row
                for h in (0, 1):
                    if first + 2 * i + h < total:
                        smem[pos + h] = flat_in[first + 2 * i + h]
                        tags[pos + h] = (0, m, m)
                    else:
                        assert h == 1  # only the array's very last word

        for m in range(SLAB_MARCH_AHEAD):
            fetch(m)
        c = 0
        for j in range(last + 1):
            w = (c + r + 1) % S
            fetch(j + SLAB_MARCH_AHEAD)
            for s in active_levels(plan, j, planes):
                ws = t1 + 2 * (k - s) * r
                m = j - _lag(s, r)
                assert s * r <= m < planes - s * r
                row = a0 + m
                rin = c * Q + (base0 if s == 1 else (s - 1) * W)
                # every thread's taps read inside the array (the edge
                # columns' into its slack), the valid columns' the rows
                # of level s-1 that the kernel means, complete
                lo = rin + (0 - c) * Q - r
                hi = rin + (S - 1 - c) * Q + nth - 1 + r
                assert -SLACK <= lo and hi < S * Q + SLACK
                block_rows = []
                for d0 in range(-r, r + 1):
                    delta = ((c + d0) % S - c) * Q
                    idx = [rin + delta + s * r + x for x in range(-r, ws + r)]
                    for a in idx:
                        level, got_row, ready = tags[a]
                        assert (level, got_row) == (s - 1, m + d0), (
                            s, m, d0, j)
                        assert ready <= j, (s, m, d0, j)
                    block_rows.append(smem[idx])
                blk = torch.stack(block_rows)
                v = eager.apply_spec(blk, plan.spec, halo=r)[0]
                c1 = o1 + s * r
                gcols = slice(row * p1 + c1, row * p1 + c1 + ws)
                if flat_src is not None:
                    # the source row, from its ring: fetched with input
                    # row m, not overwritten until level k has read it
                    assert stags[(j - _lag(s, r)) % D] == (m, m) and m <= j
                    v.add_(flat_src[gcols])
                x = torch.arange(c1, c1 + ws)
                upd = (lo0 <= row < hi0) & (x >= H) & (x < H + n1)
                v = torch.where(upd, v, blk[r, r:r + ws])
                if s < k:
                    # every thread writes its column of level s's row: the
                    # valid ones, and the edge columns' garbage, all inside
                    # the row's pitch
                    dst = w * Q + s * W
                    assert dst + nth <= w * Q + (s + 1) * W <= (w + 1) * Q
                    for X in cols.tolist():
                        tags[dst + X] = ("edge column",)
                    smem[dst + s * r:dst + s * r + ws] = v
                    for a in range(dst + s * r, dst + s * r + ws):
                        tags[a] = (s, m, j + 1)
                else:
                    assert bool(upd.all())  # the tile: all interior
                    flat_out[gcols] = v
                    writes[gcols] += 1
            c = (c + 1) % S
    return out, writes.view(cur.shape)


def _padded(plan, rng, dtype):
    """A random padded input, ghosts random too (standing in for a
    refresh: the kernel and the plain version read them alike)."""
    return torch.from_numpy(rng.standard_normal(plan.layout.padded_shape)
                            .astype(np.float32)).to(dtype)


CASES = [  # spec, interior, k, tiles, pins, source, dtype
    ("jacobi5", (20, 23), 1, (8, 16), (1, 1), False, "float32"),
    ("jacobi5", (20, 23), 3, (8, 16), (1, 1), True, "float32"),
    ("jacobi5", (40, 36), 16, (16, 16), (0, 0), False, "float32"),
    ("jacobi9", (19, 30), 3, (8, 16), (0, 1), False, "float32"),
    ("star2d_r2", (21, 25), 3, (8, 16), (1, 0), True, "float32"),
    ("laplace2d_ho", (17, 22), 2, (17, 8), (0, 0), False, "float32"),
    ("upwind3", (15, 18), 3, (4, 16), (1, 1), True, "float32"),
    ("jacobi5", (20, 23), 3, (8, 16), (0, 0), True, "bfloat16"),
    ("jacobi5", (21, 24), 16, (16, 16), (1, 1), False, "bfloat16"),
    ("star2d_r2", (21, 25), 3, (8, 16), (0, 1), False, "bfloat16"),
    ("jacobi9", (19, 22), 2, (8, 8), (1, 0), True, "bfloat16"),
]


@pytest.mark.parametrize("name,shape,k,tiles,pins,source,dtype", CASES)
def test_emulation_is_the_plain_version(name, shape, k, tiles, pins, source,
                                        dtype):
    """The march's rings, lags, slots, level rows, source ring and bf16
    word copies reproduce the plain version bitwise on ragged
    grids (clamped strips and chunks; odd and even row strides, an
    odd-sized bf16 array), at k = 1, 2, 3 and 16, radius 1 and 2, one and
    two weight groups and the table loop, pins [1,1], [0,0], [0,1], [1,0]
    and the source mode, fp32 and bf16; every interior point written, by
    one block or, in a clamped overlap, by two with the same value; no
    ghost of the output written."""
    rng = np.random.default_rng(7)
    spec = _spec(name)
    plan = make_slab_plan(spec, shape, dtype, k, tiles=tiles,
                          schedule="march")
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cur = _padded(plan, rng, tdt)
    src = _padded(plan, rng, tdt) if source else None
    got, writes = emulate(plan, cur, src, pins)
    want = sweep_reference(cur, plan, src, pins=pins)
    assert torch.equal(got, want)
    idx = plan.layout.interior_index
    assert bool((writes[idx] >= 1).all())
    ghosts = torch.ones_like(writes, dtype=torch.bool)
    ghosts[idx] = False
    assert not bool(writes[ghosts].any())
    exact = all(n % t == 0 for n, t in zip(shape, tiles))
    assert bool((writes[idx] == 1).all()) or not exact


def test_odd_sized_bf16_array_copies_its_last_word_alone():
    """An odd number of padded elements in bf16: the last row of the last
    strip ends on the array's last element, whose word would reach past
    the array; the emulation copies it alone and still equals the plain
    version."""
    plan = make_slab_plan(get_spec("jacobi5"), (7, 9), "bfloat16", 2,
                          tiles=(4, 4), schedule="march")
    assert all(p % 2 for p in plan.layout.padded_shape)
    rng = np.random.default_rng(3)
    cur = _padded(plan, rng, torch.bfloat16)
    got, _ = emulate(plan, cur, pins=(0, 0))
    assert torch.equal(got, sweep_reference(cur, plan, pins=(0, 0)))


@pytest.mark.parametrize("r,k", [(1, 1), (1, 16), (2, 3), (2, 8), (3, 5)])
def test_schedule_reads_completed_rows_once_per_step(r, k):
    """Per step, every level reads the rows m-r .. m+r of the level below,
    written in an earlier step (input rows complete kAhead-1 steps after
    their issue) and not overwritten since; one slot index written per
    step (j+r+1) by the levels, one (j+r+kAhead) by the fetch, neither
    read in that step; each level computes each row of its range once."""
    spec = {1: get_spec("jacobi5"), 2: get_spec("star2d_r2")}.get(r) \
        or star(2, r)
    plan = make_slab_plan(spec, (24, 24), "float32", k, tiles=(6, 8),
                          schedule="march")
    S, planes, _, _, _ = ring_geometry(plan)
    held = {}  # (level, slot) -> (row, first step readable)
    for m in range(SLAB_MARCH_AHEAD):
        held[(0, (m + r) % S)] = (m, m)
    seen = {s: [] for s in range(1, k + 1)}
    last = plan.tiles[0] + k * r - 1 + _lag(k, r)
    for j in range(last + 1):
        c = j % S
        reads = {(c + d) % S for d in range(-r, r + 1)}
        written = {(c + r + 1) % S}
        m_in = j + SLAB_MARCH_AHEAD
        if m_in < planes:
            written.add((m_in + r) % S)
            assert (m_in + r) % S not in reads
        assert not written & reads
        for s in active_levels(plan, j, planes):
            m = j - _lag(s, r)
            seen[s].append(m)
            for d in range(-r, r + 1):
                row, ready = held[(s - 1, (c + d) % S)]
                assert row == m + d and ready <= j
        for s in active_levels(plan, j, planes):
            if s < k:
                held[(s, (c + r + 1) % S)] = (j - _lag(s, r), j + 1)
        if m_in < planes:
            held[(0, (m_in + r) % S)] = (m_in, m_in)
    for s in range(1, k + 1):
        assert seen[s] == list(range(s * r, planes - s * r))
    assert S % 2 == 0  # the bf16 shift is one per block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fits_and_schedule_rule(dtype):
    """Every march plan the rule gives fits 232,448 bytes, its shared
    memory the kernel's (slots x Q); the rule takes the march exactly
    where the fitted estimate ranks it below the chosen window; -b pins
    the march's chunk; a pinned ``tiles`` is a window tile unless the
    march is asked for; both schedules can be asked for."""
    item = 2 if dtype == "bfloat16" else 4
    for name, shape, k, t0 in [("jacobi5", (512, 512), 16, None),
                               ("jacobi5", (512, 512), 1, None),
                               ("jacobi5", (512, 512), 4, None),
                               ("jacobi9", (4096, 4096), 4, 256),
                               ("jacobi9", (4096, 4096), 4, None),
                               ("star2d_r1", (4096, 4096), 8, None),
                               ("star2d_r1", (63, 63), 8, None),
                               ("star2d_r2", (250, 333), 3, None),
                               ("jacobi5", (7, 300), 16, None),
                               ("laplace2d_ho", (2048, 2048), 2, None)]:
        spec = _spec(name)
        plan = make_slab_plan(spec, shape, dtype, k, t0_fixed=t0)
        march = choose_slab_march_tiles(spec, shape, k, t0, dtype)
        window = choose_tiles(spec, shape, k, t0, dtype)
        wins = slab.march_wins(march, window, k, spec, shape, item)
        assert plan.schedule == ("march" if wins else "window"), name
        if dtype == "bfloat16" and window is not None:
            assert plan.schedule == "window", name
        assert plan.tiles == (march if wins else window)
        m = make_slab_plan(spec, shape, dtype, k, t0_fixed=t0,
                           schedule="march")
        assert m.tiles == march
        assert slab_march_fits(m.tiles, k, spec.radius, item, shape[1])
        S, _, _, _, Q = ring_geometry(m)
        assert m.smem_bytes == (S * Q + 2 * SLACK) * item == \
            slab_march_smem_bytes(
            m.tiles, k, spec.radius, item, shape[1]) <= SMEM_LIMIT
        if t0 is not None:
            assert m.tiles[0] == min(t0, shape[0])
        w = make_slab_plan(spec, shape, dtype, k, t0_fixed=t0,
                           schedule="window")
        assert w.schedule == "window" and w.tiles == window
    sp = get_spec("jacobi5")
    assert make_slab_plan(sp, (64, 64), dtype, 4,
                          tiles=(16, 32)).schedule == "window"
    assert make_slab_plan(sp, (64, 64), dtype, 4, tiles=(16, 32),
                          schedule="march").tiles == (16, 32)
    # rings the window cannot hold: (256, 256) at k=8 needs 592 KB of
    # windows, 51 KB of rings
    assert make_slab_plan(sp, (512, 512), dtype, 8, tiles=(256, 256),
                          schedule="march").schedule == "march"
    with pytest.raises(ValueError, match="march kernel"):
        make_slab_plan(sp, (512, 512), dtype, 64, tiles=(64, 512),
                       schedule="march")
    with pytest.raises(ValueError, match="schedule"):
        make_slab_plan(sp, (64, 64), dtype, 4, schedule="ring")
    # the remainder launch keeps the schedule, tiles and layout
    plan = make_slab_plan(sp, (64, 64), dtype, 8, schedule="march")
    rem = plan.with_sweeps(3)
    assert rem.schedule == "march" and rem.layout == plan.layout
    assert rem.smem_bytes <= plan.smem_bytes


def test_slab_march_chooser_scores_on_its_rows():
    """Every case of the committed 2D march tile sweep (H100,
    ``data/slab_march_tiles_h100_fit.csv``) has its march rows and the
    window's; the chooser's pick among all its candidates is a measured
    tile; the committed constants pick the fastest measured march tile of
    each case, or within the gap PERF.md states, and the schedule rule
    takes the measured faster schedule wherever the two differ by more
    than RULE_MARGIN."""
    cases = tile_sweep.read_slab_march_rows(
        tile_sweep.DATA_DIR / "slab_march_tiles_h100_fit.csv")
    assert set(cases) == set(tile_sweep.SLAB_MARCH_CASES)
    for (name, shape, k, dtype, _, t0), measured in cases.items():
        item = 2 if dtype == "bfloat16" else 4
        spec = _spec(name)
        marches = {t for s, t in measured if s == "march"}
        assert set(slab.march_candidates(spec, shape, k, t0, item)) \
            == marches
        assert choose_slab_march_tiles(spec, shape, k, t0, dtype) in marches
        assert ("window", choose_tiles(spec, shape, k, t0, dtype)) \
            in measured
    results = tile_sweep.score_slab_march(cases)
    clear = [r for r in results
             if max(r["pick_ms"], r["window_ms"])
             > RULE_MARGIN * min(r["pick_ms"], r["window_ms"])]
    assert len(clear) >= len(results) - 1
    assert all(r["rule"] == r["faster"] for r in clear)
    assert max(r["ratio"] for r in results) <= MAX_PICK_GAP


def test_slab_march_rule_on_held_out_rows():
    """The committed constants on the held-out 2D march sweep (H100,
    ``data/slab_march_tiles_h100_held_out.csv``: cases the fit never
    saw): every case has its march rows and the window's; the schedule
    rule takes the measured faster schedule wherever the two differ by
    more than RULE_MARGIN; the chooser's pick is within the held-out gap
    PERF.md states of the fastest measured march tile."""
    cases = tile_sweep.read_slab_march_rows(
        tile_sweep.DATA_DIR / "slab_march_tiles_h100_held_out.csv")
    assert set(cases) == set(tile_sweep.SLAB_MARCH_HELD_OUT)
    assert not set(cases) & set(tile_sweep.SLAB_MARCH_CASES)
    for (name, shape, k, dtype, _, t0), measured in cases.items():
        item = 2 if dtype == "bfloat16" else 4
        spec = _spec(name)
        assert set(slab.march_candidates(spec, shape, k, t0, item)) \
            == {t for s, t in measured if s == "march"}
        assert ("window", choose_tiles(spec, shape, k, t0, dtype)) \
            in measured
    results = tile_sweep.score_slab_march(cases)
    clear = [r for r in results
             if max(r["pick_ms"], r["window_ms"])
             > RULE_MARGIN * min(r["pick_ms"], r["window_ms"])]
    assert len(clear) >= 3
    assert all(r["rule"] == r["faster"] for r in clear)
    assert max(r["ratio"] for r in results) <= MAX_HELD_OUT_PICK_GAP


# the chooser's worst pick on its committed rows, over the fastest march
# tile of the case, the same on the held-out rows (the 63^2 source mode),
# and the schedules' difference below which the rule's choice is not held
# to the measured one (PERF.md, Findings, the 2D march)
MAX_PICK_GAP = 1.21
MAX_HELD_OUT_PICK_GAP = 1.51
RULE_MARGIN = 1.1


def test_tile_sweep_cli_scores_the_committed_rows(capsys):
    """``tile_sweep.py --dims 2 --march --score`` reads the committed
    rows and prints each case and the rule's count."""
    rc = tile_sweep.main(["--dims", "2", "--march", "--score",
                          str(tile_sweep.DATA_DIR
                              / "slab_march_tiles_h100_fit.csv")])
    out = capsys.readouterr().out
    assert rc == 0
    n = len(tile_sweep.SLAB_MARCH_CASES)
    assert out.count("2D march (") == n
    assert f"faster schedule in {n - 1} of {n} cases" in out


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", BF16_TOL)])
def test_pallas_temporal_on_a_march_plan_matches_jax(tmp_path, dtype, tol):
    """``-m pallas_temporal -k 4 -c`` on a 2D grid through a march plan
    (``-b 16`` pins the chunk) passes the golden check and agrees with
    JAX's ``pallas_temporal`` (its slab kernel in interpret mode) on the
    same grid; ``plan_info`` names the schedule and the chunk."""
    args = ["-s", "16", "32", "-i", "4", "--spec", "jacobi5", "-k", "4",
            "-b", "16", "--dtype", dtype]
    out = tmp_path / "out.jsonl"
    rc = cli.main([*args, "-m", "pallas_temporal", "-c", "--device", "cpu",
                   "--json-out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["plan"]["kernel"] == "slab"
    assert rec["check"]["ok"] and rec["check"]["max_abs_err"] < tol
    tcfg = parse_args([*args, "-m", "pallas_temporal", "--device", "cpu"])
    jcfg = jparse_args([*args, "-m", "pallas_temporal"])
    tspec, jspec = tcfg.resolved_spec(), jcfg.resolved_spec()
    tgrid, jgrid = cli.make_grid(tcfg, tspec), jcli.make_grid(jcfg, jspec)
    trun = registry.get_runner("pallas_temporal", tcfg, tspec, tgrid)
    if trun.plan_info["schedule"] != "march":
        # the rule keeps the window at this size: run the march plan
        from stencil_tpu_torch.ops.slab import SlabStencil

        m = SlabStencil(tspec, (16, 32), dtype, 4, t0_fixed=16, device="cpu",
                        schedule="march")
        assert m.plan.schedule == "march" and m.plan.tiles[0] == 16
        iterate = m.iterate
    else:
        assert rec["plan"]["schedule"] == "march"
        assert rec["plan"]["chunk"] == rec["plan"]["tiles"][0] == 16
        iterate = trun.iterate
    assert rec["plan"]["schedule"] == trun.plan_info["schedule"]
    jrun = jregistry.get_runner("pallas_temporal", jcfg, jspec, jgrid)
    got = iterate(tgrid, 4).interior().float().numpy()
    want = np.asarray(jrun.iterate(jgrid, 4).interior()).astype(np.float32)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
