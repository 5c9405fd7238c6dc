"""The tiled kernel's coefficient mode on the d0 march (csrc/tiled_march.cu)
with its weights formed once per run (csrc/coeff_weights.cu), on the CPU:
the weights' plain version (``coeff_weights_reference``) against the
weights the window's plain version formed before (bitwise), the symmetry
the march relies on, the plan rule, a pure-Python emulation of the march
kernel's coefficient update (its rings, schedule and every weight read)
against the plain version, and ``coeff_iterate``/``coeff_apply`` through
the weights against JAX's ``_cached_tiled_coeff_iterate`` and
``_cached_coeff_apply`` in interpret mode. The kernels themselves are held
against their plain versions on a card by tests/test_torch_cuda.py.

Tolerances: every plain-version comparison bitwise (``torch.equal``: the
same rounded fp32 ops in the same order); against JAX's kernel 5e-5 for
the iterate and 1e-5 of the largest value for the matvec, the bars of
tests/test_torch_varcoeff.py and test_torch_hetero.py (JAX forms the face
means in another order)."""

import numpy as np
import pytest
import torch

from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.core.spec import get_spec as jget_spec
from stencil_tpu.models import diffusion as jdiff
from stencil_tpu.ops import pallas_tiled as jpt
from stencil_tpu_torch import convert
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.multigrid import nbsum_spec
from stencil_tpu_torch.ops.sweep_kernel import (
    _harm, coeff_of, coeff_weights_reference, subset_reference,
    sweep_reference, update_boxes,
)
from stencil_tpu_torch.ops.tiled import (
    coeff_apply, coeff_iterate, coeff_operand, dynamic_pins, make_tiled_plan,
    pad_coeff, partition_tiles,
)
from stencil_tpu_torch.ops.tiled_kernel import coeff_weights, tiled_sweep
from test_torch_tiled_march import march_schedule

J7 = get_spec("jacobi7")
SHAPE = (20, 18, 22)
WALLS = {"dirichlet": ((), ()), "periodic 0 1": ((0, 1), ()),
         "neumann 1": ((), (1,))}


def _bc(periodic=(), neumann=()):
    bc = DirichletBC(values=((0.5, -1.0), (2.0, 0.25), (1.0, 1.5)))
    if periodic:
        bc = bc.with_periodic(periodic)
    if neumann:
        bc = bc.with_neumann(neumann)
    return bc


def _plan(shape, k, scales=(0.125, 1.0, -0.125), **kw):
    return make_tiled_plan(J7, shape, "float32", k, coeff_scales=scales,
                           **kw)


def _old_weights(coeff, plan, pins):
    """The weights the window's plain version formed before the weights
    kernel existed, over sweep 1's region: (centre, [(lo, hi) per dim])."""
    nb, c0, cs = coeff_of(plan)
    outer = update_boxes(plan, pins)[0]

    def shifted(d, s):
        return coeff[tuple(slice(b.start + (s if e == d else 0),
                                 b.stop + (s if e == d else 0))
                           for e, b in enumerate(outer))]

    a = coeff[outer]
    means = [(_harm(a, shifted(d, -1)), _harm(a, shifted(d, 1)))
             for d in range(3)]
    total = means[0][0] + means[0][1]
    for m in (means[1][0], means[1][1], means[2][0], means[2][1]):
        total.add_(m)
    return outer, total.mul_(cs).add_(c0), [(lo * nb, hi * nb)
                                            for lo, hi in means]


def _shift(t, box, d, s):
    return t[tuple(slice(b.start + (s if e == d else 0),
                         b.stop + (s if e == d else 0))
                   for e, b in enumerate(box))]


@pytest.mark.parametrize("walls", list(WALLS))
@pytest.mark.parametrize("k", [1, 3])
def test_weights_equal_the_window_plain_versions(walls, k):
    """``coeff_weights_reference`` gives, bitwise, the centre and the six
    face weights that the window's plain version formed itself, over every
    point a sweep updates; the hi face's as the neighbour's lo weight."""
    bc = _bc(*WALLS[walls])
    plan = _plan(SHAPE, k)
    a = np.random.default_rng(3).uniform(0.01, 1.0, size=SHAPE)
    coeff = pad_coeff(plan, a, bc)
    w = coeff_weights_reference(coeff, plan)
    assert w.shape == (4, *plan.layout.padded_shape) and \
        w.dtype == torch.float32
    outer, ctr, faces = _old_weights(coeff, plan, dynamic_pins(bc, 3))
    assert torch.equal(w[3][outer], ctr)
    for d, (lo, hi) in enumerate(faces):
        assert torch.equal(w[d][outer], lo)
        assert torch.equal(_shift(w[d], outer, d, 1), hi)
    # the CPU wrapper is the plain version, and no launch
    before = coeff_weights.launches
    assert torch.equal(coeff_weights(coeff, plan), w)
    assert torch.equal(coeff_operand(plan, coeff), w)
    assert coeff_weights.launches == before
    window = _plan(SHAPE, k, schedule="window")
    assert coeff_operand(window, coeff) is coeff


def test_hi_face_is_the_neighbours_lo_weight():
    """The symmetry the march relies on: ``W[d](p + e_d)`` is bitwise
    ``nb * harm(a(p), a(p + e_d))`` everywhere, on a field spanning 12
    decades with repeated values (2x is exact, so harm(x, y) and harm(y,
    x) round alike)."""
    shape = (9, 8, 10)
    plan = _plan(shape, 2, scales=(-1156.0, 0.0, 1156.0))
    rng = np.random.default_rng(4)
    a = 10.0 ** rng.uniform(-6, 6, size=shape)
    a[::3] = 0.3
    coeff = pad_coeff(plan, a, _bc())
    w = coeff_weights_reference(coeff, plan)
    nb = coeff_of(plan)[0]
    n = coeff.shape
    for d in range(3):
        lo = tuple(slice(0, n[e] - 1) if e == d else slice(None)
                   for e in range(3))
        hi = tuple(slice(1, None) if e == d else slice(None)
                   for e in range(3))
        assert torch.equal(w[d][hi], _harm(coeff[lo], coeff[hi]) * nb)
        assert torch.equal(w[d][hi], _harm(coeff[hi], coeff[lo]) * nb)


def test_plan_rule():
    """A coeff plan marches where its rings fit (cfg16's 256^3 k=8, the
    cfg18 matvec's 255^3 k=1), takes the window on request, and bf16 is
    refused with JAX's message."""
    for shape, k, scales in (((256,) * 3, 8, (1 / 6, 1.0, -1 / 6)),
                             ((255,) * 3, 1, (-65536.0, 0.0, 65536.0))):
        plan = _plan(shape, k, scales)
        assert plan.schedule == "march" and plan.has_coeff
        assert _plan(shape, k, scales, schedule="march") == plan
        assert _plan(shape, k, scales, schedule="window").schedule == \
            "window"
    with pytest.raises(ValueError) as want:
        jpt.make_tiled_plan(jget_spec("jacobi7"), (16, 16, 16), "bfloat16",
                            tap_mode="coeff", coeff_scales=(1.0, 1.0, -1.0))
    with pytest.raises(ValueError) as got:
        make_tiled_plan(J7, (16, 16, 16), "bfloat16",
                        coeff_scales=(1.0, 1.0, -1.0))
    assert str(got.value) == str(want.value)
    # a two-level plan marches too, and so does a Chebyshev plan asked
    # for the march (it reads no coefficient operand)
    assert make_tiled_plan(J7, (16, 16, 16), "float32", 2, two_level=True,
                           schedule="march").schedule == "march"
    cheby = make_tiled_plan(nbsum_spec(3), (16, 16, 16), "float32", 2,
                            has_source=True, schedule="march",
                            cheby_coeffs=((1.0, 0.1, 0.0, -0.1),) * 2)
    assert cheby.schedule == "march" and not cheby.has_coeff
    # the wrapper takes what the schedule reads
    plan = _plan((6, 7, 8), 2)
    x = torch.zeros(plan.layout.padded_shape)
    coeff = pad_coeff(plan, np.ones((6, 7, 8)), _bc())
    with pytest.raises(ValueError, match="weight fields"):
        tiled_sweep(x, x.clone(), plan, coeff=coeff)
    with pytest.raises(ValueError, match="padded layout"):
        tiled_sweep(x, x.clone(), _plan((6, 7, 8), 2, schedule="window"),
                    coeff=coeff_weights(coeff, plan))
    with pytest.raises(ValueError, match="coeff_scales plan"):
        coeff_weights(coeff, make_tiled_plan(J7, (6, 7, 8)))


def emulate_coeff(plan, cur, w, pins=(1, 1, 1, 1), subset=None, out=None):
    """One launch of the coefficient ``plan`` as the march kernel runs it:
    per block and step, each level's plane from the 3 planes of the level
    below in its ring (``march_schedule``), each updated point's seven
    weight reads at the kernel's padded indices and in its order. Asserts
    every weight read lies inside the padded grid, and every updated
    point at padded index 1 .. P-2 in each dim, where its weights come
    from neighbours inside the padded array (no edge clamp). Returns the
    output and the count of updated points."""
    k, H = plan.sweeps_per_call, plan.layout.halo
    P = plan.layout.padded_shape
    n0, n1, n2 = plan.interior_shape
    t0, t1, t2 = plan.tiles
    nt0, nt1, nt2 = plan.num_tiles
    out = (cur if out is None else out).clone()
    rows = [t1 + 2 * (k - s) for s in range(k + 1)]
    cols = [t2 + 2 * (k - s) for s in range(k + 1)]
    steps = march_schedule(plan)
    updated = 0

    def at(field, p0, y0, x0, ny, nx):
        assert 0 <= p0 < P[0] and 0 <= y0 and y0 + ny <= P[1] \
            and 0 <= x0 and x0 + nx <= P[2], (p0, y0, x0)
        return w[field, p0, y0:y0 + ny, x0:x0 + nx]

    for col in (range(nt0 * nt1) if subset is None else subset):
        i0, i1 = divmod(col, nt1)
        for i2 in range(nt2):
            a0 = min(i0 * t0, n0 - t0) + H - k
            o1 = min(i1 * t1, n1 - t1) + H - k
            o2 = min(i2 * t2, n2 - t2) + H - k
            rings = [torch.zeros((4, rows[s], cols[s])) for s in range(k)]
            for step in steps:
                for s, m, slot, reads in step:
                    if s == 0:
                        rings[0][slot] = cur[a0 + m, o1:o1 + rows[0],
                                             o2:o2 + cols[0]]
                        continue
                    lo, mid, hi = (rings[s - 1][q] for q in reads)
                    p0, r1, r2 = a0 + m, o1 + s, o2 + s
                    ny, nx = rows[s], cols[s]

                    def u(plane, dy, dx):
                        return plane[1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]

                    v = at(3, p0, r1, r2, ny, nx) * u(mid, 0, 0)
                    v = v + at(1, p0, r1, r2, ny, nx) * u(mid, -1, 0)
                    v = v + at(1, p0, r1 + 1, r2, ny, nx) * u(mid, 1, 0)
                    v = v + at(2, p0, r1, r2, ny, nx) * u(mid, 0, -1)
                    v = v + at(2, p0, r1, r2 + 1, ny, nx) * u(mid, 0, 1)
                    v = v + at(0, p0, r1, r2, ny, nx) * u(lo, 0, 0)
                    v = v + at(0, p0 + 1, r1, r2, ny, nx) * u(hi, 0, 0)
                    y = torch.arange(r1, r1 + ny)[:, None]
                    x = torch.arange(r2, r2 + nx)[None, :]
                    upd = ((not pins[0] or p0 >= H)
                           and (not pins[1] or p0 < H + n0)) \
                        & ((y >= H) | (not pins[2])) \
                        & ((y < H + n1) | (not pins[3])) \
                        & (x >= H) & (x < H + n2)
                    if bool(upd.any()):
                        assert 1 <= p0 <= P[0] - 2
                        ys = y.expand_as(upd)[upd]
                        xs = x.expand_as(upd)[upd]
                        assert int(ys.min()) >= 1 and \
                            int(ys.max()) <= P[1] - 2
                        assert int(xs.min()) >= 1 and \
                            int(xs.max()) <= P[2] - 2
                        updated += int(upd.sum())
                    v = torch.where(upd, v, u(mid, 0, 0))
                    if s < k:
                        rings[s][slot] = v
                    else:
                        assert bool(upd.all())
                        out[p0, r1:r1 + ny, r2:r2 + nx] = v
    return out, updated


@pytest.mark.parametrize("shape,k,tiles,walls", [
    ((10, 9, 11), 1, (4, 4, 8), "dirichlet"),
    ((10, 9, 11), 3, (4, 4, 8), "dirichlet"),
    ((12, 10, 9), 5, (8, 5, 4), "periodic 0 1"),
    ((9, 8, 10), 8, (4, 4, 4), "neumann 1"),
    ((11, 9, 10), 3, (5, 4, 4), "periodic 0 1"),
    ((9, 10, 11), 2, (3, 4, 8), "neumann 1"),
    ((8, 9, 10), 1, (8, 9, 10), "dirichlet")])
def test_emulated_march_coeff_is_the_plain_version(shape, k, tiles, walls):
    """The march's coefficient update, emulated through its rings with the
    kernel's weight indices, is bitwise the plain version on ragged grids
    at k = 1 .. 8 with every pins pattern of the walls; every weight read
    in bounds and clamp-free."""
    bc = _bc(*WALLS[walls])
    pins = dynamic_pins(bc, 3)
    plan = _plan(shape, k, tiles=tiles)
    assert plan.schedule == "march"
    rng = np.random.default_rng(5)
    coeff = pad_coeff(plan, rng.uniform(0.05, 2.0, size=shape), bc)
    w = coeff_weights_reference(coeff, plan)
    cur = torch.from_numpy(rng.standard_normal(plan.layout.padded_shape)
                           .astype(np.float32))
    got, updated = emulate_coeff(plan, cur, w, pins)
    assert updated > 0
    assert torch.equal(got, sweep_reference(cur, plan, coeff=w, pins=pins))


@pytest.mark.parametrize("pins", [(1, 0, 1, 0), (0, 0, 0, 0)])
def test_emulated_coeff_subsets_pair_is_the_full_launch(pins):
    """An interior then an edge subset launch of a march coeff plan
    (``partition_tiles``): each emulated launch bitwise
    ``subset_reference``, the pair the full launch."""
    shape = (12, 12, 10)
    plan = _plan(shape, 2, tiles=(4, 4, 5))
    interior, edge = partition_tiles(plan)
    assert interior and edge
    rng = np.random.default_rng(6)
    coeff = pad_coeff(plan, rng.uniform(0.05, 2.0, size=shape), _bc())
    w = coeff_weights_reference(coeff, plan)
    cur = torch.from_numpy(rng.standard_normal(plan.layout.padded_shape)
                           .astype(np.float32))
    base = cur.clone()
    base[plan.layout.interior_index] = -1.0
    part, _ = emulate_coeff(plan, cur, w, pins, interior, base)
    assert torch.equal(part, subset_reference(cur, base, plan, interior,
                                              coeff=w, pins=pins))
    both, _ = emulate_coeff(plan, cur, w, pins, edge, part)
    assert torch.equal(both, subset_reference(cur, part, plan, edge,
                                              coeff=w, pins=pins))
    assert torch.equal(both, sweep_reference(cur, plan, coeff=w, pins=pins))
    got = tiled_sweep(cur, part.clone(), plan, coeff=w, pins=pins,
                      subset=edge)
    assert torch.equal(got, both)


@pytest.mark.parametrize("walls", list(WALLS))
@pytest.mark.parametrize("k,iters", [(1, 2), (3, 4)])
def test_coeff_iterate_through_weights_matches_jax(walls, k, iters):
    """``coeff_iterate`` on a march plan with the weight fields (one
    launch of the weights, the plain versions here) against JAX's
    ``_cached_tiled_coeff_iterate`` in interpret mode, on each wall kind,
    k sweeps per launch and a remainder at k=3."""
    periodic, neumann = WALLS[walls]
    shape = SHAPE
    jbc = JBC.reference_default(3)
    if periodic:
        jbc = jbc.with_periodic(periodic)
    if neumann:
        jbc = jbc.with_neumann(neumann)
    a = jdiff.two_material(shape, lo=1.0 / 30.0, hi=1.0, seed=0)
    jd = jdiff.HeterogeneousDiffusion(shape=shape, a=a, bc=jbc)
    td = convert.diffusion_from_arrays(shape, a, jd.h, jd.dt, jbc.values,
                                       jbc.periodic, jbc.neumann,
                                       device="cpu")
    lam = jd.stable_dt / jd.h ** 2
    u0 = np.random.default_rng(21).normal(size=shape).astype(np.float32)
    jplan = jpt.make_tiled_plan(jget_spec("jacobi7"), shape, "float32", k,
                                tap_mode="coeff",
                                coeff_scales=(lam, 1.0, -lam))
    n_outer, rem = divmod(iters, k)
    want = jpt._cached_tiled_coeff_iterate(jplan, jbc, True, 1)(
        jd.initial_grid(u0).data, n_outer, jpt.pad_coeff(jplan, a, jbc))
    if rem:
        rplan = jpt.make_tiled_plan(jget_spec("jacobi7"), shape, "float32",
                                    rem, tap_mode="coeff",
                                    coeff_scales=(lam, 1.0, -lam))
        want = jpt._cached_tiled_coeff_iterate(rplan, jbc, True, 1)(
            want, 1, jpt.pad_coeff(rplan, a, jbc))
    plan = _plan(shape, k, scales=(lam, 1.0, -lam))
    assert plan.schedule == "march"
    w = coeff_operand(plan, pad_coeff(plan, a, td.bc))
    assert w.shape == (4, *plan.layout.padded_shape)
    got = coeff_iterate(plan, td.initial_grid(u0).data, td.bc, w, n_outer,
                        1, rem)
    inner = (slice(1, -1),) * 3
    np.testing.assert_allclose(got[inner].numpy(),
                               np.asarray(want)[inner], atol=5e-5, rtol=0)
    # the runner takes the same route: weights once, march launches
    run = td.runner(method="tiled", sweeps_per_call=k)
    assert run.plan_info["schedule"] == "march"
    assert torch.equal(run.iterate(td.initial_grid(u0), iters).data, got)


def test_coeff_apply_through_weights_matches_jax():
    """``coeff_apply`` (k=1, the Krylov matvec) on a march plan with the
    weight fields, on a halo-1 input whose ghost ring is random, against
    JAX's ``_cached_coeff_apply`` in interpret mode; the operator's data
    carry the weights, built once."""
    shape = SHAPE
    rng = np.random.default_rng(8)
    a = rng.uniform(0.05, 2.0, size=shape)
    jp = jdiff.HeterogeneousPoissonProblem(shape=shape, a=a,
                                           kernel="pallas", interpret=True)
    tp = convert.hetero_from_arrays(shape, a, jp.h, jp.bc.values,
                                    kernel="pallas", device="cpu")
    x = rng.normal(size=tuple(n + 2 for n in shape)).astype(np.float32)
    jplan = jp._pallas_plan()
    want = np.asarray(jpt._cached_coeff_apply(jplan, True)(
        x, jpt.pad_coeff(jplan, a, jp.bc)))
    plan = tp._kernel_plan()
    assert plan.schedule == "march" and plan.sweeps_per_call == 1
    data = tp.operator_data()
    assert data[1].shape == (4, *plan.layout.padded_shape)
    assert tp.operator_data() is data  # built once
    got = coeff_apply(plan, torch.from_numpy(x), data[1]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    assert np.array_equal(got, tp.operator_apply(torch.from_numpy(x),
                                                  data).numpy())
