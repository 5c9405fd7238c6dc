"""The tiled iterate (stencil_tpu_torch/ops/tiled.py) and the plain version
of its CUDA kernel (ops/tiled_kernel.py) against the JAX package's tiled
Pallas kernel in interpret mode, as tests/test_pallas_tiled.py runs it;
plus the plan's geometry and the wrapper's refusals. The kernel itself is
tested on a card by tests/test_torch_cuda.py.

Tolerances: port vs JAX allclose at atol = rtol = 1e-6 (fp32; the TPU
kernel may evaluate box stencils separably, in another order); port vs the
float64 golden at 5e-6, the reference suite's bar."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.ops import xla
from stencil_tpu.ops.pallas_tiled import TiledPallasStencil
from stencil_tpu_torch import convert
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.tiled import (
    SMEM_LIMIT, TiledStencil, make_tiled_plan, march_smem_bytes,
)
from stencil_tpu_torch.ops.tiled_kernel import (
    sweep_reference, tap_table, tiled_sweep,
)

TOL = 1e-6


def _both(rng, jspec_, shape):
    """The same random grid (reference walls) in both packages."""
    t = convert.spec_from_arrays(jspec_.name, jspec_.offsets,
                                 jspec_.weights, jspec_.radius)
    x = rng.random(shape).astype(np.float32)
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=jspec_.radius)
    tg = convert.grid_from_arrays(np.asarray(jg.data), jg.halo,
                                  jg.bc.values, device="cpu")
    return t, jg, tg


@pytest.mark.parametrize("name,k", [
    ("jacobi7", 1), ("jacobi7", 2), ("jacobi27", 2), ("star3d_r2", 2)])
def test_iterate_matches_jax_tiled_interpret(rng, name, k):
    shape = (16, 16, 20)
    j = jspec.get_spec(name)
    t, jg, tg = _both(rng, j, shape)
    want = TiledPallasStencil(j, shape, sweeps_per_call=k, tiles=(8, 8),
                              interpret=True).iterate(jg, 2 * k)
    got = TiledStencil(t, shape, sweeps_per_call=k, device="cpu") \
        .iterate(tg, 2 * k)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


def test_plain_version_matches_jax_tiled_interpret(rng):
    """One launch's plain version on the deep-halo layout equals one
    k-sweep call of the TPU kernel."""
    shape, k = (16, 16, 20), 2
    j = jspec.get_spec("jacobi7")
    t, jg, tg = _both(rng, j, shape)
    want = TiledPallasStencil(j, shape, sweeps_per_call=k, tiles=(8, 8),
                              interpret=True).iterate(jg, k)
    plan = make_tiled_plan(t, shape, "float32", k, tiles=(8, 8, 16))
    out = sweep_reference(plan.layout.pad_grid(tg), plan)
    np.testing.assert_allclose(plan.layout.unpad(out).numpy(),
                               np.asarray(want.interior()),
                               atol=TOL, rtol=TOL)


def test_remainder_iterations_match_xla(rng):
    """k=3 over 7 iterations: two launches of 3 and one of 1 sweep."""
    shape = (12, 24, 20)
    j = jspec.get_spec("jacobi7")
    t, jg, tg = _both(rng, j, shape)
    want = xla.iterate(jg, j, 7)
    got = TiledStencil(t, shape, sweeps_per_call=3, tiles=(4, 8, 16),
                       device="cpu").iterate(tg, 7)
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["jacobi7", "jacobi27", "laplace3d_ho"])
def test_iterate_matches_golden(rng, name):
    sp = tspec.get_spec(name)
    shape = (13, 11, 9)
    x = rng.random(shape).astype(np.float32)
    g = tgrid.HaloGrid.from_interior(torch.from_numpy(x), halo=sp.radius,
                                     device="cpu")
    out = TiledStencil(sp, shape, sweeps_per_call=4, device="cpu") \
        .iterate(g, 9)
    ref = golden.golden_iterate(x.astype(np.float64), sp, 9, bc=g.bc)
    np.testing.assert_allclose(out.interior().double().numpy(), ref,
                               atol=5e-6, rtol=5e-6)


@pytest.mark.parametrize("shape,k", list(itertools.product(
    [(256, 256, 256), (257, 257, 257), (57, 50, 46)], [1, 4, 8])))
def test_plan_geometry(shape, k):
    """Tiles cover every interior point, every window lies inside the
    padded tensor, and the shared memory fits one block."""
    plan = make_tiled_plan(tspec.get_spec("jacobi7"), shape, "float32", k)
    assert plan.smem_bytes <= SMEM_LIMIT
    for d in range(3):
        covered = np.zeros(shape[d], bool)
        for start in plan.tile_starts(d):
            covered[start:start + plan.tiles[d]] = True
            lo = plan.window_origin(d, start)
            assert lo >= 0
            assert lo + plan.window_shape[d] <= plan.layout.padded_shape[d]
        assert covered.all()
    assert len(plan.kernel_geometry()) == 15


def test_plan_refuses_what_is_not_ported():
    sp = tspec.get_spec("jacobi7")
    with pytest.raises(ValueError, match="3D-only"):
        make_tiled_plan(tspec.get_spec("jacobi5"), (16, 16))
    # bf16 is ported: its plan builds, with 2-byte windows
    bf16 = make_tiled_plan(sp, (16, 16, 16), "bfloat16")
    assert bf16.dtype == "bfloat16" and bf16.itemsize == 2
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_tiled_plan(sp, (16, 16, 16), "float64")
    # the window schedule's 3D windows refuse what the march's rings take
    with pytest.raises(ValueError, match="shared memory"):
        make_tiled_plan(sp, (64, 64, 64), "float32", 8, tiles=(32, 32, 32),
                        schedule="window")
    with pytest.raises(ValueError, match="fits"):
        make_tiled_plan(tspec.get_spec("star3d_r2"), (64, 64, 64),
                        "float32", 8, schedule="window")
    assert make_tiled_plan(sp, (64, 64, 64), "float32", 8,
                           tiles=(32, 32, 32)).schedule == "march"
    assert make_tiled_plan(tspec.get_spec("star3d_r2"), (64, 64, 64),
                           "float32", 8).schedule == "march"
    # and neither takes tiles whose rings and windows overflow
    with pytest.raises(ValueError, match="shared memory"):
        make_tiled_plan(sp, (64, 64, 64), "float32", 8, tiles=(64, 64, 64))
    with pytest.raises(ValueError, match="fits"):
        make_tiled_plan(tspec.get_spec("star3d_r2"), (64, 64, 64),
                        "float32", 17)


def test_wrapper_checks_and_cpu_path(rng):
    sp = tspec.get_spec("jacobi27")
    shape = (9, 10, 11)
    plan = make_tiled_plan(sp, shape, "float32", 2)
    g = tgrid.HaloGrid.from_interior(
        torch.from_numpy(rng.random(shape).astype(np.float32)), device="cpu")
    cur = plan.layout.pad_grid(g)
    nxt = cur.clone()
    before = tiled_sweep.launches
    out = tiled_sweep(cur, nxt, plan)
    assert out is nxt
    assert torch.equal(nxt, sweep_reference(cur, plan))
    assert tiled_sweep.launches == before  # the plain version is no launch
    with pytest.raises(ValueError, match="pins"):
        tiled_sweep(cur, nxt, plan, pins=(0, 0, 1))
    with pytest.raises(ValueError, match="pins"):
        tiled_sweep(cur, nxt, plan, pins=(2, 1, 1, 1))
    with pytest.raises(ValueError, match="dtype"):
        tiled_sweep(cur.double(), nxt.double(), plan)
    with pytest.raises(ValueError, match="shape"):
        tiled_sweep(cur[1:], nxt[1:], plan)
    with pytest.raises(ValueError, match="distinct"):
        tiled_sweep(cur, cur, plan)


def test_tiled_refuses_dynamic_walls(rng):
    """The periodic/Neumann walls the TPU kernel refuses, refused with its
    message: a dynamic lane dim at k>1, a Neumann dim at k>1 under taps
    not mirror-symmetric in it, and a dim shallower than k*r."""
    upwind = [((0, 0, 0), 0.5), ((-1, 0, 0), 0.25), ((0, -1, 0), 0.25)]
    cases = [("jacobi7", (8, 8, 8), 2, dict(periodic=(2,))),
             (upwind, (8, 8, 8), 2, dict(neumann=(0, 1))),
             ("jacobi7", (6, 8, 8), 8, dict(periodic=(0,)))]
    for name, shape, k, walls in cases:
        if isinstance(name, str):
            j, t = jspec.get_spec(name), tspec.get_spec(name)
        else:
            j, t = jspec.weighted(3, name), tspec.weighted(3, name)
        jbc = jgrid.DirichletBC.reference_default(3) \
            .with_periodic(walls.get("periodic", ())) \
            .with_neumann(walls.get("neumann", ()))
        tbc = convert.bc_from_arrays(jbc.values, jbc.periodic, jbc.neumann)
        with pytest.raises(ValueError) as want:
            TiledPallasStencil(j, shape, sweeps_per_call=k,
                               interpret=True, tap_mode="slice").iterate(
                jgrid.HaloGrid.create(shape, bc=jbc), k)
        with pytest.raises(ValueError) as got:
            TiledStencil(t, shape, sweeps_per_call=k, device="cpu").iterate(
                tgrid.HaloGrid.create(shape, bc=tbc, device="cpu"), k)
        assert str(got.value) == str(want.value)


def test_tap_table_is_weight_group_order():
    sp = tspec.get_spec("laplace3d_ho")
    offsets, sizes, weights, uniform, _ = tap_table(sp)
    groups = sp.weight_groups()
    assert not uniform
    assert list(sizes) == [len(offs) for _, offs in groups]
    assert [tuple(o) for o in offsets.reshape(-1, 3)] == \
        [off for _, offs in groups for off in offs]
    np.testing.assert_array_equal(
        weights, np.asarray([w for w, _ in groups], np.float32))


# ---- the Chebyshev and dual modes (B1b, B1c) -----------------------------
#
# The plain versions against the TPU kernel in interpret mode at 7x8x16 (one
# interpret call per test: each costs ~1.5 s on the CPU), against the JAX
# multigrid's XLA smoother elsewhere. Tolerance 1e-6 absolute on values of
# order 1 (fp32; the TPU kernel and XLA may round the same steps in another
# order); the plan's refusals carry the JAX messages.

CHEBY_SHAPE = (7, 8, 16)
CHEBY_BC = ((0.5, -1.0), (2.0, 0.25), (1.0, 1.5))


def _cheby_inputs(rng, shape=CHEBY_SHAPE):
    from stencil_tpu_torch.multigrid import nbsum_spec

    x = rng.random(shape).astype(np.float32)
    f = rng.normal(size=shape).astype(np.float32)
    jbc = jgrid.DirichletBC(values=CHEBY_BC)
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=1, bc=jbc)
    tg = convert.grid_from_arrays(np.asarray(jg.data), 1, CHEBY_BC,
                                  device="cpu")
    return nbsum_spec(3), f, jbc, jg, tg


def _residual_tuple(h):
    return (6.0 / (h * h), -1.0 / (h * h), 0.0, 1.0)


def test_cheby_plain_matches_jax_tiled_interpret(rng):
    from stencil_tpu.multigrid import (
        _cheby_sweep_coeffs, nbsum_spec as jnbsum,
    )

    spec, f, _, jg, tg = _cheby_inputs(rng)
    co = _cheby_sweep_coeffs(3, 4.0, 3, 0.1)
    want = TiledPallasStencil(jnbsum(3), CHEBY_SHAPE, sweeps_per_call=3,
                              source=f, source_scale=1.0, cheby_coeffs=co,
                              interpret=True).iterate(jg, 3)
    stencil = TiledStencil(spec, CHEBY_SHAPE, sweeps_per_call=3,
                           device="cpu", source=f, source_scale=1.0,
                           cheby_coeffs=co)
    before = tiled_sweep.launches
    got = stencil.iterate(tg, 3)
    assert tiled_sweep.launches == before  # the plain version is no launch
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               atol=TOL, rtol=TOL)


def test_dual_runner_matches_jax_interpret(rng):
    from stencil_tpu.multigrid import _cheby_sweep_coeffs
    from stencil_tpu.ops import pallas_tiled as jpt
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.tiled import cheby_dual

    spec, f, jbc, jg, tg = _cheby_inputs(rng)
    co = _cheby_sweep_coeffs(2, 4.0, 3, 0.1) + (_residual_tuple(0.1),)
    jplan = jpt.make_tiled_plan(_jax_nbsum(), CHEBY_SHAPE, "float32", 3,
                                has_source=True, cheby_coeffs=co,
                                cheby_dual=True)
    ju, jr = jpt._cached_cheby_dual_fn(jplan, jbc, True)(
        jg.data, jpt.pad_source(jplan, f, 1.0, jbc))
    plan = make_tiled_plan(spec, CHEBY_SHAPE, "float32", 3, has_source=True,
                           cheby_coeffs=co, cheby_dual=True)
    src = pad_source(plan, f, 1.0, tg.bc)
    before = tiled_sweep.dual_launches
    u, r = cheby_dual(plan, tg.data, tg.bc, src)
    assert tiled_sweep.dual_launches == before
    # the residual carries the 1/h^2 = 100 of its operator: its tolerance
    # scales with it
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=100 * TOL,
                               rtol=TOL)


def _jax_nbsum():
    from stencil_tpu.multigrid import nbsum_spec as jnbsum

    return jnbsum(3)


@pytest.mark.parametrize("k,sweeps", [(2, 5), (3, 7), (4, 4)])
def test_cheby_iterate_matches_jax_smooth_cheby(rng, k, sweeps):
    """Each launch restarts the degree-k recurrence, the remainder launch
    runs the first coefficients: ``sweeps`` iterations are JAX's XLA
    ``_smooth_cheby`` of degree k, repeated, then of degree
    ``sweeps % k``. The tiled kernel's walls are zero here, as on a
    multigrid correction level."""
    from stencil_tpu.multigrid import _cheby_sweep_coeffs, _smooth_cheby
    from stencil_tpu_torch.multigrid import nbsum_spec

    shape, h = (9, 11, 13), 0.1
    x = rng.random(shape).astype(np.float32)
    f = rng.normal(size=shape).astype(np.float32)
    pad = jnp.asarray(np.pad(x, 1))
    for n in [k] * (sweeps // k) + ([sweeps % k] if sweeps % k else []):
        pad = _smooth_cheby(pad, jnp.asarray(f), 1.0 / h ** 2, 6.0, n, 4.0)
    g = tgrid.HaloGrid.from_interior(torch.from_numpy(x), halo=1,
                                     bc=tgrid.DirichletBC.zero(3),
                                     device="cpu")
    got = TiledStencil(nbsum_spec(3), shape, sweeps_per_call=k,
                       device="cpu", source=f,
                       cheby_coeffs=_cheby_sweep_coeffs(k, 4.0, 3, h)
                       ).iterate(g, sweeps)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(pad)[1:-1, 1:-1, 1:-1],
                               atol=1e-5, rtol=1e-5)


def test_cheby_plan_refusals_match_jax():
    from stencil_tpu.ops import pallas_tiled as jpt
    from stencil_tpu_torch.multigrid import nbsum_spec

    shape = (8, 8, 16)
    nb, j7 = nbsum_spec(3), tspec.get_spec("jacobi7")
    jnb = _jax_nbsum()
    co2 = ((1.0, 0.1, 0.0, -0.1), (0.9, 0.2, -0.1, -0.2))
    cases = [
        dict(k=2, has_source=False, cheby_coeffs=co2),
        dict(k=1, has_source=True, cheby_coeffs=co2),
        dict(k=2, has_source=True, cheby_coeffs=((1.0, 0.1, 0.0),) * 2),
        dict(k=1, has_source=True, cheby_coeffs=co2[:1], cheby_dual=True),
        dict(k=2, has_source=True, cheby_coeffs=None, cheby_dual=True),
    ]
    for case in cases:
        k = case.pop("k")
        with pytest.raises(ValueError) as want:
            jpt.make_tiled_plan(jnb, shape, "float32", k, **case)
        with pytest.raises(ValueError) as got:
            make_tiled_plan(nb, shape, "float32", k, **case)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="radius-1"):
        make_tiled_plan(tspec.get_spec("star3d_r2"), shape, "float32", 2,
                        has_source=True, cheby_coeffs=co2)
    with pytest.raises(ValueError, match="at most 16"):
        make_tiled_plan(j7, (64, 64, 64), "float32", 17, has_source=True,
                        cheby_coeffs=co2[:1] * 17, tiles=(1, 2, 16))


def test_cheby_remainder_plan_slices_coefficients():
    from stencil_tpu_torch.multigrid import nbsum_spec

    co = tuple((1.0 + t, 0.1, -0.5 * t, -0.2) for t in range(4))
    plan = make_tiled_plan(nbsum_spec(3), (16, 16, 16), "float32", 4,
                           has_source=True, cheby_coeffs=co, cheby_dual=True)
    assert plan.cheby_coeffs == co and plan.cheby_dual
    rem = plan.with_sweeps(2)
    assert rem.cheby_coeffs == co[:2] and not rem.cheby_dual
    assert rem.tiles == plan.tiles and rem.layout == plan.layout
    assert plan.with_sweeps(4) == plan
    # the smoother modes take the shared memory of a source plan on the
    # window schedule (a source plan would march by default); on the march
    # their rings are 2r+3 planes deep, as the two-level mode's
    window = make_tiled_plan(nbsum_spec(3), (16, 16, 16), "float32", 4,
                             has_source=True, cheby_coeffs=co,
                             cheby_dual=True, schedule="window")
    src = make_tiled_plan(nbsum_spec(3), (16, 16, 16), "float32", 4,
                          tiles=window.tiles, schedule="window")
    assert window.smem_bytes == src.smem_bytes
    march = make_tiled_plan(nbsum_spec(3), (16, 16, 16), "float32", 4,
                            has_source=True, cheby_coeffs=co,
                            cheby_dual=True, schedule="march")
    assert march.smem_bytes == march_smem_bytes(march.tiles, 4, 1, 4, True)


def test_cheby_wrapper_checks(rng):
    from stencil_tpu_torch.multigrid import nbsum_spec
    from stencil_tpu_torch.ops.layout import pad_source

    shape = (6, 7, 9)
    co = ((1.0, 0.1, 0.0, -0.1), (0.9, 0.2, -0.1, -0.2))
    plan = make_tiled_plan(nbsum_spec(3), shape, "float32", 2,
                           has_source=True, cheby_coeffs=co)
    dual = make_tiled_plan(nbsum_spec(3), shape, "float32", 2,
                           has_source=True, cheby_coeffs=co,
                           cheby_dual=True)
    g = tgrid.HaloGrid.from_interior(
        torch.from_numpy(rng.random(shape).astype(np.float32)), device="cpu")
    cur = plan.layout.pad_grid(g)
    src = pad_source(plan, rng.normal(size=shape), 1.0, g.bc)
    with pytest.raises(ValueError, match="needs the padded source"):
        tiled_sweep(cur, cur.clone(), plan)
    with pytest.raises(ValueError, match="out2"):
        tiled_sweep(cur, cur.clone(), plan, src, out2=cur.clone())
    with pytest.raises(ValueError, match="out2"):
        tiled_sweep(cur, cur.clone(), dual, src)
    with pytest.raises(ValueError, match="distinct"):
        nxt = cur.clone()
        tiled_sweep(cur, nxt, dual, src, out2=nxt)
    with pytest.raises(ValueError, match="two outputs"):
        TiledStencil(nbsum_spec(3), shape, sweeps_per_call=2, device="cpu",
                     source=np.zeros(shape), cheby_coeffs=co,
                     cheby_dual=True).iterate(g, 2)
    r, u = tiled_sweep(cur, cur.clone(), dual, src, out2=cur.clone())
    want_r, want_u = sweep_reference(cur, dual, src)
    assert torch.equal(r, want_r) and torch.equal(u, want_u)
    # sweep k-1 of the dual plan is sweep k-1 of the plain Chebyshev plan
    assert torch.equal(u, sweep_reference(cur, plan.with_sweeps(1), src))
