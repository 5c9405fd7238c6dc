"""The port's distributed multigrid (stencil_tpu_torch/multigrid.py:
Multigrid.sharded_runner, OperatorMultigrid's sharded cycle, over
stencil_tpu_torch/parallel/sharded_field.py) on the CPU, against the
port's one-device cycle and the JAX package's (stencil_tpu/multigrid.py)
ladder, gates and cycles.

The sharded cycle runs the one-device operations per block in the same
order, so it is held **bitwise** to the one-device eager cycle
(``fine_method='xla'``), at the shapes of the JAX package's distributed
tests (tests/test_multigrid.py:279-360,451-466, tests/test_mesh2d.py);
against JAX's one-device runner (and once its GSPMD runner) with JAX's bar
between its own distributed and one-device cycles, 1e-6 absolute. The
ladder (``plan_info``) equals JAX's exactly, and each gate gives JAX's
message. The balanced split, the exchange and the transfers across rank
boundaries at odd widths are checked in pure Python, bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu import multigrid as jmg
from stencil_tpu.models.poisson import PoissonProblem as JPoisson
from stencil_tpu.models.poisson import manufactured_sine
from stencil_tpu.parallel.halo import make_mesh as jmake_mesh
from stencil_tpu_torch import multigrid as tmg
from stencil_tpu_torch.core.grid import DirichletBC
from stencil_tpu_torch.models.advection_diffusion import (
    AdvectionDiffusionProblem,
)
from stencil_tpu_torch.models.diffusion import (
    HeterogeneousPoissonProblem, two_material,
)
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.parallel import sharded_field as sf
from stencil_tpu_torch.parallel.mesh import make_mesh

TOL = 1e-6  # JAX's bar between its distributed and one-device cycles
AXES = ("x", "y")


def _mesh(*sizes):
    return make_mesh(sizes, AXES[:len(sizes)], device="cpu")


def _jmesh(*sizes):
    return jmake_mesh(sizes, AXES[:len(sizes)])


def _source(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- the layout: balanced split, derived coarse blocks, the exchange --

@pytest.mark.parametrize("n,parts,want", [
    (63, 4, (0, 16, 32, 48, 63)), (39, 4, (0, 10, 20, 30, 39)),
    (31, 8, (0, 4, 8, 12, 16, 20, 24, 28, 31)), (8, 8, tuple(range(9))),
    (17, 4, (0, 5, 9, 13, 17)), (127, 2, (0, 64, 127))])
def test_balanced_split(n, parts, want):
    got = sf.balanced_bounds(n, parts)
    assert got == want
    widths = [b - a for a, b in zip(got, got[1:])]
    assert min(widths) >= 1 and max(widths) - min(widths) <= 1
    assert widths == sorted(widths, reverse=True)


def test_balanced_split_refuses_empty_ranks():
    with pytest.raises(ValueError, match="non-empty"):
        sf.balanced_bounds(3, 4)
    # a coarse level cut from its parent's blocks may not leave a rank
    # empty either: replicate_below below the axis size is refused
    prob = PoissonProblem(shape=(15, 15), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tmg.Multigrid(prob).sharded_runner(_source((15, 15)), _mesh(8),
                                           replicate_below=2)


def test_coarse_blocks_derive_from_the_parent():
    mesh = _mesh(4)
    layouts, flags, rb = tmg._level_shardings_for(
        [(63, 7), (31, 3), (15, 1)], 2, mesh, replicate_below=8)
    assert flags == [True, True, True] and rb == (8,)
    assert [lay.bounds[0] for lay in layouts] == [
        (0, 16, 32, 48, 63), (0, 8, 16, 24, 31), (0, 4, 8, 12, 15)]
    assert layouts[2].spec == ("x", None)
    # one key per block on the one CPU device; a replicated level one key
    rep = layouts[0].drop([0])
    assert len(layouts[0].keys) == 4 and len(rep.keys) == 1


@pytest.mark.parametrize("shape,sizes", [((9, 7, 6), (2, 3)),
                                         ((11, 10), (4,)),
                                         ((7, 9, 5), (3, 2))])
def test_exchange_fills_ghosts_and_corners(shape, sizes):
    """Cut a random padded array into padded blocks, spoil every ghost
    between ranks, exchange: each block equals its cut again, corners
    included, and the exchange made two ppermutes per sharded axis."""
    from stencil_tpu_torch.parallel import comm_audit

    mesh = _mesh(*sizes)
    lay = sf.fine_layout(mesh, shape, 0)
    padded = torch.from_numpy(_source(tuple(s + 2 for s in shape)))
    want = sf.scatter(lay, padded, halo=1)
    got = sf.scatter(lay, padded, halo=1)
    for i, b in enumerate(got.blocks):
        for a in lay.sharded:
            d = lay.dims[a]
            lo, hi = lay.part_range(lay.keys[i][0], a)
            if lo > 0:
                b.narrow(d, 0, 1).fill_(np.nan)
            if hi < shape[d]:
                b.narrow(d, b.shape[d] - 1, 1).fill_(np.nan)
    with comm_audit.audit() as rec:
        got.exchange()
    assert rec.ppermute_count == 2 * len(sizes)
    for g, w in zip(got.blocks, want.blocks):
        assert torch.equal(g, w)
    assert torch.equal(sf.gather(got, "cpu"), padded[tuple(
        slice(1, s + 1) for s in shape)])


@pytest.mark.parametrize("fine,sizes,coarse_axes", [
    ((63, 15), (4,), (0,)), ((39, 9), (4,), (0,)), ((11, 9), (4,), (0,)),
    ((39, 39, 5), (2, 4), (0, 1)), ((31, 9, 3), (2, 4), (0,)),
    ((63, 15), (4,), ()), ((21, 13), (3, 2), (1,))])
def test_transfers_across_rank_boundaries_are_bitwise(fine, sizes,
                                                      coarse_axes):
    """Restriction and prolongation of a field whose blocks start and end
    at odd and even fine indices, onto a coarse level sharded on
    ``coarse_axes`` (the rest replicated: the all-gather), against the
    one-device transfers, bitwise."""
    mesh = _mesh(*sizes)
    coarse = tuple((n - 1) // 2 for n in fine)
    fl = sf.fine_layout(mesh, fine, 0)
    cl = fl.derived(coarse).drop([a for a in range(len(sizes))
                                  if a not in coarse_axes])
    r = torch.from_numpy(_source(fine, 3))
    rc = sf.restrict(sf.scatter(fl, r), cl, tmg._restrict_fw)
    assert rc.layout is cl
    assert torch.equal(sf.gather(rc, "cpu"), tmg._restrict_fw(r))
    e = torch.from_numpy(_source(coarse, 4))
    ep = sf.scatter(cl, torch.nn.functional.pad(e, (1, 1) * len(fine)),
                    halo=1)
    up = sf.prolong(ep, fl, tmg._prolong_lin)
    assert torch.equal(sf.gather(up, "cpu"), tmg._prolong_lin(e))


def test_dot_sums_rank_partials_in_rank_order():
    from stencil_tpu_torch.parallel import comm_audit

    mesh = _mesh(2, 2)
    lay = sf.fine_layout(mesh, (9, 7), 0)
    a, b = (torch.from_numpy(_source((9, 7), s)) for s in (5, 6))
    with comm_audit.audit() as rec:
        got = sf.dot(sf.scatter(lay, a), sf.scatter(lay, b))
    parts = [(a[lay.slices(i)] * b[lay.slices(i)]).sum()
             for i in range(4)]
    assert torch.equal(got, ((parts[0] + parts[1]) + parts[2]) + parts[3])
    assert rec.all_reduce_count == 1 and rec.ppermute_count == 0
    assert abs(float(got) - float((a * b).sum())) < 1e-4


# -- the ladder and the gates, against JAX --

@pytest.mark.parametrize("shape,sizes,dim,rb", [
    ((63, 63), (4,), 0, None), ((31, 63), (4,), 1, None),
    ((31, 31, 31), (8,), 0, 8), ((31, 15, 15), (4,), 0, 8),
    ((127, 39, 15), (2, 4), 0, None), ((15, 127, 39), (2, 4), 1, None)])
def test_ladder_matches_jax(shape, sizes, dim, rb):
    jm = jmg.Multigrid(JPoisson(shape=shape))
    tm = tmg.Multigrid(PoissonProblem(shape=shape, device="cpu"))
    jsh, jflags, jrb = jm._level_shardings(_jmesh(*sizes), dim, rb)
    layouts, flags, trb = tm._level_shardings(_mesh(*sizes), dim, rb)
    assert flags == jflags and trb == jrb
    nd = len(shape)
    assert [lay.spec for lay in layouts] == [
        tuple(s.spec) + (None,) * (nd - len(s.spec)) for s in jsh]
    f = np.zeros(shape, np.float32)
    jinfo = jm.sharded_runner(f, _jmesh(*sizes), dim, rb).plan_info
    tinfo = tm.sharded_runner(f, _mesh(*sizes), dim, rb).plan_info
    for key in ("levels", "level_shapes", "nu", "omega", "smoother",
                "gamma", "mesh", "sharded_dim", "sharded_levels",
                "replicate_below"):
        assert tinfo[key] == jinfo[key], key
    assert tinfo["fine_method"] == "xla+mesh"


def test_per_axis_replication_on_a_2d_mesh():
    """(127, 39, 15) on (2, 4): the last level (31, 9, 3) stays sharded on
    d0 after d1 collapsed; replicate_below per axis [17, 17]."""
    prob = PoissonProblem(shape=(127, 39, 15), device="cpu")
    layouts, flags, rb = tmg.Multigrid(prob)._level_shardings(_mesh(2, 4))
    assert list(rb) == [17, 17] and flags == [True, True, True, False]
    assert [lay.spec for lay in layouts] == [
        ("x", "y", None), ("x", "y", None), ("x", None, None),
        (None, None, None)]


def _gate_cases(mg, Mesh3, Mesh1, prob3_mg):
    f = np.zeros((63, 63), np.float32)
    f3 = np.zeros((31, 31, 31), np.float32)
    return [lambda: mg.sharded_runner(f, Mesh3()),
            lambda: mg.sharded_runner(f, Mesh1(), replicate_below=64),
            lambda: mg.sharded_runner(f, Mesh1(), dim=2),
            lambda: prob3_mg.sharded_runner(f3, Mesh1())]


def test_gates_match_jax():
    """"1D or 2D", "too narrow", "out of range" and "GSPMD" (the tiled
    fine level), each with JAX's message."""
    jcases = _gate_cases(
        jmg.Multigrid(JPoisson(shape=(63, 63))),
        lambda: jmake_mesh((2, 2, 2), ("x", "y", "z")),
        lambda: _jmesh(4),
        jmg.Multigrid(JPoisson(shape=(31, 31, 31)),
                      fine_method="pallas_tiled"))
    tcases = _gate_cases(
        tmg.Multigrid(PoissonProblem(shape=(63, 63), device="cpu")),
        lambda: make_mesh((2, 2, 2), ("x", "y", "z"), device="cpu"),
        lambda: _mesh(4),
        tmg.Multigrid(PoissonProblem(shape=(31, 31, 31), device="cpu"),
                      fine_method="pallas_tiled"))
    for want_call, got_call, match in zip(
            jcases, tcases, ("1D or 2D", "too narrow", "out of range",
                             "GSPMD")):
        with pytest.raises(ValueError) as want:
            want_call()
        with pytest.raises(ValueError, match=match) as got:
            got_call()
        assert str(got.value) == str(want.value)


# -- the cycles: bitwise the one-device eager cycle --

@pytest.mark.parametrize("shape,sizes,kw", [
    ((63, 63), (4,), {}),
    ((31, 63), (4,), dict(dim=1)),
    ((31, 31, 31), (8,), dict(replicate_below=8, gamma=2)),
    ((31, 15, 15), (4,), dict(replicate_below=8, smoother="chebyshev")),
    ((127, 39, 15), (2, 4), {}),
    ((63, 63), (3,), dict(bc=True)),
    ((41, 23), (2, 2), dict(replicate_below=3, gamma=2))])
def test_sharded_runner_is_bitwise_the_eager_runner(shape, sizes, kw):
    kw = dict(kw)
    dim = kw.pop("dim", 0)
    rb = kw.pop("replicate_below", None)
    bc = DirichletBC.reference_default(len(shape)) if kw.pop("bc", False) \
        else None
    prob = PoissonProblem(shape=shape, bc=bc, device="cpu")
    f = _source(shape)
    mg = tmg.Multigrid(prob, fine_method="xla", **kw)
    want = mg.runner(f).iterate(prob.initial_grid(), 3)
    r = mg.sharded_runner(f, _mesh(*sizes), dim=dim, replicate_below=rb)
    got = r.iterate(prob.initial_grid(), 3)
    assert torch.equal(got.data, want.data)
    assert r.plan_info["mesh"] == list(sizes)


def test_sharded_runner_matches_jax_single_device():
    """JAX's (63, 63) case (test_sharded_runner_matches_single_device):
    the port's sharded cycle within JAX's 1e-6 of JAX's one-device
    runner."""
    shape = (63, 63)
    f, _ = manufactured_sine(shape)
    want = jmg.Multigrid(JPoisson(shape=shape)).runner(f).iterate(
        JPoisson(shape=shape).initial_grid(), 3)
    prob = PoissonProblem(shape=shape, device="cpu")
    got = tmg.Multigrid(prob).sharded_runner(f, _mesh(4)).iterate(
        prob.initial_grid(), 3)
    d = np.max(np.abs(np.asarray(want.data, np.float64)
                      - got.data.double().numpy()))
    assert d < TOL, d


def test_sharded_runner_matches_jax_gspmd_runner():
    """One run of JAX's own GSPMD cycle, the smallest of its shapes
    ((31, 63) sharded on dim 1 over 4 devices, 2 cycles): the port's
    sharded cycle within 1e-6."""
    shape = (31, 63)
    f, _ = manufactured_sine(shape)
    jp = JPoisson(shape=shape)
    want = jmg.Multigrid(jp).sharded_runner(f, _jmesh(4), dim=1).iterate(
        jp.initial_grid(), 2)
    prob = PoissonProblem(shape=shape, device="cpu")
    got = tmg.Multigrid(prob).sharded_runner(f, _mesh(4), dim=1).iterate(
        prob.initial_grid(), 2)
    d = np.max(np.abs(np.asarray(jnp.asarray(want.data), np.float64)
                      - got.data.double().numpy()))
    assert d < TOL, d


def test_sharded_w_cycle_converges_3d():
    """JAX's test_sharded_runner_converges_3d: the W-cycle re-enters the
    replicated tail twice per level; six cycles reach 1.2 h^2."""
    shape = (31, 31, 31)
    prob = PoissonProblem(shape=shape, device="cpu")
    f, u = manufactured_sine(shape)
    r = tmg.Multigrid(prob, gamma=2).sharded_runner(f, _mesh(8),
                                                    replicate_below=8)
    g = prob.initial_grid()
    for _ in range(6):
        g = r.iterate(g, 1)
    err = float(np.max(np.abs(g.interior().double().numpy() - u)))
    assert err < 1.2 * (1.0 / 32) ** 2, err


@pytest.mark.parametrize("family", ["hetero", "advdiff"])
def test_operator_multigrid_sharded_cycle_is_bitwise(family):
    """OperatorMultigrid's cycle on the ladder (the hetero weight fields
    cut like each level, no halo) against its one-device cycle, bitwise,
    on (2, 2): level 1 sharded on d0 only, levels 2 and 3 replicated."""
    shape = (31, 15, 15)
    if family == "hetero":
        prob = HeterogeneousPoissonProblem(
            shape=shape, a=two_material(shape, seed=7), device="cpu")
    else:
        prob = AdvectionDiffusionProblem(shape=shape,
                                         velocity=(1.0, -0.5, 0.25),
                                         nu=0.1, device="cpu")
    opmg = tmg.OperatorMultigrid(prob, gamma=2)
    f = torch.from_numpy(_source(shape, 8))
    want = opmg._make_cycle()(torch.zeros_like(f), f, 0,
                              opmg._level_datas())
    layouts, flags, _ = opmg._level_shardings(_mesh(2, 2),
                                              replicate_below=8)
    assert flags == [True, True, False, False]
    assert layouts[1].spec == ("x", None, None)
    cycle = opmg._make_cycle(tmg._MeshLevels(layouts))
    fl = sf.scatter(layouts[0], f)
    got = cycle(sf.zeros_like(fl), fl, 0, opmg._level_datas(layouts))
    assert torch.equal(sf.gather(got, "cpu"), want)
