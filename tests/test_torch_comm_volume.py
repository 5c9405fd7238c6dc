"""Communication volume of the port's sharded paths, counted by the audit
(stencil_tpu_torch/parallel/comm_audit.py): the counterpart of
tests/test_comm_volume.py, whose jaxpr walk has no PyTorch twin.

One outer step of ``sharded_pallas`` moves exactly ``2 * k * r`` ghost
planes per sharded dim, two ``ppermute`` calls per dim, bytes of the local
block's geometry only: growing the mesh with the problem leaves them as
they are. The strips are derived here from the geometry independently of
the exchange's code. The distributed solvers' profiles are the
counterparts of JAX's ``test_sharded_mg_cycle_collective_profile`` and
``test_distributed_pcg_reductions_are_exactly_the_krylov_dots``, counted
as the code runs rather than read from a compiled graph. All counts are
exact."""

import numpy as np
import pytest
import torch

from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.parallel import comm_audit
from stencil_tpu_torch.parallel.halo import ShardedStencil
from stencil_tpu_torch.parallel.mesh import make_mesh
from stencil_tpu_torch.parallel.sharded_kernel import ShardedKernelStencil


def _run(shape, sizes, k, iters, name="jacobi7", source=None, bc=None,
         **kw):
    axes = ("x", "y")[:len(sizes)]
    sp = tspec.get_spec(name)
    method = ShardedKernelStencil(sp, shape, axis_names=axes,
                                  sweeps_per_call=k,
                                  has_source=source is not None, **kw)
    mesh = make_mesh(sizes, axes, device="cpu")
    grid = tgrid.HaloGrid.create(shape, halo=sp.radius, bc=bc, device="cpu")
    with comm_audit.audit() as rec:
        method.iterate(grid, iters, mesh, source=source)
    return method.local_plan(sizes), rec


def _expected_bytes_3d(plan, nsh):
    """Per sharded dim, lo and hi strips k*r deep, over the padded extent
    of earlier sharded and unsharded dims and the interior of later sharded
    dims (the port pads every dim by k*r)."""
    p0, p1, p2 = plan.layout.padded_shape
    n1 = plan.interior_shape[1]
    kr = plan.halo
    if nsh == 1:
        return 2 * kr * p1 * p2 * plan.itemsize
    return (2 * kr * n1 * p2 + 2 * kr * p0 * p2) * plan.itemsize


@pytest.mark.parametrize("sizes,k", [((4,), 1), ((4,), 2), ((4,), 4),
                                     ((2, 4), 1), ((2, 4), 2), ((2, 2), 3)])
def test_one_step_exchanges_exactly_the_halo(sizes, k):
    shape = (16, 16, 20)
    plan, rec = _run(shape, sizes, k, k)
    nsh = len(sizes)
    assert rec.ppermute_count == 2 * nsh
    assert rec.ppermute_bytes == _expected_bytes_3d(plan, nsh)
    # each strip is 2*k*r planes of its dim in all: k*r deep, lo and hi
    for d in range(nsh):
        strips = [t for t in rec.transfers if t.axis == ("x", "y")[d]]
        assert len(strips) == 2
        assert all(t.shape[d] == k * plan.spec.radius for t in strips)


def test_steps_and_the_remainder_follow_the_launch_depth():
    """Three outer steps move three times one step; a remainder launch of
    rem sweeps moves rem*r-deep strips over its own launch extent."""
    shape, k = (16, 16, 20), 3
    plan, one = _run(shape, (4,), k, k)
    _, three = _run(shape, (4,), k, 3 * k)
    assert three.ppermute_bytes == 3 * one.ppermute_bytes
    _, rem = _run(shape, (4,), k, k + 1)
    tail = rem.transfers[2:]
    assert [t.shape for t in tail] == [(1, 16 + 2, 20 + 2)] * 2


def test_comm_independent_of_mesh_size():
    """Weak scaling's static half: the local block fixed at (8, 16, 20),
    the mesh growing with the problem, the bytes per rank stay."""
    got = []
    for n in (2, 4, 8):
        _, rec = _run((8 * n, 16, 20), (n,), 2, 2)
        got.append((rec.ppermute_count, rec.ppermute_bytes))
    assert got[0] == got[1] == got[2]


def test_2d_grid_slab_path_moves_d0_strips_only():
    sp = tspec.get_spec("jacobi5")
    plan, rec = _run((64, 40), (4,), 2, 2, name="jacobi5")
    assert rec.ppermute_count == 2
    assert all(t.axis == "x" for t in rec.transfers)
    p1 = plan.layout.padded_shape[1]
    assert rec.ppermute_bytes == 2 * plan.halo * p1 * 4 == \
        2 * 2 * sp.radius * (40 + 2 * 2) * 4


def test_source_is_exchanged_once_per_iterate():
    shape, k = (16, 16, 20), 2
    f = np.ones(shape)
    plan, rec = _run(shape, (2, 2), k, 3 * k, name="jacobi7", source=f)
    step = _expected_bytes_3d(plan, 2)
    assert rec.ppermute_count == 4 * (3 + 1)
    assert rec.ppermute_bytes == step * (3 + 1)


def test_overlap_does_not_change_the_volume():
    shape, k = (32, 32, 16), 2
    _, split = _run(shape, (2, 2), k, 2 * k, tiles=(4, 4, 8))
    _, fused = _run(shape, (2, 2), k, 2 * k, tiles=(4, 4, 8),
                    overlap=False)
    assert split.transfers == fused.transfers


def test_eager_sharded_moves_radius_deep_strips_per_sweep():
    """The ``sharded`` method moves 2 r-deep strips per sharded dim per
    sweep, over the block extended in the earlier dims."""
    sp = tspec.get_spec("star2d_r2")
    grid = tgrid.HaloGrid.create((16, 12), halo=2, device="cpu")
    mesh = make_mesh((2, 2), ("x", "y"), device="cpu")
    with comm_audit.audit() as rec:
        ShardedStencil(sp, ("x", "y"), overlap=False).iterate(grid, 3, mesh)
    assert rec.ppermute_count == 3 * 2 * 2
    # dim 0 first, over the local (8, 6) block; then dim 1 over the block
    # extended by r in dim 0
    assert [t.shape for t in rec.transfers[:4]] == [(2, 6), (2, 6),
                                                    (12, 2), (12, 2)]
    assert rec.ppermute_bytes == 3 * 2 * (2 * 6 + 12 * 2) * 4
    assert all(t.dtype == torch.float32 for t in rec.transfers)


def _mg_cycle_audit(shape, n):
    from stencil_tpu_torch.models.poisson import PoissonProblem
    from stencil_tpu_torch.multigrid import Multigrid

    prob = PoissonProblem(shape=shape, device="cpu")
    f = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    r = Multigrid(prob).sharded_runner(f, make_mesh((n,), ("x",),
                                                    device="cpu"))
    with comm_audit.audit() as rec:
        r.iterate(prob.initial_grid(), 1)
    return rec


@pytest.mark.parametrize("shape", [(63, 63), (63, 15, 15)])
def test_sharded_mg_cycle_collective_profile(shape):
    """One V-cycle on 2 and on 4 ranks: halo ``ppermute``s (the same
    number and bytes per rank on both: each strip a plane of the local
    block), the same number of all-gathers (the switch to the replicated
    coarse tail) and no all-reduce: a V-cycle has no global reduction."""
    c2, c4 = (_mg_cycle_audit(shape, n) for n in (2, 4))
    for c in (c2, c4):
        assert c.ppermute_count > 0 and c.all_reduce_count == 0
        assert c.all_gather_count > 0
    assert c2.all_gather_count == c4.all_gather_count
    assert c2.ppermute_count == c4.ppermute_count
    assert c2.ppermute_bytes == c4.ppermute_bytes


def test_distributed_pcg_reductions_are_exactly_the_krylov_dots():
    """Each PCG iteration makes 3 all-reduces, the dots its loop computes
    (p.q, r.z, and r.r of the convergence test), the same on 2 and 4
    ranks; the preconditioning cycle adds all-gathers, not reductions."""
    from stencil_tpu_torch.krylov import ConjugateGradient
    from stencil_tpu_torch.models.poisson import PoissonProblem
    from stencil_tpu_torch.multigrid import Multigrid

    shape = (63, 15, 15)
    prob = PoissonProblem(shape=shape, device="cpu")
    f = np.random.default_rng(5).normal(size=shape).astype(np.float32)

    def audit_of(n, iters):
        cg = ConjugateGradient(prob, preconditioner=Multigrid(prob))
        with comm_audit.audit() as rec:
            cg.solve(f, tolerance=1e-12, max_iterations=iters,
                     mesh=make_mesh((n,), ("x",), device="cpu"),
                     replicate_below=16)
        return rec

    per_iter = {}
    for n in (2, 4):
        a2, a3 = audit_of(n, 2), audit_of(n, 3)
        per_iter[n] = (a3.all_reduce_count - a2.all_reduce_count,
                       a3.all_gather_count - a2.all_gather_count)
    assert per_iter[2] == per_iter[4]
    assert per_iter[2][0] == 3 and per_iter[2][1] > 0
