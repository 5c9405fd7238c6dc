"""The weak-scaling harness (stencil_tpu_torch/scaling.py) on the CPU,
the counterpart of tests/test_scaling.py: the ladder runs up to 8 ranks
(which share the CPU, as they would share one card), and the widest mesh's
result through the measured path (scatter once, the steps on the blocks,
gather) is within 5e-6 of the float64 golden, bitwise the port's one-rank
``tiled`` result, and within 5e-6 of JAX's ``ShardedPallasStencil`` (in
interpret mode) on the same mesh. CPU timings carry no meaning.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core.grid import DirichletBC as JDirichletBC
from stencil_tpu.core.grid import HaloGrid as JHaloGrid
from stencil_tpu.core.spec import get_spec as jget_spec
from stencil_tpu.parallel.halo import make_mesh as jmake_mesh
from stencil_tpu.parallel.pallas_sharded import ShardedPallasStencil
from stencil_tpu.scaling import ScalePoint as JScalePoint
from stencil_tpu_torch import scaling
from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.tiled import TiledStencil
from stencil_tpu_torch.parallel.mesh import make_mesh
from stencil_tpu_torch.parallel.sharded_kernel import ShardedKernelStencil
from stencil_tpu_torch.scaling import run_weak_scaling

TOL = 5e-6


def test_weak_scaling_full_ladder():
    msgs = []
    pts = run_weak_scaling(
        local_shape=(8, 16, 24), spec_name="jacobi7", temporal=2,
        mesh_sizes=[1, 2, 4, 8], progress=msgs.append, device="cpu")
    assert [p.n_devices for p in pts] == [1, 2, 4, 8]
    assert pts[0].efficiency == 1.0
    assert pts[-1].global_shape == (64, 16, 24)
    assert all(p.glups > 0 for p in pts)
    assert [p.ranks_per_device for p in pts] == [1, 2, 4, 8]
    audit = [m for m in msgs if m.startswith("comm audit")]
    assert len(audit) == 1 and "ppermutes/step" in audit[0]
    points = [m for m in msgs if not m.startswith("comm audit")]
    assert all("GLUPS" in m for m in points)
    # every point whose ranks share the device says it measures the
    # exchange, not scaling
    assert [scaling.SHARED_NOTE in m for m in points] == [False, True, True,
                                                          True]
    # JAX's fields, and one of the port's own
    jfields = [f.name for f in dataclasses.fields(JScalePoint)]
    tfields = [f.name for f in dataclasses.fields(scaling.ScalePoint)]
    assert tfields[:len(jfields)] == jfields


def _measured_path(spec, gshape, n, k, iters, bc):
    """The path run_weak_scaling times, then a gather."""
    grid = HaloGrid.create(gshape, halo=spec.radius, bc=bc, device="cpu")
    mesh = make_mesh((n,), ("x",), "cpu")
    method = ShardedKernelStencil(spec, gshape, axis_names=("x",),
                                  sweeps_per_call=k)
    blocks = method.scatter(grid, mesh)
    out = method.run_steps(mesh, blocks, [b.clone() for b in blocks], bc,
                           iters)
    return method.gather(out, mesh, grid), grid


def _jax_result(gshape, n, k, iters, jbc):
    mesh = jmake_mesh((n,), ("x",))
    grid = JHaloGrid.create(gshape, halo=1, bc=jbc)
    method = ShardedPallasStencil(jget_spec("jacobi7"), gshape,
                                  axis_name="x", sweeps_per_call=k,
                                  interpret=True)
    stacked = method.scatter(grid, mesh)
    fn = method.iterate_fn(mesh, grid.bc)
    out, _ = fn(stacked, jnp.array(stacked, copy=True),
                jnp.int32(iters // k))
    return np.asarray(method.gather(out, mesh, grid).interior(), np.float64)


@pytest.fixture(scope="module")
def jax_results():
    """JAX's results on the two meshes the tests check, computed once for
    the module: Dirichlet at n=8 and the torus at n=4, k=2, 6 sweeps."""
    torus = JDirichletBC.reference_default(3).with_periodic((0,)) \
        .with_neumann((1,))
    return {8: _jax_result((64, 16, 24), 8, 2, 6,
                           JDirichletBC.reference_default(3)),
            4: _jax_result((32, 16, 24), 4, 2, 6, torus)}


def test_weak_scaling_8rank_matches_golden(jax_results):
    """The configuration the harness times at n=8 gives the golden's
    result, bitwise the one-rank tiled iterate, and JAX's within 5e-6."""
    spec = get_spec("jacobi7")
    n, k, iters = 8, 2, 6
    gshape = (8 * n, 16, 24)
    bc = DirichletBC.reference_default(3)
    result, grid = _measured_path(spec, gshape, n, k, iters, bc)
    ref = golden.golden_iterate(np.zeros(gshape, np.float64), spec, iters,
                                bc=grid.bc)
    got = result.interior().double().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    one = TiledStencil(spec, gshape, sweeps_per_call=k, device="cpu")
    assert torch.equal(result.interior(), one.iterate(grid, iters).interior())
    np.testing.assert_allclose(got, jax_results[n], atol=TOL, rtol=TOL)


def test_weak_scaling_periodic_torus(jax_results):
    """Torus-wrapped weak scaling: a periodic sharded d0 (the ring) and a
    Neumann d1, through the harness's measured path, against the golden
    at the widest mesh."""
    msgs = []
    pts = run_weak_scaling(
        local_shape=(8, 16, 24), spec_name="jacobi7", temporal=2,
        mesh_sizes=[1, 4], periodic=(0,), neumann=(1,),
        progress=msgs.append, device="cpu")
    assert [p.n_devices for p in pts] == [1, 4]
    assert all(p.glups > 0 for p in pts)

    spec = get_spec("jacobi7")
    n, k, iters = 4, 2, 6
    gshape = (8 * n, 16, 24)
    bc = DirichletBC.reference_default(3).with_periodic((0,)) \
        .with_neumann((1,))
    result, grid = _measured_path(spec, gshape, n, k, iters, bc)
    ref = golden.golden_iterate(np.zeros(gshape, np.float64), spec, iters,
                                bc=grid.bc)
    got = result.interior().double().numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, jax_results[n], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name,k", [("jacobi7", 1), ("jacobi7", 3),
                                    ("laplace3d_ho", 2)])
def test_audit_line_counts_2kr_planes(name, k):
    msgs = []
    run_weak_scaling(local_shape=(12, 8, 16), spec_name=name, temporal=k,
                     mesh_sizes=[2], progress=msgs.append, device="cpu")
    (audit,) = [m for m in msgs if m.startswith("comm audit")]
    r = get_spec(name).radius
    planes = 2 * k * r
    assert audit.startswith("comm audit: 2 ppermutes/step, ")
    assert f" {planes} ghost planes per sharded dim (2*k*r = {planes};" \
        in audit
    # one strip of k*r planes of 8 x 16 points grown by the launch's ghosts
    mb = 2 * k * r * (8 + 2 * k * r) * (16 + 2 * k * r) * 4 / 1e6
    assert f"{mb:.2f} MB/rank/step" in audit


def test_main_prints_the_shared_note_and_json(tmp_path, capsys):
    path = tmp_path / "pts.jsonl"
    assert scaling.main(["--device", "cpu", "--local", "4", "8", "16", "-k",
                         "2", "--mesh-sizes", "1", "2", "--json-out",
                         str(path)]) == 0
    out = capsys.readouterr().out
    assert f"note: at n = [2] {scaling.SHARED_NOTE}" in out
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["n_devices"] for r in recs] == [1, 2]
    assert recs[1]["global_shape"] == [8, 8, 16]
    assert recs[1]["ranks_per_device"] == 2
