"""The port's sharded eager stencil (methods ``sharded``/``sharded_noverlap``,
stencil_tpu_torch/parallel/halo.py) on its single-controller mesh
(parallel/mesh.py) against JAX's ``ShardedStencil`` on the CPU mesh of
tests/conftest.py; the sharded CLI paths against the port's single-device
ones; and the isolation of the port from JAX.

Tolerances: port vs JAX 1e-6 relative (fp32; both run the same eager taps
in the same order, and agree bitwise on every case here); the overlapped
and plain sweeps bitwise; the CLI's -c error printed digit for digit equal
to the single-device tiled run's."""

import io
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencil_tpu.core import grid as jgrid
from stencil_tpu.core import spec as jspec
from stencil_tpu.parallel.halo import ShardedStencil as JShardedStencil
from stencil_tpu.parallel.halo import make_mesh as jmake_mesh
from stencil_tpu_torch import cli, convert, registry
from stencil_tpu_torch.config import RunConfig, parse_args
from stencil_tpu_torch.core import grid as tgrid
from stencil_tpu_torch.core import spec as tspec
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.parallel import mesh as tmesh
from stencil_tpu_torch.parallel.halo import ShardedStencil

TOL_JAX = 1e-6
ROOT = Path(__file__).resolve().parent.parent


def _bcs(ndim, periodic=(), neumann=(), values=None):
    jbc = (jgrid.DirichletBC(values=values) if values is not None
           else jgrid.DirichletBC.reference_default(ndim))
    jbc = jbc.with_periodic(periodic).with_neumann(neumann)
    return jbc, convert.bc_from_arrays(jbc.values, jbc.periodic, jbc.neumann)


def _pair(name, shape, periodic=(), neumann=(), seed=7, values=None):
    """The same random interior as a JAX and a port grid."""
    jbc, tbc = _bcs(len(shape), periodic, neumann, values)
    r = tspec.get_spec(name).radius
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    jg = jgrid.HaloGrid.from_interior(jnp.asarray(x), halo=r, bc=jbc)
    tg = tgrid.HaloGrid.from_interior(torch.from_numpy(x), halo=r, bc=tbc,
                                      device="cpu")
    return jg, tg


def _port_mesh(sizes, names):
    return tmesh.make_mesh(sizes, [n for n in names if n], device="cpu")


# ---- the mesh ---------------------------------------------------------------


def test_mesh_coords_and_ppermute():
    """Row-major ranks as JAX's mesh; ppermute delivers along one axis,
    None where the open chain sends nothing."""
    mesh = tmesh.make_mesh((2, 3), ("x", "y"), device="cpu")
    assert mesh.size == 6 and mesh.axis_size("y") == 3
    assert [mesh.coords(r) for r in range(6)] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert all(mesh.rank(mesh.coords(r)) == r for r in range(6))
    strips = [torch.full((1,), float(r)) for r in range(6)]
    got = mesh.ppermute(strips, "y", [(i, i + 1) for i in range(2)])
    assert [None if t is None else int(t) for t in got] == [
        None, 0, 1, None, 3, 4]
    got = mesh.ppermute(strips, "x", [(i, (i + 1) % 2) for i in range(2)])
    assert [int(t) for t in got] == [3, 4, 5, 0, 1, 2]
    # ranks beyond the devices wrap onto them: one card holds a (2, 2) mesh
    assert set(tmesh.make_mesh((2, 2), ("x", "y"), "cpu").devices) == {
        torch.device("cpu")}
    assert tmesh.default_mesh_shape("cpu") == (1,)


# ---- ShardedStencil against JAX ---------------------------------------------


@pytest.mark.parametrize("name,shape,sizes,names,iters,periodic,neumann", [
    ("jacobi5", (16, 12), (2,), ("x", None), 3, (), ()),
    ("jacobi9", (16, 12), (2, 2), ("x", "y"), 3, (), ()),
    ("star2d_r2", (16, 12), (2, 2), ("x", "y"), 3, (), ()),
    ("jacobi7", (8, 8, 10), (2,), ("x", None, None), 3, (0,), (1,)),
    ("jacobi27", (8, 8, 8), (2, 2, 2), ("x", "y", "z"), 2, (), ()),
    ("jacobi27", (8, 8, 8), (2, 2), ("x", "y", None), 2, (1,), (0,)),
    ("jacobi27", (8, 8, 8), (2, 2), ("x", "y", None), 2, (0, 2), ()),
    ("star3d_r2", (8, 8, 10), (2, 2), ("x", "y", None), 2, (), (2,)),
    ("jacobi9", (16, 12), (2, 2), ("x", "y"), 3, (), (0, 1)),
])
def test_sharded_matches_jax(name, shape, sizes, names, iters, periodic,
                             neumann):
    """Star and box specs (corners across ranks), radius 2, periodic and
    Neumann walls on sharded and unsharded dims, 1D, 2D and 3D meshes."""
    jg, tg = _pair(name, shape, periodic, neumann)
    want = JShardedStencil(jspec.get_spec(name), names).iterate(
        jg, iters, jmake_mesh(sizes, [n for n in names if n]))
    got = ShardedStencil(tspec.get_spec(name), names).iterate(
        tg, iters, _port_mesh(sizes, names))
    assert got.bc == tg.bc
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()),
                               rtol=TOL_JAX, atol=TOL_JAX)


def test_sharded_custom_bc_matches_jax():
    values = ((5.0, -2.0), (1.5, 0.25))
    jg, tg = _pair("jacobi9", (16, 12), values=values)
    want = JShardedStencil(jspec.get_spec("jacobi9"), ("x", "y")).iterate(
        jg, 3, jmake_mesh((4, 2), ("x", "y")))
    got = ShardedStencil(tspec.get_spec("jacobi9"), ("x", "y")).iterate(
        tg, 3, _port_mesh((4, 2), ("x", "y")))
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()),
                               rtol=TOL_JAX, atol=TOL_JAX)


@pytest.mark.parametrize("name,shape,sizes,names,periodic,neumann", [
    ("jacobi9", (16, 12), (4, 2), ("x", "y"), (), ()),
    ("star2d_r2", (16, 12), (2, 2), ("x", "y"), (1,), ()),
    ("jacobi27", (8, 8, 8), (2, 2, 2), ("x", "y", "z"), (0,), (2,)),
    ("jacobi27", (8, 12, 8), (2,), (None, "x", None), (), (0,)),
    ("jacobi7", (16, 8, 8), (4,), ("x", None, None), (), ()),
])
def test_overlap_bitwise_matches_plain_sweep(name, shape, sizes, names,
                                             periodic, neumann):
    """The interior-first split and its corner fix compute every point as
    the exchange-in-dim-order sweep does, and the single-device eager
    iterate too."""
    _, tg = _pair(name, shape, periodic, neumann)
    sp, mesh = tspec.get_spec(name), _port_mesh(sizes, names)
    a = ShardedStencil(sp, names, overlap=True).iterate(tg, 4, mesh)
    b = ShardedStencil(sp, names, overlap=False).iterate(tg, 4, mesh)
    single = eager.iterate(tg, sp, 4)
    assert torch.equal(a.interior(), b.interior())
    assert torch.equal(a.interior(), single.interior())


def test_indivisible_shape_refuses_like_jax():
    jg = jgrid.HaloGrid.create((30, 40), halo=1)
    with pytest.raises(ValueError) as want:
        JShardedStencil(jspec.jacobi5(), ("x", None)).iterate(
            jg, 1, jmake_mesh((8,), ("x",)))
    tg = tgrid.HaloGrid.create((30, 40), halo=1, device="cpu")
    with pytest.raises(ValueError) as got:
        ShardedStencil(tspec.jacobi5(), ("x", None)).iterate(
            tg, 1, _port_mesh((8,), ("x",)))
    assert str(got.value) == str(want.value)


def test_sharded_bf16_matches_eager():
    """bf16 blocks: the same eager bf16 sweep per rank, bitwise."""
    sp = tspec.get_spec("jacobi7")
    x = np.random.default_rng(3).random((8, 12, 10)).astype(np.float32)
    g = tgrid.HaloGrid.from_interior(torch.from_numpy(x).bfloat16(), halo=1,
                                     bc=tgrid.DirichletBC.reference_default(3),
                                     device="cpu")
    got = ShardedStencil(sp, ("x", "y", None)).iterate(
        g, 3, _port_mesh((2, 2), ("x", "y")))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.interior(), eager.iterate(g, sp, 3).interior())


# ---- the registry and the CLI ----------------------------------------------


def test_registry_routes_sharded_like_jax():
    """Mesh axes of size 1 are dropped from the sharding, as in JAX; the
    default mesh on the CPU is one rank; --no-overlap turns the split
    off."""
    cfg = RunConfig(size=(16, 12, 10), spec="jacobi7", device="cpu",
                    mesh=(2, 1, 2))
    sp = cfg.resolved_spec()
    runner = registry.get_runner("sharded", cfg, sp, cli.make_grid(cfg, sp))
    assert runner.name == "sharded" and runner.plan_info["overlap"]
    g = cli.make_grid(cfg, sp)
    assert torch.equal(runner.iterate(g, 3).interior(),
                       eager.iterate(g, sp, 3).interior())
    cfg.no_overlap = True
    assert registry.get_runner("sharded", cfg, sp, g).name == \
        "sharded_noverlap"
    cfg.mesh = ()
    assert registry.get_runner("sharded_noverlap", cfg, sp,
                               g).plan_info["mesh"] == [1]


def _max_abs_err(argv):
    out = io.StringIO()
    cfg = parse_args(argv)
    recs = cli.run_all(cfg, out=out)
    text = out.getvalue()
    errs = re.findall(r"correctness: OK .* max abs err (\S+),", text)
    assert len(errs) == len(cfg.methods), text
    assert all("error" not in r for r in recs), recs
    return errs


@pytest.mark.parametrize("method", ["sharded_pallas", "sharded"])
def test_cli_sharded_prints_the_single_device_error(method):
    """``-m <method> --mesh 2 2 -k 3 -c`` passes the golden check and
    prints the same max abs error as ``-m tiled -k 3``."""
    base = ["-s", "24", "20", "28", "-i", "9", "--spec", "jacobi7", "-k",
            "3", "-c", "--device", "cpu", "--warmup", "0"]
    tiled = _max_abs_err([*base, "-m", "tiled"])
    sharded = _max_abs_err([*base, "-m", method, "--mesh", "2", "2"])
    assert sharded == tiled


def test_package_and_chip_smoke_import_no_jax():
    """Every module of the port, and chip_smoke.py, load without JAX or
    the JAX package."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import stencil_tpu_torch\n"
        "for m in pkgutil.walk_packages(stencil_tpu_torch.__path__, "
        "'stencil_tpu_torch.'):\n"
        "    if m.name != 'stencil_tpu_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'stencil_tpu.')) or m == 'stencil_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
