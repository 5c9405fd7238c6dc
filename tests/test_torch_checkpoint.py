"""Checkpoint and resume (stencil_tpu_torch/utils/checkpoint.py) on the
CPU, the cases of tests/test_checkpoint.py: the round trip, the newest
file, a checkpointed run against the uninterrupted one, a resume after an
interruption, retention, the shape, stencil and BC refusals, a torn write,
the streamed method's host residency, every kernel method; plus the
format across packages (a checkpoint written by the JAX package resumes
in the port, one written by the port in the JAX package) and the solve
mode's chunked, resumable solve (``--checkpoint-dir`` with ``--solve``)
against JAX's record.

Tolerances: bitwise where one package runs both sides (the checkpoint
holds the exact interior); across packages 5e-6 (JAX's XLA sweep against
the port's eager one, the golden's bar)."""

import io

import numpy as np
import pytest
import torch

from stencil_tpu import cli as jcli
from stencil_tpu import registry as jregistry
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu.core.grid import HaloGrid as JGrid
from stencil_tpu.core.spec import get_spec as jget_spec
from stencil_tpu.utils import checkpoint as jcheckpoint
from stencil_tpu_torch import cli, registry
from stencil_tpu_torch.config import RunConfig, parse_args
from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.streaming import host_halo_grid
from stencil_tpu_torch.utils import checkpoint


@pytest.fixture
def setup():
    spec = get_spec("jacobi5")
    grid = HaloGrid.create((32, 24), halo=1, device="cpu")
    runner = registry.get_runner("eager", None, spec, grid)
    return spec, grid, runner


def test_save_load_roundtrip(tmp_path, setup):
    spec, grid, runner = setup
    out = runner.iterate(grid, 5)
    p = checkpoint.save(tmp_path / "step_0000000005.npz", out, 5, "jacobi5")
    state = checkpoint.load(p)
    assert (state.iteration, state.spec_name, state.dtype) == (
        5, "jacobi5", "float32")
    assert state.bc == grid.bc
    np.testing.assert_array_equal(state.interior, out.interior().numpy())
    assert torch.equal(state.to_grid(device="cpu").data, out.data)


def test_latest_picks_newest(tmp_path, setup):
    spec, grid, runner = setup
    for step in (3, 12, 7):
        checkpoint.save(tmp_path / f"step_{step:010d}.npz", grid, step)
    assert checkpoint.latest(tmp_path).name == "step_0000000012.npz"
    assert checkpoint.latest(tmp_path / "nope") is None


def test_checkpointed_run_matches_uninterrupted(tmp_path, setup):
    spec, grid, runner = setup
    ref = runner.iterate(grid, 20)
    out, done = checkpoint.CheckpointedRun(
        runner, tmp_path, every=6, spec_name="jacobi5").run(grid, 20)
    assert done == 20
    assert torch.equal(out.data, ref.data)
    assert len(list(tmp_path.glob("step_*.npz"))) == 2  # retention


def test_resume_after_interrupt(tmp_path, setup):
    spec, grid, runner = setup
    ref = runner.iterate(grid, 20)
    checkpoint.CheckpointedRun(runner, tmp_path, every=6,
                               spec_name="jacobi5").run(grid, 12)
    msgs = []
    out, done = checkpoint.CheckpointedRun(
        runner, tmp_path, every=6, spec_name="jacobi5",
    ).run(grid, 20, progress=msgs.append)
    assert done == 20
    assert any("resumed" in m and "iteration 12" in m for m in msgs)
    assert torch.equal(out.data, ref.data)


def test_refusals_match_jax(tmp_path, setup):
    """Shape, stencil and BC mismatches refuse, with JAX's messages (the
    path in them aside)."""
    spec, grid, runner = setup
    jgrid = JGrid.create((32, 24), halo=1)
    jrunner = jregistry.get_runner("xla", None, jget_spec("jacobi5"), jgrid)
    cases = [
        (dict(), HaloGrid.create((16, 24), halo=1, device="cpu"),
         JGrid.create((16, 24), halo=1), "does not match"),
        (dict(spec_name="jacobi9"), grid, jgrid,
         "refusing to resume a different"),
        (dict(spec_name="jacobi5"),
         HaloGrid.create((32, 24), halo=1, bc=DirichletBC.zero(2),
                         device="cpu"),
         JGrid.create((32, 24), halo=1,
                      bc=jgrid.bc.__class__.zero(2)), "boundary conditions"),
    ]
    for i, (kw, tgrid, jg, what) in enumerate(cases):
        d = tmp_path / str(i)
        checkpoint.save(d / "step_0000000005.npz", grid, 5, "jacobi5")
        with pytest.raises(ValueError, match=what) as got:
            checkpoint.CheckpointedRun(runner, d, **kw).run(tgrid, 10)
        with pytest.raises(ValueError) as want:
            jcheckpoint.CheckpointedRun(jrunner, d, **kw).run(jg, 10)
        assert str(got.value) == str(want.value)


def test_torn_write_leaves_no_partial(tmp_path, setup, monkeypatch):
    spec, grid, runner = setup

    def boom(*a, **k):
        raise KeyboardInterrupt

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save(tmp_path / "step_0000000001.npz", grid, 1)
    assert list(tmp_path.glob("step_*.npz")) == []
    assert list(tmp_path.glob("*.tmp")) == []


def test_resume_stays_host_resident_for_streamed(tmp_path, monkeypatch):
    """A streamed run's grid lies in host memory and is resumed there."""
    spec = get_spec("jacobi7")
    shape = (18, 16, 20)
    cfg = RunConfig(size=shape, spec="jacobi7", methods=("streamed",),
                    chunks=3, temporal=2, device="cpu")
    grid = host_halo_grid(shape, halo=1)
    runner = registry.get_runner("streamed", cfg, spec, grid)
    ref = runner.iterate(grid, 12)
    devices = []
    orig = checkpoint.CheckpointState.to_grid

    def spy(self, dtype=None, device="cuda"):
        devices.append(torch.device(device))
        return orig(self, dtype=dtype, device=device)

    monkeypatch.setattr(checkpoint.CheckpointState, "to_grid", spy)
    d = tmp_path / "streamed"
    checkpoint.CheckpointedRun(runner, d, every=4,
                               spec_name="jacobi7").run(grid, 8)
    out, done = checkpoint.CheckpointedRun(
        runner, d, every=4, spec_name="jacobi7").run(grid, 12)
    assert done == 12 and devices == [torch.device("cpu")]
    assert out.device.type == "cpu"
    assert torch.equal(out.data, ref.data)
    state = checkpoint.load(checkpoint.latest(d))
    fresh = host_halo_grid(shape, halo=1, interior=state.interior)
    assert torch.equal(state.to_grid(device="cpu").data, fresh.data)


@pytest.mark.parametrize("method,kw", [
    ("pallas", {"temporal": 2}), ("slab", {"temporal": 2}),
    ("sharded_pallas", {"temporal": 2, "mesh": (2,)}),
    ("sharded_pallas", {"temporal": 2, "mesh": (2, 2)}),
    ("rma", {"temporal": 2, "mesh": (2, 2)}),
    ("streamed", {"temporal": 2, "chunks": 2})])
def test_checkpoint_resume_across_methods(tmp_path, method, kw):
    """Every kernel family resumes bitwise: no padded layout, mesh or
    host buffer leaks into the state."""
    shape = (16, 16) if method == "slab" else (16, 16, 24)
    name = "jacobi5" if method == "slab" else "jacobi7"
    spec = get_spec(name)
    grid = HaloGrid.create(shape, halo=1, device="cpu")
    cfg = RunConfig(size=shape, spec=name, methods=(method,),
                    device="cpu", **kw)
    runner = registry.get_runner(method, cfg, spec, grid)
    ref = runner.iterate(grid, 12)
    d = tmp_path / method
    checkpoint.CheckpointedRun(runner, d, every=4,
                               spec_name=name).run(grid, 8)
    out, done = checkpoint.CheckpointedRun(
        runner, d, every=4, spec_name=name).run(grid, 12)
    assert done == 12
    assert torch.equal(out.interior().cpu(), ref.interior().cpu())


@pytest.mark.parametrize("bc", [None, "periodic"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, bc):
    """JAX writes after 6 sweeps; the port resumes to 12, within the
    golden's bar of JAX's own 12."""
    jspec = jget_spec("jacobi7")
    jgrid = JGrid.create((12, 10, 16), halo=1)
    if bc:
        jgrid = JGrid.create((12, 10, 16), halo=1,
                             bc=jgrid.bc.with_periodic([0]))
    jrunner = jregistry.get_runner("xla", None, jspec, jgrid)
    jcheckpoint.CheckpointedRun(jrunner, tmp_path, every=3,
                                spec_name="jacobi7").run(jgrid, 6)
    want, _ = jcheckpoint.CheckpointedRun(
        jrunner, tmp_path / "j", every=3, spec_name="jacobi7").run(jgrid,
                                                                   12)
    spec = get_spec("jacobi7")
    tbc = DirichletBC(values=jgrid.bc.values, periodic=jgrid.bc.periodic,
                      neumann=jgrid.bc.neumann)
    grid = HaloGrid.create((12, 10, 16), halo=1, bc=tbc, device="cpu")
    runner = registry.get_runner("eager", None, spec, grid)
    msgs = []
    got, done = checkpoint.CheckpointedRun(
        runner, tmp_path, every=3, spec_name="jacobi7").run(
            grid, 12, progress=msgs.append)
    assert done == 12 and "iteration 6" in msgs[0]
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()), atol=5e-6)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    spec = get_spec("jacobi7")
    grid = HaloGrid.create((12, 10, 16), halo=1, device="cpu")
    runner = registry.get_runner("tiled", RunConfig(
        size=(12, 10, 16), spec="jacobi7", device="cpu", temporal=3),
        spec, grid)
    want, _ = checkpoint.CheckpointedRun(
        runner, tmp_path / "t", every=3, spec_name="jacobi7").run(grid, 12)
    checkpoint.CheckpointedRun(runner, tmp_path, every=3,
                               spec_name="jacobi7").run(grid, 6)
    jspec = jget_spec("jacobi7")
    jgrid = JGrid.create((12, 10, 16), halo=1)
    jrunner = jregistry.get_runner("xla", None, jspec, jgrid)
    got, done = jcheckpoint.CheckpointedRun(
        jrunner, tmp_path, every=3, spec_name="jacobi7").run(jgrid, 12)
    assert done == 12
    np.testing.assert_allclose(np.asarray(got.interior()),
                               want.interior().numpy(), atol=5e-6)


def test_bf16_round_trip(tmp_path):
    """A bfloat16 interior goes to the file as float32 (exact) and comes
    back as bfloat16, bit for bit."""
    x = torch.randn(6, 7, 8).to(torch.bfloat16)
    grid = HaloGrid.from_interior(x, halo=1, device="cpu")
    p = checkpoint.save(tmp_path / "step_0000000001.npz", grid, 1)
    state = checkpoint.load(p)
    assert state.dtype == "bfloat16" and state.interior.dtype == np.float32
    assert torch.equal(state.to_grid(device="cpu").data, grid.data)


def test_iterate_cli_checkpoints_per_method(tmp_path):
    """``--checkpoint-dir`` with two methods: one subdirectory each, both
    at the last iteration, as the JAX CLI records it."""
    out = io.StringIO()
    args = ["--device", "cpu", "-s", "12", "10", "16", "--spec", "jacobi7",
            "-i", "7", "-m", "eager", "tiled", "-k", "2",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "3"]
    recs = cli.run_all(parse_args(args), out=out)
    assert [r["checkpointed_iterations"] for r in recs] == [7, 7]
    for name in ("eager", "tiled"):
        state = checkpoint.load(checkpoint.latest(tmp_path / name))
        assert state.iteration == 7 and state.spec_name == "jacobi7"
    assert "[tiled] checkpoint at iteration 6" in out.getvalue()


@pytest.mark.parametrize("solver,size,every", [
    (["cg"], ["15", "15"], "20"),
    (["gmres", "--precond", "none", "--restart", "8"], ["9", "9"], "20")])
def test_solve_mode_checkpoints_like_jax(tmp_path, solver, size, every):
    """``--solve`` with ``--checkpoint-dir``: the chunked solve's record
    (iterations, convergence) and its checkpoints as JAX's; a second run
    resumes from the last checkpoint and does no more work. (Each chunk's
    tolerance differs, and JAX compiles a solve per tolerance: cheap
    solvers keep the test short.)"""
    args = ["--solve", "poisson", "-s", *size, "-i", "400", "--tol",
            "1e-5", "--rhs", "random", "--solver", *solver,
            "--checkpoint-every", every]
    want = jcli.run_all(jparse_args(
        args + ["--platform", "cpu", "--checkpoint-dir",
                str(tmp_path / "j")]), out=io.StringIO())[0]
    out = io.StringIO()
    got = cli.run_all(parse_args(
        args + ["--device", "cpu", "--checkpoint-dir",
                str(tmp_path / "t")]), out=out)[0]
    assert got["checkpointed"] is want["checkpointed"] is True
    assert got["iterations"] == want["iterations"]
    assert got["converged"] == want["converged"] is True
    np.testing.assert_allclose(got["residual_rel"], want["residual_rel"],
                               rtol=0.5)
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())
    again = io.StringIO()
    rec = cli.run_all(parse_args(
        args + ["--device", "cpu", "--checkpoint-dir",
                str(tmp_path / "t")]), out=again)[0]
    assert "resumed at iteration" in again.getvalue()
    assert rec["iterations"] == got["iterations"] and rec["converged"]


def test_solve_mode_fmg_skips_checkpoints(tmp_path):
    out = io.StringIO()
    rec = cli.run_all(parse_args(
        ["--device", "cpu", "--solve", "poisson", "-s", "15", "15",
         "--solver", "fmg", "--checkpoint-dir", str(tmp_path)]), out=out)[0]
    assert "checkpointing skipped: FMG is one pass" in out.getvalue()
    assert "checkpointed" not in rec and not list(tmp_path.iterdir())
