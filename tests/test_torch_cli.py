"""The port's slice as a whole (stencil_tpu_torch/cli.py, registry.py,
config.py) on the CPU: the 3D and 2D main-path command lines run and pass
their golden checks, and their results agree with the JAX registry's
``xla`` runner on the same grid; the package never imports JAX; no CUDA
request falls back to the CPU; features outside the slice refuse clearly.

Tolerances: port vs JAX allclose at atol = rtol = 1e-6 (fp32); the CLI's
own check against the float64 golden at its default bar, 1e-4."""

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stencil_tpu import cli as jcli
from stencil_tpu import registry as jregistry
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu_torch import cli, native, registry
from stencil_tpu_torch.config import RunConfig, parse_args

TOL = 1e-6
MAIN_ARGS = ["-s", "24", "20", "28", "-i", "8", "--spec", "jacobi7",
             "-m", "pallas_temporal", "-k", "4", "-c"]
MAIN_2D_ARGS = ["-s", "24", "40", "-i", "10", "--spec", "jacobi5",
                "-m", "pallas_temporal", "-k", "4", "-c"]


def test_main_path_cli_runs_and_checks(tmp_path):
    out = tmp_path / "out.jsonl"
    rc = cli.main([*MAIN_ARGS, "--device", "cpu", "--json-out", str(out)])
    assert rc == 0
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["check"]["ok"] and not rec["check"]["capped"]
    assert rec["check"]["iterations_checked"] == 8
    assert rec["check"]["max_abs_err"] < 5e-6
    assert rec["plan"]["kernel"] == "tiled" and rec["plan"]["k"] == 4
    assert rec["device"] == "cpu" and rec["hbm_gbps"] is None


def test_main_path_matches_jax_xla_runner():
    tcfg = parse_args([*MAIN_ARGS, "--device", "cpu"])
    jcfg = jparse_args(MAIN_ARGS)
    tspec, jspec = tcfg.resolved_spec(), jcfg.resolved_spec()
    tgrid, jgrid = cli.make_grid(tcfg, tspec), jcli.make_grid(jcfg, jspec)
    np.testing.assert_array_equal(tgrid.data.numpy(), np.asarray(jgrid.data))
    trun = registry.get_runner("pallas_temporal", tcfg, tspec, tgrid)
    jrun = jregistry.get_runner("xla", jcfg, jspec, jgrid)
    got = trun.iterate(tgrid, 8)
    want = jrun.iterate(jgrid, 8)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("extra", [[], ["--spec", "jacobi9", "-b", "8"],
                                   ["--spec", "star2d_r2", "-s", "30",
                                    "33", "-i", "7"]])
def test_2d_main_path_cli_runs_and_checks(tmp_path, extra):
    out = tmp_path / "out.jsonl"
    rc = cli.main([*MAIN_2D_ARGS, *extra, "--device", "cpu", "--json-out",
                   str(out)])
    assert rc == 0
    rec = json.loads(out.read_text().splitlines()[0])
    iters = 7 if "-i" in extra else 10
    assert rec["check"]["ok"] and not rec["check"]["capped"]
    assert rec["check"]["iterations_checked"] == iters
    assert rec["check"]["max_abs_err"] < 5e-6
    assert rec["plan"]["kernel"] == "slab" and rec["plan"]["k"] == 4
    assert rec["plan"]["source"] == ("flag" if "-b" in extra else "chooser")
    if "-b" in extra:
        assert rec["plan"]["tiles"][0] == 8


@pytest.mark.parametrize("spec", ["jacobi5", "jacobi9"])
def test_2d_main_path_matches_jax_xla_runner(spec):
    args = [*MAIN_2D_ARGS, "--spec", spec]
    tcfg = parse_args([*args, "--device", "cpu"])
    jcfg = jparse_args(args)
    tspec, jspec = tcfg.resolved_spec(), jcfg.resolved_spec()
    tgrid, jgrid = cli.make_grid(tcfg, tspec), jcli.make_grid(jcfg, jspec)
    np.testing.assert_array_equal(tgrid.data.numpy(), np.asarray(jgrid.data))
    trun = registry.get_runner("pallas_temporal", tcfg, tspec, tgrid)
    jrun = jregistry.get_runner("xla", jcfg, jspec, jgrid)
    got = trun.iterate(tgrid, 10)
    want = jrun.iterate(jgrid, 10)
    np.testing.assert_allclose(got.interior().numpy(),
                               np.asarray(want.interior()),
                               atol=TOL, rtol=TOL)


def test_package_imports_no_jax():
    code = (
        "import sys, importlib\n"
        "for m in ['stencil_tpu_torch', 'stencil_tpu_torch.cli', "
        "'stencil_tpu_torch.convert', 'stencil_tpu_torch.ops.tiled', "
        "'stencil_tpu_torch.ops.tiled_kernel', 'stencil_tpu_torch.native', "
        "'stencil_tpu_torch.ops.slab', 'stencil_tpu_torch.ops.slab_kernel', "
        "'stencil_tpu_torch.ops.sweep_kernel', 'stencil_tpu_torch.solver', "
        "'stencil_tpu_torch.models.poisson', 'stencil_tpu_torch.models.heat', "
        "'stencil_tpu_torch.models.wave', "
        "'stencil_tpu_torch.models.diffusion', "
        "'stencil_tpu_torch.multigrid', 'stencil_tpu_torch.krylov', "
        "'stencil_tpu_torch.solve_cli', "
        "'stencil_tpu_torch.utils.roofline']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'stencil_tpu.')) or m == 'stencil_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is "
                    "tested on hosts without one")
    from stencil_tpu_torch.core.grid import HaloGrid

    with pytest.raises(RuntimeError, match="no CUDA device"):
        HaloGrid.create((8, 8, 8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(MAIN_ARGS)  # --device defaults to cuda


# The flags of this case list were refused as not ported before the
# out-of-core and utility slice; each now runs as in the JAX package:
# --chunks goes to -m streamed and is ignored by the other methods (JAX's
# registry reads it only there), --checkpoint-dir checkpoints every method,
# --dump-image writes the heat map, --profile a torch.profiler trace.
@pytest.mark.parametrize("flag", [["--no-overlap", "--chunks", "2"],
                                  ["--mesh", "2", "--profile", "x"],
                                  ["--chunks", "2"],
                                  ["--checkpoint-dir", "x"],
                                  ["--dump-image", "x.bmp"],
                                  ["--profile", "x"]])
def test_features_outside_slice_refuse(capsys, tmp_path, monkeypatch, flag):
    """No longer refused: each runs to exit 0 and leaves its artifact."""
    monkeypatch.chdir(tmp_path)
    assert cli.main([*MAIN_ARGS, "--device", "cpu", *flag]) == 0
    captured = capsys.readouterr()
    assert "not ported yet" not in captured.out + captured.err
    assert "correctness: OK" in captured.out
    if "--profile" in flag:
        assert "profiler trace -> x" in captured.out
        assert any(p.stat().st_size > 0 for p in (tmp_path / "x").iterdir())
    if "--checkpoint-dir" in flag:
        assert [p.name for p in (tmp_path / "x").iterdir()] == [
            "step_0000000008.npz"]
    if "--dump-image" in flag:
        assert (tmp_path / "x.bmp").read_bytes()[:2] == b"BM"
    cfg = parse_args([*MAIN_ARGS, "--device", "cpu", *flag])
    (rec,) = cli.run_all(cfg, out=io.StringIO())
    assert "error" not in rec and rec["check"]["ok"]


@pytest.mark.parametrize("method,k_expected", [
    ("tiled", 1), ("pallas", 1), ("pallas_tiled", 1), ("pallas_temporal", 8)])
def test_method_aliases(method, k_expected):
    cfg = RunConfig(size=(12, 10, 14), spec="jacobi7", device="cpu")
    spec = cfg.resolved_spec()
    runner = registry.get_runner(method, cfg, spec, cli.make_grid(cfg, spec))
    assert runner.plan_info["kernel"] == "tiled"
    assert runner.plan_info["k"] == k_expected == runner.granularity


@pytest.mark.parametrize("method,k_expected", [
    ("slab", 1), ("pallas", 1), ("pallas_temporal", 8)])
def test_2d_method_aliases(method, k_expected):
    cfg = RunConfig(size=(16, 24), spec="jacobi5", device="cpu")
    spec = cfg.resolved_spec()
    runner = registry.get_runner(method, cfg, spec, cli.make_grid(cfg, spec))
    assert runner.plan_info["kernel"] == "slab"
    assert runner.plan_info["k"] == k_expected == runner.granularity
    assert runner.plan_info["smem_bytes"] > 0


@pytest.mark.parametrize("method", ["sharded", "sharded_noverlap",
                                    "sharded_pallas", "rma", "streamed"])
def test_unported_methods_name_their_jax_code(method):
    """Every method once refused as not ported (the sharded ones, ``rma``,
    ``streamed``) runs now, and its runner's description names the JAX
    code it ports."""
    cfg = RunConfig(size=(12, 10, 14), spec="jacobi7", device="cpu")
    spec = cfg.resolved_spec()
    runner = registry.get_runner(method, cfg, spec,
                                 cli.make_grid(cfg, spec))
    where = "stencil_tpu/streaming.py" if method == "streamed" \
        else "stencil_tpu/parallel/"
    assert where in runner.description


def test_varcoeff_method_runs_the_coefficient_mode():
    """``varcoeff`` (ported): a 3D fp32 grid runs the tiled kernel's
    coefficient mode at -k, with the field golden as its check."""
    cfg = RunConfig(size=(12, 10, 14), spec="jacobi7", device="cpu",
                    temporal=3, contrast=30.0)
    spec = cfg.resolved_spec()
    runner = registry.get_runner("varcoeff", cfg, spec,
                                 cli.make_grid(cfg, spec))
    assert runner.plan_info["kernel"] == "tiled"
    assert runner.plan_info["tap_mode"] == "coeff"
    assert runner.plan_info["contrast"] == 30.0 and runner.granularity == 3
    assert runner.golden_fn is not None


def test_2d_and_dynamic_walls_refuse_tiled_but_run_eager():
    """2D grids run the slab kernel and refuse the tiled one (3D-only, as
    in the JAX package); dynamic walls run on both kernels and on eager,
    but for a dynamic lane dim at k>1, which the kernels refuse (JAX's
    gate)."""
    buf = io.StringIO()
    cfg = RunConfig(size=(16, 24), spec="jacobi5", iterations=6,
                    methods=("tiled", "pallas_tiled", "pallas", "xla"),
                    check=True, device="cpu")
    res = cli.run_all(cfg, out=buf)
    assert "3D-only" in res[0]["error"] and "3D-only" in res[1]["error"]
    assert res[2]["check"]["ok"] and res[2]["plan"]["kernel"] == "slab"
    assert res[3]["check"]["ok"]
    cfg = RunConfig(size=(16, 24), spec="jacobi9", iterations=6,
                    methods=("pallas_temporal", "eager"), temporal=2,
                    periodic=("0",), check=True, device="cpu")
    res = cli.run_all(cfg, out=buf)
    assert res[0]["check"]["ok"] and res[0]["plan"]["pins"] == [0, 0]
    assert res[1]["check"]["ok"]
    cfg = RunConfig(size=(10, 12, 14), spec="jacobi27", iterations=6,
                    methods=("pallas_temporal", "eager"), temporal=2,
                    periodic=("0",), neumann=("2",), check=True,
                    device="cpu")
    res = cli.run_all(cfg, out=buf)
    assert "lane (last) dim on the tiled 3D kernel" in res[0]["error"]
    assert res[1]["check"]["ok"]


def test_tpu_tuning_flags_recorded_as_ignored():
    cfg = parse_args([*MAIN_ARGS, "--device", "cpu", "--slots", "3",
                      "--slide", "--tap-mode", "synth", "--autotune"])
    spec = cfg.resolved_spec()
    runner = registry.get_runner("pallas_temporal", cfg, spec,
                                 cli.make_grid(cfg, spec))
    # --autotune is the card's plan search now; on the CPU the chooser's
    # plan applies, and it is not a TPU flag recorded as ignored
    assert runner.plan_info["ignored"] == {
        "slots": 3, "slide": True, "tap_mode": "synth"}
    assert runner.plan_info["source"] == "chooser"


def test_numpy_golden_fallback_is_capped_loudly(monkeypatch):
    monkeypatch.setattr(native, "golden_iterate_native",
                        lambda *a, **k: None)
    buf = io.StringIO()
    cfg = RunConfig(size=(8, 6, 10), spec="jacobi7", iterations=60,
                    methods=("tiled",), temporal=4, check=True,
                    device="cpu")
    chk = cli.run_all(cfg, out=buf)[0]["check"]
    assert chk["ok"] and chk["capped"] and chk["iterations_checked"] == 50
    assert "WARNING" in buf.getvalue() and "50 of 60" in buf.getvalue()


def test_config_parses_every_jax_flag():
    argv = ["-s", "32", "32", "32", "-i", "5", "--spec", "jacobi27",
            "-r", "2", "--dtype", "float32", "-m", "xla", "pallas",
            "-b", "8", "-k", "2", "--tap-mode", "rotacc", "--embed",
            "--cores", "2", "--periodic", "0", "--neumann", "1",
            "--solver", "cg", "--tol", "1e-6", "-R", "2", "-c",
            "--check-tolerance", "1e-3", "--warmup", "2", "-v"]
    t, j = parse_args(argv), jparse_args(argv)
    for field in ("size", "iterations", "spec", "radius", "methods",
                  "block", "temporal", "tap_mode", "embed", "cores",
                  "periodic", "neumann", "solver", "tolerance", "repeat",
                  "check", "check_tolerance", "warmup", "verbose"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.device == "cuda"
