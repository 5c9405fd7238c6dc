"""The port's solve mode (stencil_tpu_torch/solve_cli.py through cli.py) on
the CPU against the JAX package's (stencil_tpu/solve_cli.py): for each
Poisson solver at 15^3 the record has the JAX record's keys and iteration
count and converges to the manufactured solution; so does BiCGStab with
the rediscretized cycle, on the hetero and Poisson families, and GMRES on
the advdiff family; ``--mesh`` (not ported yet) gives an error record,
``--checkpoint-dir`` and ``--dump-image`` run; the fine-level rule
is the JAX one with "on a TPU" read as "on a CUDA device".

Tolerances: the same iteration count; the reported relative residual
within a factor 1.5 of JAX's (at convergence it sits on the fp32 rounding
floor, where the two packages' sums, taken in another order, move it by
up to ~16%: the sine right-hand side is one eigenvector, which CG resolves
in one iteration to ~3e-6, and multigrid's max-norm certificate floors
near 1e-5); the error against the exact solution within rtol 1e-3 of
JAX's; the error against the
exact solution under the JAX tests' bars (3 h^2, and 5 h^2 on the
non-cubic grid)."""

import io
import json
import os

import numpy as np
import pytest

from stencil_tpu.cli import run_all as jrun_all
from stencil_tpu.config import RunConfig as JRunConfig
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu_torch import cli, solve_cli
from stencil_tpu_torch.config import RunConfig, parse_args


def _both(**kw):
    with open(os.devnull, "w") as out:
        (want,) = jrun_all(JRunConfig(**kw), out=out)
    (got,) = cli.run_all(RunConfig(device="cpu", **kw), out=io.StringIO())
    return got, want


def _assert_like_jax(got, want):
    assert set(want) <= set(got), set(want) - set(got)
    assert got["iterations"] == want["iterations"]
    assert got["converged"] == want["converged"]
    if want["residual_rel"] == 0.0:  # relax: a fixed point, no update
        assert got["residual_rel"] == 0.0
    else:
        assert 1 / 1.5 < got["residual_rel"] / want["residual_rel"] < 1.5
    for key in ("solve", "solver", "size", "dtype", "tolerance"):
        assert got[key] == want[key], key
    assert got["plan"] == want["plan"]


def test_parse_solver_flags_like_jax():
    argv = ["--solve", "poisson", "--solver", "pcg", "--tol", "1e-4",
            "--precond", "mg", "--precond-dtype", "bfloat16",
            "--smoother", "chebyshev", "--gamma", "2", "--nu-smooth", "3",
            "3", "--fine-method", "pallas_tiled", "--warm-start", "fmg",
            "--rhs", "random", "-s", "15", "15", "15", "-i", "30"]
    t, j = parse_args(argv), jparse_args(argv)
    for field in ("solve", "solver", "tolerance", "precond",
                  "precond_dtype", "smoother", "gamma", "nu_smooth",
                  "fine_method", "warm_start", "rhs", "size", "iterations"):
        assert getattr(t, field) == getattr(j, field), field


@pytest.mark.parametrize("solver,extra", [
    ("auto", {}), ("cg", {}), ("pcg", {"smoother": "chebyshev"}),
    ("pcg", {"gamma": 2}), ("mg", {"tolerance": 1e-6, "iterations": 30}),
    ("mg", {"smoother": "chebyshev", "nu_smooth": (3, 3),
            "tolerance": 1e-6, "iterations": 30}),
    ("fmg", {})])
def test_poisson_solvers_match_jax(solver, extra):
    kw = dict(solve="poisson", solver=solver, size=(15, 15, 15),
              iterations=100, tolerance=1e-5, check=True)
    kw.update(extra)
    got, want = _both(**kw)
    _assert_like_jax(got, want)
    assert got["converged"]
    assert got["check"]["error_vs_exact"] < 3 * (1.0 / 16) ** 2
    np.testing.assert_allclose(got["check"]["error_vs_exact"],
                               want["check"]["error_vs_exact"], rtol=1e-3)


def test_relax_matches_jax():
    got, want = _both(solve="poisson", solver="relax", size=(15, 15),
                      iterations=3000, tolerance=1e-7)
    _assert_like_jax(got, want)
    assert got["converged"]


def test_non_cubic_and_warm_start_match_jax():
    got, want = _both(solve="poisson", size=(24, 15, 11), iterations=100,
                      tolerance=1e-5, check=True)
    _assert_like_jax(got, want)
    assert got["check"]["error_vs_exact"] < 5 * (1.0 / 25) ** 2
    got, want = _both(solve="poisson", solver="pcg", warm_start="fmg",
                      size=(15, 15, 15), iterations=60, tolerance=1e-4,
                      check=True)
    _assert_like_jax(got, want)
    assert got["plan"]["warm_start"] == "fmg"


def test_tiled_fine_level_record():
    """--fine-method pallas_tiled runs the fine level on the tiled kernel
    (its plain version on the CPU) and reaches JAX's count with its XLA
    fine level (the same cycle up to reassociation)."""
    kw = dict(solve="poisson", size=(15, 15, 15), iterations=50,
              tolerance=1e-5, check=True, smoother="chebyshev")
    got, _ = _both(fine_method="pallas_tiled", **kw)
    _, want = _both(fine_method="xla", **kw)
    assert got["plan"]["fine_method"] == "pallas_tiled"
    assert got["iterations"] == want["iterations"] and got["converged"]
    assert got["check"]["error_vs_exact"] < 3 * (1.0 / 16) ** 2


def test_json_out_and_repeats(tmp_path):
    path = tmp_path / "solve.jsonl"
    (rec,) = cli.run_all(RunConfig(
        solve="poisson", size=(15, 15, 15), iterations=100, tolerance=1e-4,
        check=True, json_out=str(path), repeat=2, device="cpu"),
        out=io.StringIO())
    on_disk = json.loads(path.read_text())
    for key in ("solve", "solver", "iterations", "residual",
                "residual_rel", "converged", "plan", "check",
                "wall_seconds"):
        assert key in on_disk, key
    assert on_disk == json.loads(json.dumps(rec))
    assert len(rec["wall_seconds"]) == 2


@pytest.fixture
def cheap_opmg(monkeypatch):
    """Both packages' OperatorMultigrid with 8 coarse sweeps, not 32: the
    JAX solve, whose cycle is unrolled into its jit, then compiles in about
    a second."""
    import functools

    import stencil_tpu.multigrid as jmg
    import stencil_tpu_torch.multigrid as tmg

    for mod in (jmg, tmg):
        monkeypatch.setattr(mod, "OperatorMultigrid", functools.partial(
            mod.OperatorMultigrid, coarse_sweeps=8))


@pytest.mark.parametrize("kw", [
    dict(solve="hetero", size=(7, 7, 7)),
    dict(solve="poisson", solver="bicgstab", size=(15, 15),
         nu_smooth=(1, 1)),
    dict(solve="advdiff", size=(15, 15)),
    dict(solve="advdiff", size=(7, 7, 7), scheme="central",
         velocity=(0.5, -0.5, 1.0), nu=0.5)])
def test_bicgstab_records_match_jax(cheap_opmg, kw):
    """BiCGStab with the rediscretized cycle (``auto`` for hetero and
    advdiff, in 2D and 3D, and on the Poisson problem): the JAX record's
    keys, iterations and plan."""
    got, want = _both(**kw)
    _assert_like_jax(got, want)
    assert got["solver"] == "bicgstab" and got["plan"]["precond"] == "opmg"


@pytest.mark.parametrize("kw,what", [
    (dict(solve="advdiff", solver="gmres", restart=4), "--solve advdiff"),
    (dict(solve="poisson", solver="gmres", precond="opmg", restart=4),
     "--solver gmres"),
    (dict(solve="poisson", mesh=(2,)), "--mesh"),
    (dict(solve="poisson", checkpoint_dir="ck"), "--checkpoint-dir"),
    (dict(solve="poisson", dump_image="u.bmp"), "--dump-image")])
def test_unported_are_error_records(tmp_path, monkeypatch, cheap_opmg, kw,
                                    what):
    """Of the solve-mode features once refused, only ``--mesh`` (the
    distributed solvers) still gives an error record; the others solve:
    advdiff and GMRES with JAX's record (keys, iterations, plan with
    ``restart``), ``--checkpoint-dir`` a checkpointed record and its
    checkpoints, ``--dump-image`` the heat map."""
    monkeypatch.chdir(tmp_path)
    if "solver" in kw:  # 7^3 and GMRES(4): JAX's cycle compiles quickly
        got, want = _both(size=(7, 7, 7), iterations=10, **kw)
        _assert_like_jax(got, want)
        assert got["plan"]["restart"] == 4 and got["converged"]
        return
    path = tmp_path / "rec.jsonl"
    out = io.StringIO()
    (rec,) = cli.run_all(RunConfig(size=(15, 15, 15), iterations=10,
                                   device="cpu", json_out=str(path), **kw),
                         out=out)
    assert json.loads(path.read_text()) == rec
    if what == "--mesh":
        assert "not ported yet" in rec["error"] and what in rec["error"]
        assert "unavailable" in out.getvalue()
        return
    assert "error" not in rec and rec["converged"], rec
    if "checkpoint_dir" in kw:
        assert rec["checkpointed"] is True
        assert list((tmp_path / "ck").glob("step_*.npz"))
    if "dump_image" in kw:
        assert (tmp_path / "u.bmp").read_bytes()[:2] == b"BM"


def test_contradictions_are_error_records_like_jax():
    for kw in (dict(solve="poisson", solver="cg", precond="opmg"),
               dict(solve="poisson", solver="mg", precond="mg"),
               dict(solve="poisson", solver="cg", precond="none",
                    precond_dtype="bfloat16"),
               dict(solve="hetero", solver="bicgstab", precond="mg"),
               dict(solve="hetero", precond_dtype="bfloat16"),
               dict(solve="hetero", solver="pcg"),
               dict(solve="hetero", contrast=0.5)):
        got, want = _both(size=(15, 15), iterations=10, **kw)
        assert got == want


def test_main_exit_codes():
    assert cli.main(["--device", "cpu", "--solve", "poisson", "-s", "15",
                     "15", "-i", "100", "--tol", "1e-4"]) == 0
    # an unconverged solve is a nonzero exit, as a failed -c is
    assert cli.main(["--device", "cpu", "--solve", "poisson", "-s", "15",
                     "15", "-i", "2", "--tol", "1e-12", "--solver",
                     "cg"]) == 1
    assert cli.main(["--device", "cpu", "--solve", "hetero", "-s", "15",
                     "15"]) == 0
    # advdiff (ported): BiCGStab + the rediscretized cycle converges and
    # exits 0, as the JAX CLI's run does
    assert cli.main(["--device", "cpu", "--solve", "advdiff", "-s", "15",
                     "15"]) == 0


def test_fine_method_rule(monkeypatch):
    """The JAX rule: the tiled fine level for chebyshev at any nu and for
    wjacobi at nu >= 4, on a 3D fp32 grid at least 32 wide, on the card;
    an explicit --fine-method wins."""
    def fm(**kw):
        return solve_cli._resolve_fine_method(
            RunConfig(solve="poisson", device="cpu", **kw), None)

    assert fm(size=(63, 63, 63), smoother="chebyshev") == "xla"  # no card
    monkeypatch.setattr(solve_cli, "_on_cuda", lambda config: True)
    assert fm(size=(63, 63, 63), smoother="chebyshev") == "pallas_tiled"
    assert fm(size=(63, 63, 63)) == "xla"
    assert fm(size=(63, 63, 63), nu_smooth=(4, 4)) == "pallas_tiled"
    assert fm(size=(31, 31, 31), smoother="chebyshev") == "xla"
    assert fm(size=(63, 63), smoother="chebyshev") == "xla"
    assert fm(size=(63, 63, 63), fine_method="xla",
              smoother="chebyshev") == "xla"
    assert fm(size=(15, 15, 15), fine_method="pallas_tiled") == \
        "pallas_tiled"
