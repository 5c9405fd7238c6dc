"""The experiment sweep harness (stencil_tpu_torch/sweep.py) on the CPU,
the counterpart of tests/test_framework.py:118-150 and
tests/test_solve_cli.py:160: the configurations equal JAX's field for field
for the same arguments, ``run_sweep`` writes JAX's CSV columns and JSON
lines at 16^2 and 16^3 (the eager sweep and the kernels' plain versions),
and each row's ``-c`` error lies within 5e-6 of the JAX row's, checked by
JAX's own ``cli.check_method`` on the same configuration.
"""

import csv
import dataclasses
import json

import pytest

from stencil_tpu import cli as jcli
from stencil_tpu import registry as jregistry
from stencil_tpu import sweep as jsweep
from stencil_tpu_torch import sweep
from stencil_tpu_torch.config import RunConfig

TOL = 5e-6
# the port's RunConfig has --device where JAX's CLI has --platform
_PORT_ONLY = {"device"}


def _fields(cfg, exclude=()):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in exclude}


def _same_fields(tcfg, jcfg):
    tf, jf = _fields(tcfg, _PORT_ONLY), _fields(jcfg)
    common = set(tf) & set(jf)
    assert common >= {"size", "iterations", "spec", "methods", "temporal",
                      "check", "dtype", "mesh", "periodic", "neumann",
                      "solve", "solver", "tolerance", "precond",
                      "smoother", "restart"}
    for key in common:
        assert tf[key] == jf[key], key


def test_sweep_configs_consistent_with_cli():
    cfgs = sweep.sweep_configs(sizes=[32], iterations=[4], methods=["xla"])
    assert all(isinstance(c, RunConfig) for c in cfgs)
    assert cfgs[0].size == (32, 32) and cfgs[0].device == "cuda"
    assert sweep.sweep_configs(sizes=[8], iterations=[2],
                               device="cpu")[0].device == "cpu"


@pytest.mark.parametrize("kw", [
    {},
    {"sizes": [16, 32], "iterations": [2, 4], "methods": ["xla", "pallas"],
     "ndim": 3, "temporal": 4, "check": True,
     "dtypes": ["float32", "bfloat16"], "mesh": [2],
     "periodic": ["0"], "neumann": ["1"]},
    {"sizes": [24], "iterations": [8], "spec": "star2d_r2"},
])
def test_sweep_configs_match_jax(kw):
    tcfgs = sweep.sweep_configs(**kw)
    jcfgs = jsweep.sweep_configs(**kw)
    assert len(tcfgs) == len(jcfgs) > 0
    for t, j in zip(tcfgs, jcfgs):
        _same_fields(t, j)


@pytest.mark.parametrize("kw", [
    {},
    {"families": ("poisson",), "solvers": ("pcg", "gmres"), "sizes": (15,),
     "restarts": (8, 16), "ndim": 3, "iterations": 50},
    {"families": ("poisson", "hetero"), "solvers": ("mg", "bicgstab"),
     "sizes": (15, 31), "smoothers": ("wjacobi", "chebyshev"),
     "tolerances": (1e-4, 1e-6), "preconds": (None, "opmg")},
])
def test_solver_sweep_configs_match_jax(kw):
    tcfgs = sweep.solver_sweep_configs(**kw)
    jcfgs = jsweep.solver_sweep_configs(**kw)
    assert len(tcfgs) == len(jcfgs) > 0
    for t, j in zip(tcfgs, jcfgs):
        _same_fields(t, j)


def test_solver_sweep_configs_cross_product():
    cfgs = sweep.solver_sweep_configs(
        families=("poisson",), solvers=("pcg", "gmres"), sizes=(15,),
        restarts=(8, 16), ndim=3, iterations=50)
    # restart only varies gmres rows: pcg x1 + gmres x2
    assert len(cfgs) == 3
    assert all(c.solve == "poisson" for c in cfgs)
    gm = [c for c in cfgs if c.solver == "gmres"]
    assert sorted(c.restart for c in gm) == [8, 16]
    # the smoother only varies the multigrid-cycle rows
    cfgs = sweep.solver_sweep_configs(
        solvers=("pcg", "bicgstab"), sizes=(15,),
        smoothers=("wjacobi", "chebyshev"))
    assert [(c.solver, c.smoother) for c in cfgs] == [
        ("pcg", "wjacobi"), ("pcg", "chebyshev"), ("bicgstab", "wjacobi")]


ROW_CASES = [(2, ["xla", "pallas_temporal"]), (2, ["pallas"]),
             (3, ["xla", "pallas_temporal"])]


@pytest.fixture(scope="module")
def jax_errors():
    """JAX's -c error per (ndim, method) for JAX's own sweep configuration
    at 16^ndim, 4 iterations, computed once for the module."""
    errs = {}
    for ndim, methods in ROW_CASES:
        (jcfg,) = jsweep.sweep_configs(sizes=[16], iterations=[4],
                                       methods=methods, ndim=ndim,
                                       check=True)
        spec = jcfg.resolved_spec()
        for name in methods:
            runner = jregistry.get_runner(name, jcfg, spec,
                                          jcli.make_grid(jcfg, spec))
            chk, _ = jcli.check_method(jcfg, spec, runner)
            errs[ndim, name] = chk.max_abs_err
    return errs


@pytest.mark.parametrize("ndim,methods", ROW_CASES)
def test_run_sweep_rows_match_jax(tmp_path, monkeypatch, jax_errors, ndim,
                                  methods):
    """16^ndim, 4 iterations: JAX's CSV columns (the same writer run on the
    same records by JAX's run_sweep), one JSON line per row, and each row's
    error within 5e-6 of JAX's."""
    cfgs = sweep.sweep_configs(sizes=[16], iterations=[4], methods=methods,
                               ndim=ndim, check=True, device="cpu")
    msgs = []
    rows = sweep.run_sweep(cfgs, csv_path=tmp_path / "s.csv",
                           json_path=tmp_path / "s.jsonl",
                           progress=msgs.append)
    assert msgs == [f"[1/1] size={(16,) * ndim} iters=4 "
                    f"methods={tuple(methods)}"]
    assert [r["method"] for r in rows] == methods
    lines = (tmp_path / "s.jsonl").read_text().splitlines()
    assert [json.loads(line) for line in lines] == rows
    with open(tmp_path / "s.csv") as f:
        table = list(csv.DictReader(f))
    header = list(table[0])
    assert header[:4] == ["method", "spec", "iterations", "dtype"]
    assert header[-1] == "size" and table[0]["size"] == "x".join(
        ["16"] * ndim)
    # JAX's writer on the same records writes the same file
    monkeypatch.setattr(jsweep, "run_all", lambda cfg: rows)
    jsweep.run_sweep(cfgs, csv_path=tmp_path / "j.csv",
                     json_path=None, progress=lambda *_: None)
    assert (tmp_path / "j.csv").read_text() == \
        (tmp_path / "s.csv").read_text()
    for r in rows:
        assert r["check"]["ok"] and r["glups"] > 0
        assert abs(r["check"]["max_abs_err"]
                   - jax_errors[ndim, r["method"]]) <= TOL


def test_solver_sweep_runs_end_to_end(tmp_path):
    cfgs = sweep.solver_sweep_configs(solvers=("pcg",), sizes=(15,),
                                      iterations=100, device="cpu")
    rows = sweep.run_sweep(cfgs, csv_path=tmp_path / "s.csv",
                           json_path=tmp_path / "s.jsonl",
                           progress=lambda *_: None)
    (row,) = rows
    assert row["solve"] == "poisson" and row["solver"] == "pcg"
    assert row["converged"]
    assert row["check"]["error_vs_exact"] < 3 * (1.0 / 16) ** 2
    header = (tmp_path / "s.csv").read_text().splitlines()[0].split(",")
    assert header[0] == "method" and header[-1] == "size"


def test_main_takes_the_device_flag(tmp_path):
    rc = sweep.main(["--device", "cpu", "--sizes", "12", "--iterations",
                     "2", "--methods", "eager", "--check", "--csv",
                     str(tmp_path / "m.csv"), "--json",
                     str(tmp_path / "m.jsonl")])
    assert rc == 0
    (rec,) = [json.loads(x) for x in
              (tmp_path / "m.jsonl").read_text().splitlines()]
    assert rec["device"] == "cpu" and rec["check"]["ok"]
