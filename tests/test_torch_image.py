"""The heat-map writer (stencil_tpu_torch/utils/image.py and its native
twin native/bmp.cpp) against the JAX package's on the CPU, the cases of
tests/test_native.py:58-100 and tests/test_framework.py:107: the native
colorizer and writer byte for byte the Python ones, the file's header and
size, and ``--dump-image`` in both CLI modes (a filename prefix per method,
a volume's middle plane), each BMP byte for byte the JAX package's for the
same field.

Tolerance: equal bytes."""

import io

import numpy as np
import pytest
import torch

from stencil_tpu import cli as jcli
from stencil_tpu import registry as jregistry
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu.utils import image as jimage
from stencil_tpu_torch import cli, native
from stencil_tpu_torch.config import parse_args
from stencil_tpu_torch.utils import image


def test_native_bmp_matches_python(tmp_path):
    if native.load_bmp() is None:
        pytest.skip("no C++ compiler")
    vals = np.random.default_rng(3).uniform(-0.2, 1.2, size=(33, 47))
    rgb_py = image.colorize(vals)
    np.testing.assert_array_equal(image.colorize_native(vals), rgb_py)
    image.write_bmp(tmp_path / "py.bmp", rgb_py)
    assert image.write_bmp_native(tmp_path / "c.bmp", rgb_py)
    assert (tmp_path / "py.bmp").read_bytes() == \
        (tmp_path / "c.bmp").read_bytes()


@pytest.mark.parametrize("shape", [(33, 47), (64, 32), (5, 6, 7)])
def test_bytes_equal_jax(tmp_path, shape):
    """The same field (a tensor in the port, an array in JAX) gives the
    same file; a volume's middle d0 plane."""
    vals = np.random.default_rng(4).uniform(-0.2, 1.2, size=shape)
    np.testing.assert_array_equal(image.colorize(vals),
                                  jimage.colorize(vals))
    image.dump_heatmap(tmp_path / "t.bmp",
                       torch.from_numpy(vals).float())
    jimage.dump_heatmap(tmp_path / "j.bmp", vals.astype(np.float32))
    assert (tmp_path / "t.bmp").read_bytes() == \
        (tmp_path / "j.bmp").read_bytes()


def test_dump_heatmap_roundtrip(tmp_path):
    p = tmp_path / "h.bmp"
    image.dump_heatmap(p, np.linspace(0, 1, 64 * 32).reshape(64, 32))
    data = p.read_bytes()
    assert data[:2] == b"BM"
    assert len(data) == 14 + 40 + 64 * 32 * 3
    with pytest.raises(ValueError, match="2D or 3D"):
        image.dump_heatmap(p, np.zeros(4))


def test_python_writer_when_native_missing(tmp_path, monkeypatch):
    vals = np.random.default_rng(5).uniform(0, 1, size=(9, 10))
    image.dump_heatmap(tmp_path / "a.bmp", vals)
    monkeypatch.setattr(native, "load_bmp", lambda: None)
    assert image.colorize_native(vals) is None
    image.dump_heatmap(tmp_path / "b.bmp", vals)
    assert (tmp_path / "a.bmp").read_bytes() == \
        (tmp_path / "b.bmp").read_bytes()


def test_cli_dump_image_like_jax(tmp_path):
    """Iterate mode, 2D, one method: the file JAX's writer makes of JAX's
    own iterate (the XLA sweep; JAX's CLI would also time it)."""
    cli.run_all(parse_args(["-s", "16", "16", "-i", "4", "--device", "cpu",
                            "-m", "eager", "--dump-image",
                            str(tmp_path / "t.bmp")]), out=io.StringIO())
    jcfg = jparse_args(["-s", "16", "16", "-i", "4", "--platform", "cpu"])
    jspec = jcfg.resolved_spec()
    jgrid = jcli.make_grid(jcfg, jspec)
    final = jregistry.get_runner("xla", jcfg, jspec, jgrid).iterate(jgrid, 4)
    jimage.dump_heatmap(tmp_path / "j.bmp", np.asarray(final.interior()))
    data = (tmp_path / "t.bmp").read_bytes()
    assert data[:2] == b"BM" and data == (tmp_path / "j.bmp").read_bytes()


def test_cli_dump_image_per_method_prefix(tmp_path):
    out = io.StringIO()
    cli.run_all(parse_args(
        ["--device", "cpu", "-s", "12", "10", "16", "--spec", "jacobi7",
         "-i", "4", "-m", "eager", "tiled", "--dump-image",
         str(tmp_path / "heat.bmp")]), out=out)
    for name in ("eager", "tiled"):
        data = (tmp_path / f"{name}_heat.bmp").read_bytes()
        assert data[:2] == b"BM"
        assert len(data) == 14 + 40 + 10 * (16 * 3)
    assert (tmp_path / "eager_heat.bmp").read_bytes() == \
        (tmp_path / "tiled_heat.bmp").read_bytes()
    assert "heat map ->" in out.getvalue()


def test_solve_dump_image_middle_plane(tmp_path):
    """Solve mode: the solution's middle d0 plane, the bytes JAX's writer
    makes of the same solution."""
    from stencil_tpu_torch import solve_cli

    args = ["--device", "cpu", "--solve", "poisson", "-s", "15", "15", "15",
            "--tol", "1e-4"]
    cli.run_all(parse_args(args + ["--dump-image",
                                   str(tmp_path / "t.bmp")]),
                out=io.StringIO())
    cfg = parse_args(args)
    prob = solve_cli.build_problem(cfg)
    f, _ = solve_cli.build_rhs(cfg, prob)
    solver, kind, _ = solve_cli.build_solver(cfg, prob)
    grid = solve_cli._solve_once(cfg, solver, kind, prob, f)[0]
    jimage.dump_heatmap(tmp_path / "j.bmp", grid.interior().numpy()[7])
    t = (tmp_path / "t.bmp").read_bytes()
    assert len(t) == 14 + 40 + 15 * 48 and t[:2] == b"BM"
    assert t == (tmp_path / "j.bmp").read_bytes()
