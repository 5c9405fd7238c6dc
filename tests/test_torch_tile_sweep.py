"""The 2D chooser's tile sweep (stencil_tpu_torch/tile_sweep.py): the rows
the chooser's constants were fitted to and those of a later sweep, read
back and scored; the tiles a sweep times; the refit; the refusal to time without a card. Timing itself
needs a card: ``python -m stencil_tpu_torch.tile_sweep --out rows.csv``.

Tolerances: scores are computed from the committed rows in float64; the
committed constants must score within 1e-12 (relative) of the best point
of the refit grid, and the bounds on the scores are the rows' own values
(geometric mean 1.0649x, worst 1.3379x) rounded up in the fourth digit."""

import pytest

from stencil_tpu_torch import tile_sweep
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.ops.slab import (
    COST_CONSTANTS, SMEM_LIMIT, candidate_tiles, choose_tiles,
)
from stencil_tpu_torch.ops.tiled import _smem_bytes

FIT_ROWS = tile_sweep.DATA_DIR / "slab_tiles_h100_fit.csv"
CHECK_ROWS = tile_sweep.DATA_DIR / "slab_tiles_h100_check.csv"


@pytest.fixture(scope="module")
def fit_rows():
    return tile_sweep.read_rows(FIT_ROWS)


@pytest.mark.parametrize("path", [FIT_ROWS, CHECK_ROWS],
                         ids=["fit", "check"])
def test_rows_cover_every_case(path):
    """One group of rows per case, each holding the chooser's own pick,
    every tile fitting one block's shared memory."""
    rows = tile_sweep.read_rows(path)
    assert set(rows) == set(tile_sweep.CASES)
    for (name, shape, k, t0_fixed), measured in rows.items():
        spec = get_spec(name)
        assert choose_tiles(spec, shape, k, t0_fixed) in measured
        for tiles, ms in measured.items():
            assert _smem_bytes(tiles, k, spec.radius) <= SMEM_LIMIT
            assert t0_fixed is None or tiles[0] == t0_fixed
            assert ms > 0
    assert sum(map(len, rows.values())) == 1762


def test_committed_chooser_scores_on_its_rows(fit_rows):
    results = tile_sweep.score(fit_rows)
    for r in results:
        name, shape, k, t0_fixed = r["case"]
        assert r["pick"] == choose_tiles(get_spec(name), shape, k, t0_fixed)
        assert r["ratio"] >= 1.0
    assert tile_sweep.geomean(results) < 1.065
    assert max(r["ratio"] for r in results) < 1.338
    # the pinned-t0 case (cfg2) picks the best tile there is
    cfg2 = [r for r in results if r["case"][3] == 256]
    assert len(cfg2) == 1 and cfg2[0]["ratio"] == 1.0


def test_refit_finds_the_committed_constants(fit_rows):
    grid = ((100, 200, 300), (COST_CONSTANTS[1],), (4, 6, 8))
    ranked = tile_sweep.fit(fit_rows, grid)
    assert len(ranked) == 9
    committed = tile_sweep.geomean(tile_sweep.score(fit_rows))
    assert committed <= ranked[0][0] * (1 + 1e-12)


@pytest.mark.parametrize("case", tile_sweep.CASES[:4])
def test_sweep_tiles_fit_and_hold_the_pick(case):
    name, shape, k, t0_fixed = case
    spec = get_spec(name)
    tiles = tile_sweep.sweep_tiles(name, shape, k, t0_fixed)
    assert choose_tiles(spec, shape, k, t0_fixed) in tiles
    assert set(candidate_tiles(spec, shape, k, t0_fixed)) <= set(tiles)
    assert all(_smem_bytes(t, k, spec.radius) <= SMEM_LIMIT for t in tiles)


def test_measure_needs_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        tile_sweep.measure(tmp_path / "rows.csv")
    assert not (tmp_path / "rows.csv").exists()


def test_cli_scores_and_refuses_nothing_to_do(capsys):
    assert tile_sweep.main(["--score", str(FIT_ROWS)]) == 0
    out = capsys.readouterr().out
    assert f"constants {COST_CONSTANTS}: geometric mean" in out
    assert "was not measured" not in out
    with pytest.raises(SystemExit):
        tile_sweep.main([])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", tile_sweep.CASES_3D)
def test_sweep_tiles_3d_fit_and_hold_the_pick(case, dtype):
    """``--dims 3``: the 3D chooser's candidates at cfg3's and cfg4's
    shapes, clamped, that fit at the dtype's item size, its pick among
    them; 2-byte windows let more (and wider) tiles fit."""
    from stencil_tpu_torch.ops import tiled

    name, shape, k, t0_fixed = case
    spec = get_spec(name)
    itemsize = 2 if dtype == "bfloat16" else 4
    tiles = tile_sweep.sweep_tiles(name, shape, k, t0_fixed, dtype)
    assert tiled.choose_tiles(spec, shape, k, t0_fixed, dtype) in tiles
    assert all(len(t) == 3 for t in tiles)
    assert all(_smem_bytes(t, k, spec.radius, itemsize) <= SMEM_LIMIT
               for t in tiles)
    if dtype == "bfloat16":
        assert len(tiles) > len(tile_sweep.sweep_tiles(name, shape, k,
                                                       t0_fixed))


def test_cli_takes_dims_and_dtype(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        tile_sweep.main(["--dims", "3", "--dtype", "bfloat16", "--out",
                         str(tmp_path / "rows3d.csv")])
    with pytest.raises(SystemExit):
        tile_sweep.main(["--dims", "4", "--out", str(tmp_path / "x.csv")])
