"""The plan tuner (stencil_tpu_torch/autotune.py) on the CPU, the
counterpart of tests/test_autotune.py: the measurement is injected (the
on-card search runs through ``--autotune`` in chip_smoke.py and committed
``data/autotune_h100.json``). Candidates are feasible and led by each
chooser's pick; the cache round-trips, JAX's files included; keys equal
JAX's apart from the device kind; the registry and the Poisson runner apply
a winner, bitwise the chooser's run; ``--autotune`` parses as in JAX.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from stencil_tpu import autotune as jautotune
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu.core.spec import get_spec as jget_spec
from stencil_tpu.models.poisson import PoissonProblem as JPoissonProblem
from stencil_tpu_torch import autotune, cli, device_model, registry
from stencil_tpu_torch.config import RunConfig, parse_args
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.ops.tiled import (
    _smem_bytes, choose_march_tiles, choose_tiles, make_tiled_plan,
    march_fits,
)

H100_KIND = "cuda:NVIDIA H100 80GB HBM3"


def _feasible(spec, shape, dtype, k, tiles, schedule):
    item = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    limit = device_model.budgets().smem_per_block
    if schedule == "march":
        return march_fits(tiles, k, spec.radius, item)
    return _smem_bytes(tiles, k, spec.radius, item) <= limit


@pytest.mark.parametrize("name,shape,dtype,k", [
    ("jacobi7", (256, 256, 256), "float32", 8),
    ("jacobi7", (256, 256, 256), "float32", 1),
    ("laplace3d_ho", (384, 384, 384), "float32", 4),
])
def test_candidates_are_feasible_and_ranked(name, shape, dtype, k):
    spec = get_spec(name)
    cands = autotune.candidates(spec, shape, dtype, k)
    assert len(cands) == 4 and len(set(cands)) == 4
    assert {s for _, s in cands} == {"march", "window"}
    for tiles, schedule in cands:
        assert _feasible(spec, shape, dtype, k, tiles, schedule)
    # each schedule's head is its chooser's pick, and the first candidate
    # is the plan made without tuning
    assert next(t for t, s in cands if s == "march") == \
        choose_march_tiles(spec, shape, k, dtype=dtype)
    assert next(t for t, s in cands if s == "window") == \
        choose_tiles(spec, shape, k, dtype=dtype)
    plan = make_tiled_plan(spec, shape, dtype, k)
    assert cands[0] == (plan.tiles, plan.schedule)


def test_radius2_candidates_cover_both_schedules():
    """cfg4 (laplace3d_ho 384^3 k=4, bench.py:84-86): both schedules'
    heads, every candidate a plan the kernel takes."""
    spec = get_spec("laplace3d_ho")
    cands = autotune.candidates(spec, (384, 384, 384), "float32", 4)
    for tiles, schedule in cands:
        plan = make_tiled_plan(spec, (384, 384, 384), "float32", 4,
                               tiles=tiles, schedule=schedule)
        assert plan.schedule == schedule and plan.tiles == tiles
    assert cands[0] == ((128, 24, 48), "march")


def test_bf16_candidates_fit_two_byte_plans():
    spec = get_spec("jacobi7")
    cands = autotune.candidates(spec, (256, 256, 256), "bfloat16", 8)
    assert cands
    for tiles, schedule in cands:
        assert _feasible(spec, (256, 256, 256), "bfloat16", 8, tiles,
                         schedule)
        plan = make_tiled_plan(spec, (256, 256, 256), "bfloat16", 8,
                               tiles=tiles, schedule=schedule)
        assert plan.itemsize == 2


def test_autotune_measures_caches_and_reuses(tmp_path):
    spec = get_spec("jacobi7")
    cache = str(tmp_path / "tune.json")
    calls = []

    def fake_measure(tiles, schedule):
        calls.append((tuple(tiles), schedule))
        # the last candidate wins, so the measurement decides
        return 50.0 + len(calls)

    win = autotune.autotune(spec, (64, 64, 64), "float32", 4,
                            cache_path=cache, measure_fn=fake_measure)
    cands = autotune.candidates(spec, (64, 64, 64), "float32", 4)
    assert calls == cands
    assert win == {"tiles": list(cands[-1][0]), "schedule": cands[-1][1],
                   "glups": 54.0}
    stored = json.load(open(cache))
    assert len(stored) == 1
    key = next(iter(stored))
    assert key == "cpu:cpu|jacobi7|r1|64x64x64|float32|k4"
    # second call: served from the cache, measure_fn not called
    n_calls = len(calls)
    win2 = autotune.autotune(spec, (64, 64, 64), "float32", 4,
                             cache_path=cache, measure_fn=fake_measure)
    assert win2 == win and len(calls) == n_calls


def test_autotune_survives_failing_candidates(tmp_path, capsys):
    spec = get_spec("jacobi7")

    def flaky(tiles, schedule):
        if schedule == "march":
            raise RuntimeError("rings overflow")
        return 42.0

    win = autotune.autotune(spec, (64, 64, 64), "float32", 4,
                            cache_path=str(tmp_path / "t.json"),
                            measure_fn=flaky)
    assert win is not None and win["schedule"] == "window"
    assert "failed: rings overflow" in capsys.readouterr().err


def test_autotune_all_fail_returns_none(tmp_path):
    def broken(tiles, schedule):
        raise RuntimeError("no")

    path = tmp_path / "t.json"
    win = autotune.autotune(get_spec("jacobi7"), (64, 64, 64), "float32",
                            4, cache_path=str(path), measure_fn=broken)
    assert win is None and not path.exists()


def test_cli_flag_parses():
    cfg = parse_args(["-s", "64", "64", "64", "--autotune"])
    assert cfg.autotune == "on"
    assert parse_args(["-s", "64", "64"]).autotune is False
    assert jparse_args(["-s", "64", "64", "64", "--autotune"]).autotune \
        == cfg.autotune
    # no longer a TPU flag recorded as ignored
    assert "autotune" not in cfg.ignored_tpu_flags()


WINNER = {"tiles": [8, 16, 20], "schedule": "window", "glups": 1.0}


def _on_card(monkeypatch, winner=WINNER):
    """Fake a card for the registry's and the runner's gate and the
    search's result; the runs stay on the CPU's plain versions."""
    calls = []

    def fake(*args, **kw):
        calls.append((args, kw))
        return dict(winner)

    monkeypatch.setattr(autotune, "tunes_on", lambda device: True)
    monkeypatch.setattr(autotune, "autotune", fake)
    return calls


def test_registry_applies_autotuned_winner(monkeypatch):
    """--autotune plumbing: the registry applies the winner's tiles and
    schedule, records where they came from, and the run is bitwise the
    chooser's."""
    calls = _on_card(monkeypatch)
    cfg = RunConfig(size=(16, 48, 20), spec="jacobi7", temporal=2,
                    autotune=True, methods=("pallas_temporal",),
                    device="cpu")
    spec = cfg.resolved_spec()
    grid = cli.make_grid(cfg, spec)
    runner = registry.get_runner("pallas_temporal", cfg, spec, grid)
    assert "8x16x20" in runner.name and len(calls) == 1
    assert calls[0][0][1:] == ((16, 48, 20), "float32", 2)
    info = runner.plan_info
    assert info["source"] == "autotune" and info["autotune_glups"] == 1.0
    assert info["tiles"] == [8, 16, 20] and info["schedule"] == "window"
    assert "ignored" not in info
    pinned = registry.get_runner(
        "pallas_temporal", RunConfig(size=(16, 48, 20), spec="jacobi7",
                                     temporal=2, device="cpu"), spec, grid)
    assert pinned.plan_info["source"] == "chooser"
    assert pinned.plan_info["schedule"] == "march"
    rng = np.random.default_rng(0)
    grid.interior().copy_(torch.from_numpy(
        rng.random((16, 48, 20)).astype(np.float32)))
    assert torch.equal(runner.iterate(grid, 7).data,
                       pinned.iterate(grid, 7).data)


def test_block_flag_wins_over_autotune(monkeypatch):
    calls = _on_card(monkeypatch)
    cfg = RunConfig(size=(16, 48, 20), spec="jacobi7", temporal=2, block=4,
                    autotune="force", methods=("pallas_temporal",),
                    device="cpu")
    spec = cfg.resolved_spec()
    runner = registry.get_runner("pallas_temporal", cfg, spec,
                                 cli.make_grid(cfg, spec))
    assert not calls and runner.plan_info["source"] == "flag"
    assert runner.plan_info["tiles"][0] == 4


def test_dynamic_lane_dim_skips_autotune(monkeypatch, capsys):
    calls = _on_card(monkeypatch)
    cfg = RunConfig(size=(16, 12, 20), spec="jacobi7", temporal=1,
                    autotune=True, periodic=("2",),
                    methods=("pallas_tiled",), device="cpu")
    spec = cfg.resolved_spec()
    runner = registry.get_runner("pallas_tiled", cfg, spec,
                                 cli.make_grid(cfg, spec))
    assert not calls and runner.plan_info["source"] == "chooser"
    assert "--autotune skipped" in capsys.readouterr().err


def test_autotune_on_the_cpu_keeps_the_chooser(monkeypatch, capsys):
    """Without a card the chooser's plan applies, and nothing is
    measured; a 2D grid says nothing on the CPU."""
    monkeypatch.setattr(autotune, "autotune", lambda *a, **k: 1 / 0)
    for size in ((16, 48, 20), (24, 40)):
        cfg = RunConfig(size=size, spec="jacobi7" if len(size) == 3
                        else "jacobi5", temporal=2, autotune="on",
                        methods=("pallas_temporal",), device="cpu")
        spec = cfg.resolved_spec()
        runner = registry.get_runner("pallas_temporal", cfg, spec,
                                     cli.make_grid(cfg, spec))
        assert runner.plan_info["source"] == "chooser"
        assert "ignored" not in runner.plan_info
    assert capsys.readouterr().err == ""


def test_2d_grid_keeps_pinned_defaults_on_the_card(monkeypatch, capsys):
    calls = _on_card(monkeypatch)
    cfg = RunConfig(size=(24, 40), spec="jacobi5", temporal=2,
                    autotune="on", methods=("pallas_temporal",),
                    device="cpu")
    spec = cfg.resolved_spec()
    runner = registry.get_runner("pallas_temporal", cfg, spec,
                                 cli.make_grid(cfg, spec))
    assert not calls and runner.plan_info["kernel"] == "slab"
    assert "2D slab path uses pinned defaults" in capsys.readouterr().err


def test_source_cache_key_distinct():
    spec = get_spec("jacobi7")
    a = autotune.cache_key(spec, (64, 64, 64), "float32", 8, "cuda:X")
    b = autotune.cache_key(spec, (64, 64, 64), "float32", 8, "cuda:X",
                           has_source=True)
    assert a != b and b.endswith("|src") and not a.endswith("|src")


@pytest.mark.parametrize("name,shape,dtype,k,src", [
    ("jacobi7", (256, 256, 256), "float32", 8, False),
    ("laplace3d_ho", (384, 384, 384), "float32", 4, False),
    ("jacobi7", (64, 48, 80), "bfloat16", 2, True),
])
def test_keys_equal_jax_apart_from_the_kind(name, shape, dtype, k, src):
    for kind in ("X", H100_KIND):
        assert autotune.cache_key(get_spec(name), shape, dtype, k, kind,
                                  src) == \
            jautotune.cache_key(jget_spec(name), shape, dtype, k, kind, src)
    # the kind on the CPU is JAX's on its CPU backend
    assert autotune._device_kind() == jautotune._device_kind() == "cpu:cpu"


def test_poisson_key_equals_jax():
    """The source key of bench.py:161 (Poisson 256^3 k=8)."""
    spec = PoissonProblem(shape=(256, 256, 256), device="cpu").spec
    jspec = JPoissonProblem(shape=(256, 256, 256)).spec
    want = f"{H100_KIND}|star3d_r1|r1|256x256x256|float32|k8|src"
    assert autotune.cache_key(spec, (256,) * 3, "float32", 8, H100_KIND,
                              True) == want
    assert jautotune.cache_key(jspec, (256,) * 3, "float32", 8, H100_KIND,
                               True) == want


def test_cache_round_trips_with_jax(tmp_path):
    """A cache written by JAX's save_cache loads here, and ours there."""
    cache = {"tpu:TPU v5 lite|jacobi7|r1|256x256x256|float32|k8":
             {"tiles": [64, 64], "tap_mode": "rotacc", "slide": False,
              "glups": 98.6},
             f"{H100_KIND}|jacobi7|r1|256x256x256|float32|k8":
             {"tiles": [128, 32, 32], "schedule": "march", "glups": 110.5}}
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jautotune.save_cache(jpath, cache)
    assert autotune.load_cache(jpath) == cache
    autotune.save_cache(tpath, cache)
    assert jautotune.load_cache(tpath) == cache == autotune.load_cache(tpath)
    assert not (tmp_path / "t.json.tmp").exists()
    assert autotune.load_cache(str(tmp_path / "missing.json")) == {}
    (tmp_path / "bad.json").write_text("{")
    assert autotune.load_cache(str(tmp_path / "bad.json")) == {}


def test_source_candidates_equal_homogeneous():
    """The port's plans give a source no shared memory, so a source plan
    has the homogeneous plan's candidates (JAX's source plans drop slide
    instead): the first is the source plan made without tuning."""
    spec = get_spec("laplace3d_ho")
    cands = autotune.candidates(spec, (64, 64, 64), "float32", 2)
    plan = make_tiled_plan(spec, (64, 64, 64), "float32", 2,
                           has_source=True)
    assert cands[0] == (plan.tiles, plan.schedule)
    for tiles, schedule in cands:
        plans = [make_tiled_plan(spec, (64, 64, 64), "float32", 2,
                                 tiles=tiles, schedule=schedule,
                                 has_source=src) for src in (False, True)]
        assert plans[0].smem_bytes == plans[1].smem_bytes


def test_source_autotune_caches_under_src_key(tmp_path):
    spec = get_spec("jacobi7")
    path = str(tmp_path / "cache.json")
    calls = []

    def fake_measure(tiles, schedule):
        calls.append((tuple(tiles), schedule))
        return 100.0 - tiles[0]  # the shortest chunk wins

    won = autotune.autotune(spec, (64, 64, 64), "float32", 4,
                            cache_path=path, measure_fn=fake_measure,
                            has_source=True)
    assert won is not None and won["tiles"][0] == min(t[0] for t, _ in calls)
    cache = autotune.load_cache(path)
    assert len(cache) == 1 and list(cache)[0].endswith("|src")
    # homogeneous tuning of the same configuration gets its own entry
    won2 = autotune.autotune(spec, (64, 64, 64), "float32", 4,
                             cache_path=path, measure_fn=fake_measure)
    assert won2 is not None and len(autotune.load_cache(path)) == 2


def test_poisson_runner_autotune_cache_hit(tmp_path, monkeypatch):
    """A cached source winner is applied to the Poisson tiled runner, and
    its run is bitwise the chooser's."""
    spec = get_spec("jacobi7")
    prob = PoissonProblem(shape=(16, 16, 16), device="cpu")
    path = str(tmp_path / "cache.json")
    key = autotune.cache_key(prob.spec, (16, 16, 16), "float32", 2,
                             autotune._device_kind("cpu"), has_source=True)
    autotune.save_cache(path, {key: {"tiles": [8, 8, 16],
                                     "schedule": "window", "glups": 1.0}})
    monkeypatch.setattr(autotune, "DEFAULT_CACHE", path)
    monkeypatch.setattr(autotune, "tunes_on", lambda device: True)
    won = autotune.autotune(prob.spec, (16, 16, 16), "float32", 2,
                            has_source=True, device="cpu")
    assert won["tiles"] == [8, 8, 16]
    f = np.random.default_rng(3).random((16, 16, 16)).astype(np.float32)
    r = prob.runner(f, method="pallas_tiled", sweeps_per_call=2,
                    autotune=True)
    assert r.plan_info["tiles"] == [8, 8, 16]
    assert r.plan_info["schedule"] == "window"
    assert r.plan_info["source"] == "autotune"
    assert r.plan_info["autotune_glups"] == 1.0
    pinned = prob.runner(f, method="pallas_tiled", sweeps_per_call=2)
    assert pinned.plan_info["schedule"] == "march"
    assert "source" not in pinned.plan_info
    g = prob.initial_grid()
    assert torch.equal(r.iterate(g, 5).data, pinned.iterate(g, 5).data)
    # -b (t0_fixed) wins, and the slab runner records nothing ignored
    assert "source" not in prob.runner(
        f, method="pallas_tiled", sweeps_per_call=2, autotune=True,
        t0_fixed=4).plan_info
    flat = PoissonProblem(shape=(8, 8), device="cpu")
    assert "ignored" not in flat.runner(np.zeros((8, 8)), method="slab",
                                        sweeps_per_call=2,
                                        autotune="force").plan_info
    assert spec.radius == 1


def test_committed_cache_holds_the_card_winners():
    """data/autotune_h100.json: cfg4, jacobi7 256^3 k=8 and the Poisson
    source key, each a plan the kernel takes; reading it writes nothing."""
    path = autotune.DEFAULT_CACHE
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    cache = autotune.load_cache(path)
    wanted = [("laplace3d_ho", (384, 384, 384), 4, False),
              ("jacobi7", (256, 256, 256), 8, False),
              ("star3d_r1", (256, 256, 256), 8, True)]
    for name, shape, k, src in wanted:
        spec = (PoissonProblem(shape=shape, device="cpu").spec if src
                else get_spec(name))
        won = cache[autotune.cache_key(spec, shape, "float32", k, H100_KIND,
                                       src)]
        assert set(won) == {"tiles", "schedule", "glups"}
        assert won["glups"] > 0
        plan = make_tiled_plan(spec, shape, "float32", k,
                               tiles=tuple(won["tiles"]),
                               schedule=won["schedule"], has_source=src)
        assert plan.schedule == won["schedule"]
        assert (tuple(won["tiles"]), won["schedule"]) in \
            autotune.candidates(spec, shape, "float32", k)
    assert all(key.startswith(H100_KIND + "|") for key in cache)
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == digest
