"""The card's resource model (stencil_tpu_torch/device_model.py) and the
tuner's hardening that rides on it, the counterpart of
tests/test_device_model.py.

The contract under test:
  - on the CPU, and for an H100's properties, every budget equals the
    literal the plans were fitted with (shared memory 232,448 bytes per
    block and 233,472 per SM, 132 SMs, 2048 threads per SM, 50 MiB of L2),
    and every plan on the shapes PERF.md section 4 runs is the one the
    chooser made before the budgets moved into device_model.py;
  - plans made under a simulated 48, 100 and 164 KB of shared memory
    (``STENCIL_TPU_SMEM_KB``) fit it, and their plain versions match the
    eager iterate (atol 1e-6) and the float64 golden (5e-6);
  - rma's residency budget follows the card's L2;
  - the tuner measures twice as many candidates off the card the cost
    models were fitted on, and ``force`` warns of drift;
  - the CLI records the plan it ran and where it came from.
"""

import dataclasses
import types

import numpy as np
import pytest

from stencil_tpu import autotune as jautotune
from stencil_tpu.config import parse_args as jparse_args
from stencil_tpu_torch import autotune, cli, device_model
from stencil_tpu_torch.config import RunConfig, parse_args
from stencil_tpu_torch.core.grid import HaloGrid
from stencil_tpu_torch.core.spec import get_spec, star
from stencil_tpu_torch.models.wave import WaveEquation
from stencil_tpu_torch.multigrid import nbsum_spec, wjacobi_spec
from stencil_tpu_torch.ops import eager, golden
from stencil_tpu_torch.ops import slab as slab_mod
from stencil_tpu_torch.ops import tiled as tiled_mod
from stencil_tpu_torch.ops.slab import SlabStencil, make_slab_plan
from stencil_tpu_torch.ops.tiled import TiledStencil, make_tiled_plan
from stencil_tpu_torch.parallel import rma
from stencil_tpu_torch.parallel.sharded_kernel import ShardedKernelStencil

MIB = 1024 * 1024
H100_NAME = "NVIDIA H100 80GB HBM3"


def _props(name, **fields):
    """A stand-in for ``torch.cuda.get_device_properties``' record."""
    return types.SimpleNamespace(name=name, **fields)


H100_PROPS = dict(shared_memory_per_block_optin=232_448,
                  shared_memory_per_multiprocessor=233_472,
                  multi_processor_count=132,
                  max_threads_per_multi_processor=2048,
                  L2_cache_size=50 * MIB)


def test_budgets_on_the_cpu_are_the_h100_literals(monkeypatch):
    monkeypatch.delenv(device_model.SMEM_ENV, raising=False)
    b = device_model.budgets()
    assert b == device_model.H100 == device_model.budgets("cpu")
    assert (b.smem_per_block, b.smem_per_sm, b.smem_reserved, b.sm_count,
            b.threads_per_sm, b.l2_bytes) == (
        232_448, 233_472, 1024, 132, 2048, 50 * MIB)
    # the names the plan modules keep are the same literals
    assert tiled_mod.SMEM_LIMIT == slab_mod.SMEM_LIMIT == 232_448
    assert rma.SHARED_PER_BLOCK == 232_448
    assert rma.H100_L2_BYTES == 50 * 2 ** 20 == rma.l2_budget("cpu")
    # the cost models' resident blocks: 2048 threads over 512 (tiled and
    # slab windows) or 1024 (rma)
    assert b.threads_per_sm // tiled_mod.WINDOW_THREADS == 4
    assert b.threads_per_sm // rma.THREADS == 2


def test_an_h100s_properties_give_the_literals():
    assert device_model.from_properties(_props(H100_NAME, **H100_PROPS)) \
        == device_model.H100
    # a field torch does not report comes from the kind table
    partial = {k: v for k, v in H100_PROPS.items() if k != "L2_cache_size"}
    got = device_model.from_properties(_props("NVIDIA A100-SXM4-80GB",
                                              **partial))
    assert got.l2_bytes == 40 * MIB and got.sm_count == 132


def test_kind_table():
    assert device_model.kind_budgets(H100_NAME) == device_model.H100
    assert device_model.kind_budgets("NVIDIA H100 PCIe").sm_count == 114
    a100 = device_model.kind_budgets("NVIDIA A100-SXM4-80GB")
    assert (a100.smem_per_block, a100.sm_count, a100.l2_bytes) == (
        166_912, 108, 40 * MIB)
    assert device_model.kind_budgets("some other card") == device_model.H100
    for _, b in device_model.BUDGETS_BY_KIND:
        assert b.smem_per_sm == b.smem_per_block + b.smem_reserved


def test_env_override_drives_shared_memory(monkeypatch):
    monkeypatch.setenv(device_model.SMEM_ENV, "48")
    b = device_model.budgets()
    assert b.smem_per_block == 48 * 1024
    assert b.smem_per_sm == 48 * 1024 + 1024
    assert b.l2_bytes == device_model.H100.l2_bytes
    monkeypatch.delenv(device_model.SMEM_ENV)
    assert device_model.budgets() == device_model.H100


# ---- every plan on PERF.md section 4's shapes, frozen before the move ----

_CHEB = (0.5, 0.25, 0.0, 0.1)


def _spec(name):
    return {"star3d_r1": lambda: star(3, 1), "star2d_r1": lambda: star(2, 1),
            "nbsum3d": lambda: nbsum_spec(3),
            "wjacobi3d": lambda: wjacobi_spec(3, 6.0 / 7.0),
            "wave3d": lambda: WaveEquation((8, 8, 8), device="cpu").spec,
            }.get(name, lambda: get_spec(name))()


# (spec, shape, dtype, k, plan options) -> (tiles, schedule, shared bytes)
TILED_PLANS = [
    ("jacobi7", (256, 256, 256), "float32", 8, {},
     ((128, 32, 32), "march", 217856)),
    ("jacobi7", (256, 256, 256), "float32", 1, {},
     ((32, 64, 64), "march", 69696)),
    ("jacobi7", (256, 256, 256), "float32", 2, {},
     ((32, 64, 64), "march", 143680)),
    ("jacobi7", (256, 256, 256), "float32", 4, {},
     ((64, 32, 64), "march", 163712)),
    ("jacobi7", (256, 256, 256), "bfloat16", 8, {},
     ((64, 32, 64), "march", 192896)),
    ("laplace3d_ho", (384, 384, 384), "float32", 4, {},
     ((128, 24, 48), "march", 191232)),
    ("laplace3d_ho", (384, 384, 384), "bfloat16", 4, {},
     ((64, 48, 48), "march", 162432)),
    ("jacobi7", (256, 256, 1024), "float32", 8, {},
     ((256, 32, 32), "march", 217856)),
    ("jacobi7", (257, 257, 257), "float32", 8, {},
     ((64, 24, 32), "march", 175872)),
    ("jacobi27", (256, 256, 256), "float32", 8, {},
     ((128, 32, 32), "march", 217856)),
    ("jacobi7", (57, 50, 46), "float32", 3, {}, ((8, 8, 24), "march", 16256)),
    ("jacobi7", (512, 512, 1024), "float32", 8, {},
     ((256, 32, 32), "march", 217856)),
    ("jacobi7", (64, 64, 128), "float32", 2, {},
     ((8, 8, 64), "march", 23616)),
    ("star3d_r1", (256, 256, 256), "float32", 8, {"has_source": True},
     ((128, 32, 32), "march", 217856)),
    ("star3d_r1", (256, 256, 256), "bfloat16", 8, {"has_source": True},
     ((64, 32, 64), "march", 192896)),
    ("star3d_r1", (128, 128, 256), "float32", 8, {"has_source": True},
     ((32, 32, 32), "march", 217856)),
    ("wjacobi3d", (255, 255, 255), "float32", 4, {"has_source": True},
     ((64, 32, 64), "march", 163712)),
    ("wave3d", (256, 256, 256), "float32", 8, {"two_level": True},
     ((64, 24, 32), "march", 219840)),
    ("wave3d", (256, 256, 256), "float32", 1, {"two_level": True},
     ((16, 16, 32), "window", 44064)),
    ("wave3d", (256, 256, 256), "bfloat16", 8, {"two_level": True},
     ((128, 32, 32), "march", 136160)),
    ("nbsum3d", (255, 255, 255), "float32", 2, {"cheby": 2},
     ((32, 64, 64), "march", 179600)),
    ("nbsum3d", (255, 255, 255), "float32", 3,
     {"cheby": 3, "cheby_dual": True}, ((64, 32, 64), "march", 147040)),
    ("nbsum3d", (255, 255, 255), "float32", 4, {"cheby": 4},
     ((64, 32, 64), "march", 204640)),
    ("nbsum3d", (255, 255, 255), "float32", 5,
     {"cheby": 5, "cheby_dual": True}, ((128, 32, 32), "march", 145200)),
    ("nbsum3d", (63, 63, 63), "float32", 3,
     {"cheby": 3, "cheby_dual": True}, ((8, 16, 16), "march", 24160)),
    ("nbsum3d", (255, 255, 255), "float32", 1, {"cheby": 1},
     ((16, 16, 32), "window", 44064)),
    ("jacobi7", (256, 256, 256), "float32", 8,
     {"coeff_scales": (0.1, 1.0, -0.1)}, ((128, 32, 32), "march", 217856)),
    ("jacobi7", (255, 255, 255), "float32", 1,
     {"coeff_scales": (0.1, 1.0, -0.1)}, ((32, 64, 64), "march", 69696)),
    ("jacobi7", (256, 256, 256), "float32", 8, {"schedule": "window"},
     ((8, 16, 16), "window", 196608)),
    ("jacobi7", (256, 256, 256), "float32", 8, {"t0_fixed": 32},
     ((32, 32, 32), "march", 217856)),
]

SLAB_PLANS = [
    ("jacobi5", (512, 512), "float32", 16, {}, ((32, 64), "window", 49152)),
    ("jacobi5", (512, 512), "bfloat16", 16, {}, ((32, 64), "window", 24576)),
    ("jacobi9", (4096, 4096), "float32", 4, {"t0_fixed": 256},
     ((256, 184), "march", 19328)),
    ("star2d_r1", (4096, 4096), "float32", 8, {},
     ((32, 112), "window", 49152)),
    ("star2d_r1", (63, 63), "float32", 8, {}, ((8, 63), "march", 19712)),
    ("star2d_r1", (4096, 4096), "bfloat16", 8, {},
     ((64, 112), "window", 40960)),
    ("star2d_r2", (250, 333), "float32", 3, {"t0_fixed": 16},
     ((16, 244), "march", 25472)),
    ("jacobi5", (512, 512), "float32", 4, {}, ((8, 184), "march", 19328)),
    ("jacobi5", (1024, 1024), "float32", 8, {},
     ((16, 176), "window", 49152)),
]

# (local shape, ranks, k, r, itemsize) -> the rma tile
RMA_TILES = [
    (((64, 64, 128), 1, 2, 1, 4), (8, 8, 64)),
    (((32, 32, 128), 4, 2, 1, 4), (8, 8, 64)),
    (((64, 64, 128), 4, 2, 1, 4), (16, 16, 64)),
    (((160, 160, 160), 1, 2, 1, 2), (32, 32, 32)),
    (((8, 8, 16), 1, 2, 1, 4), (1, 1, 16)),
    (((64, 64, 128), 2, 2, 2, 4), (8, 16, 64)),
]

SHARDED_PLANS = [
    ("jacobi7", (1024, 1024, 1024), ("x", "y"), (2, 2), 8,
     ((128, 32, 32), "march", 217856)),
    ("jacobi7", (256, 256, 256), ("x", "y"), (2, 2), 8,
     ((32, 32, 32), "march", 217856)),
    ("jacobi7", (256, 128, 128), ("x",), (4,), 4,
     ((8, 32, 32), "march", 87936)),
]


def _summary(plan):
    return tuple(plan.tiles), plan.schedule, plan.smem_bytes


@pytest.mark.parametrize("name,shape,dtype,k,options,want", TILED_PLANS)
def test_tiled_plans_unchanged(monkeypatch, name, shape, dtype, k, options,
                               want):
    monkeypatch.delenv(device_model.SMEM_ENV, raising=False)
    options = dict(options)
    if "cheby" in options:
        options["cheby_coeffs"] = (_CHEB,) * options.pop("cheby")
        options["has_source"] = True
    plan = make_tiled_plan(_spec(name), shape, dtype, k, **options)
    assert _summary(plan) == want


@pytest.mark.parametrize("name,shape,dtype,k,options,want", SLAB_PLANS)
def test_slab_plans_unchanged(monkeypatch, name, shape, dtype, k, options,
                              want):
    monkeypatch.delenv(device_model.SMEM_ENV, raising=False)
    plan = make_slab_plan(_spec(name), shape, dtype, k, **options)
    assert _summary(plan) == want


@pytest.mark.parametrize("args,want", RMA_TILES)
def test_rma_tiles_unchanged(monkeypatch, args, want):
    monkeypatch.delenv(device_model.SMEM_ENV, raising=False)
    assert rma.choose_rma_tile(*args) == want


@pytest.mark.parametrize("name,shape,axes,mesh,k,want", SHARDED_PLANS)
def test_sharded_local_plans_unchanged(monkeypatch, name, shape, axes, mesh,
                                       k, want):
    monkeypatch.delenv(device_model.SMEM_ENV, raising=False)
    method = ShardedKernelStencil(get_spec(name), shape, axis_names=axes,
                                  sweeps_per_call=k)
    assert _summary(method.local_plan(mesh)) == want


# ---- plans under a simulated shared memory --------------------------------


def _random_grid(shape, radius, seed=0):
    data = np.random.default_rng(seed).random(shape).astype(np.float32)
    import torch

    return HaloGrid.from_interior(torch.from_numpy(data), halo=radius,
                                  device="cpu")


@pytest.mark.parametrize("kb", [48, 100, 164])
@pytest.mark.parametrize("k", [2, 4])
def test_tiled_plans_under_simulated_shared_memory(monkeypatch, kb, k):
    """Chosen plans fit the simulated per-block shared memory, take the
    tiles a smaller card allows, and their plain version matches the
    eager iterate and the golden."""
    monkeypatch.setenv(device_model.SMEM_ENV, str(kb))
    spec, shape = get_spec("jacobi7"), (16, 24, 20)
    m = TiledStencil(spec, shape, sweeps_per_call=k, device="cpu")
    assert m.plan.smem_bytes <= kb * 1024
    big = make_tiled_plan(spec, (256, 256, 256), "float32", k)
    assert big.smem_bytes <= kb * 1024
    grid = _random_grid(shape, spec.radius)
    out = m.iterate(grid, 2 * k + 1)
    want = eager.iterate(grid, spec, 2 * k + 1)
    np.testing.assert_allclose(out.interior().numpy(),
                               want.interior().numpy(), atol=1e-6, rtol=0)
    ref = golden.golden_iterate(grid.interior().double().numpy(), spec,
                                2 * k + 1, bc=grid.bc)
    np.testing.assert_allclose(out.interior().double().numpy(), ref,
                               atol=5e-6, rtol=5e-6)


@pytest.mark.parametrize("kb", [48, 100, 164])
def test_slab_plans_under_simulated_shared_memory(monkeypatch, kb):
    monkeypatch.setenv(device_model.SMEM_ENV, str(kb))
    spec, shape = get_spec("jacobi5"), (32, 40)
    m = SlabStencil(spec, shape, sweeps_per_call=2, device="cpu")
    assert m.plan.smem_bytes <= kb * 1024
    big = make_slab_plan(spec, (4096, 4096), "float32", 8)
    assert big.smem_bytes <= kb * 1024
    grid = _random_grid(shape, spec.radius, seed=1)
    out = m.iterate(grid, 5)
    want = eager.iterate(grid, spec, 5)
    np.testing.assert_allclose(out.interior().numpy(),
                               want.interior().numpy(), atol=1e-6, rtol=0)


def test_simulated_shared_memory_moves_the_plan(monkeypatch):
    """At 48 KB jacobi7 256^3 k=8 cannot keep its 213 KB rings: the
    chooser takes rings that fit, and a window plan, whose k=8 window is
    larger than 48 KB at any tile, is refused with the budget's size."""
    spec = get_spec("jacobi7")
    monkeypatch.setenv(device_model.SMEM_ENV, "48")
    plan = make_tiled_plan(spec, (256, 256, 256), "float32", 8)
    assert plan.schedule == "march" and plan.smem_bytes <= 48 * 1024
    assert plan.tiles != (128, 32, 32)
    with pytest.raises(ValueError, match="49152 bytes of shared memory"):
        make_tiled_plan(spec, (256, 256, 256), "float32", 8,
                        schedule="window")


def test_rma_budget_follows_the_l2(monkeypatch):
    """A block that fits an H100's 50 MiB of L2 refuses on a card with
    40 MiB, with JAX's message; the budget is read from the card."""
    spec = get_spec("jacobi7")
    plan = rma.make_rma_plan(spec, (152, 152, 152), "float32", (1,), 2,
                             budget=rma.l2_budget("cpu"))
    assert 40 * MIB < plan.resident_bytes <= 50 * MIB
    a100 = device_model.kind_budgets("NVIDIA A100-SXM4-80GB")
    monkeypatch.setattr(device_model, "_cuda_index", lambda device: 0)
    monkeypatch.setattr(device_model, "_detected", lambda index: a100)
    assert rma.l2_budget("cuda") == 40 * MIB
    with pytest.raises(ValueError, match="L2-resident budget"):
        rma.make_rma_plan(spec, (152, 152, 152), "float32", (1,), 2,
                          budget=rma.l2_budget("cuda"))


# ---- the tuner's hardening ------------------------------------------------


def test_candidate_limit_widens_off_fitted_kind():
    assert autotune._default_limit(f"cuda:{H100_NAME}") == 4
    assert autotune._default_limit("cuda:NVIDIA H100 PCIe") == 8
    assert autotune._default_limit("cuda:NVIDIA A100-SXM4-80GB") == 8
    assert autotune._default_limit("cpu:cpu") == 4  # not a tune target
    # JAX's rule, kind for kind
    assert jautotune._default_limit("tpu:TPU v4") == 8
    assert jautotune._default_limit("cpu:cpu") == 4


def test_candidates_widened_head():
    spec = get_spec("jacobi7")
    narrow = autotune.candidates(spec, (256, 256, 256), "float32", 8,
                                 limit=4)
    wide = autotune.candidates(spec, (256, 256, 256), "float32", 8,
                               limit=8)
    assert len(wide) >= 8 > len(narrow)
    # the widened set is a superset: ranked heads extend, never reshuffle
    assert set(narrow) <= set(wide)
    for schedule in ("march", "window"):
        head = [c for c in narrow if c[1] == schedule]
        assert [c for c in wide if c[1] == schedule][:len(head)] == head


def test_autotune_force_warns_on_drift(tmp_path, capsys):
    spec = get_spec("jacobi7")
    path = str(tmp_path / "cache.json")
    shape, dtype, k = (32, 32, 32), "float32", 2

    autotune.autotune(spec, shape, dtype, k, cache_path=path,
                      measure_fn=lambda t, s: 100.0)
    first = autotune.lookup(spec, shape, dtype, k, cache_path=path)
    assert first is not None and first["glups"] == 100.0

    # a plain call trusts the cache (no measurement)
    hit = autotune.autotune(spec, shape, dtype, k, cache_path=path,
                            measure_fn=lambda t, s: 1 / 0)
    assert hit == first
    capsys.readouterr()

    # force measures again; a move past 5% warns and updates the cache
    out = autotune.autotune(spec, shape, dtype, k, cache_path=path,
                            measure_fn=lambda t, s: 50.0, force=True)
    assert out["glups"] == 50.0
    assert "CACHE DRIFT" in capsys.readouterr().err
    assert autotune.lookup(spec, shape, dtype, k,
                           cache_path=path)["glups"] == 50.0
    # within 5% and the same plan: no warning
    autotune.autotune(spec, shape, dtype, k, cache_path=path,
                      measure_fn=lambda t, s: 51.0, force=True)
    assert "CACHE DRIFT" not in capsys.readouterr().err


def test_cli_autotune_flag_parsing():
    for argv in (["-s", "32", "-i", "1"], ["-s", "32", "-i", "1",
                                           "--autotune"],
                 ["-s", "32", "-i", "1", "--autotune", "force"]):
        assert parse_args(argv).autotune == jparse_args(argv).autotune
    assert parse_args(["-s", "32", "-i", "1"]).autotune is False
    assert parse_args(["-s", "32", "-i", "1", "--autotune"]).autotune == "on"
    assert parse_args(["-s", "32", "-i", "1", "--autotune",
                       "force"]).autotune == "force"


def test_cli_records_applied_plan():
    """The CLI's record says what plan a tiled run used (tiles, schedule,
    source) so that an autotuned run is told apart from the chooser's."""
    cfg = RunConfig(size=(16, 16, 20), spec="jacobi7", iterations=4,
                    temporal=2, methods=("pallas_temporal",), device="cpu")
    (rec,) = cli.run_all(cfg)
    plan = rec["plan"]
    assert plan["kernel"] == "tiled" and plan["source"] == "chooser"
    assert len(plan["tiles"]) == 3 and plan["k"] == 2
    assert plan["schedule"] in ("march", "window")
    assert "autotune_glups" not in plan
    want = make_tiled_plan(get_spec("jacobi7"), (16, 16, 20), "float32", 2)
    assert (tuple(plan["tiles"]), plan["schedule"]) == (want.tiles,
                                                        want.schedule)
    assert dataclasses.asdict(cfg)["autotune"] is False
