"""The out-of-core streamed method (stencil_tpu_torch/streaming.py) on the
CPU, the cases of tests/test_streaming.py: each held bitwise against the
port's in-core ``tiled`` method at the same k (the same kernel's plain
version, the same per-point arithmetic, every chunk reading the previous
outer iterate) and within the golden's tolerance against the float64
golden; a few against JAX's ``StreamedStencil(interpret=True)`` within the
same tolerance; the chunk geometry, the pins, the host-resident grid,
``auto_chunks``, the gates and the registry runner.

Tolerances: bitwise against ``tiled``; 5e-6 (fp32) and 3e-2 (bf16)
against the golden and against JAX, the reference suite's own bars."""

import numpy as np
import pytest
import torch

from stencil_tpu.core.grid import DirichletBC as JBC
from stencil_tpu.core.spec import get_spec as jget_spec
from stencil_tpu.streaming import StreamedStencil as JStreamed
from stencil_tpu.streaming import _chunk_bounds as jchunk_bounds
from stencil_tpu_torch import registry
from stencil_tpu_torch.config import RunConfig
from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
from stencil_tpu_torch.core.spec import get_spec, star, weighted
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.ops.tiled import TiledStencil
from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep
from stencil_tpu_torch.streaming import (
    StreamedStencil, _chunk_bounds, auto_chunks, host_halo_grid,
)

REF = DirichletBC.reference_default(3)


def initial(shape, dtype, bc, seed):
    if seed or all(bc.dynamic_mask(3)):
        x0 = np.random.default_rng(0).random(shape).astype(np.float32)
    else:
        x0 = np.zeros(shape, np.float32)
    return torch.from_numpy(x0).to(getattr(torch, dtype))


def check(spec, shape, k, chunks, iters, dtype="float32", bc=REF,
          seed=False, atol=5e-6):
    """Streamed vs tiled (bitwise) and vs the float64 golden."""
    x0 = initial(shape, dtype, bc, seed)
    m = StreamedStencil(spec, shape, dtype=dtype, sweeps_per_call=k,
                        chunks=chunks, device="cpu")
    before = tiled_sweep.launches
    out = m.iterate_host(x0, iters, bc=bc)
    assert tiled_sweep.launches == before  # the plain version, no launch
    assert out.device.type == "cpu" and out.dtype == x0.dtype
    grid = HaloGrid.from_interior(x0, halo=spec.radius, bc=bc,
                                  device="cpu")
    ref = TiledStencil(spec, shape, dtype=dtype, sweeps_per_call=k,
                       device="cpu").iterate(grid, iters)
    assert torch.equal(out, ref.interior())
    want = golden.golden_iterate(x0.double().numpy(), spec, iters, bc=bc)
    np.testing.assert_allclose(out.double().numpy(), want, atol=atol,
                               rtol=atol)
    return x0, out


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_dirichlet_star_chunks(chunks):
    check(get_spec("jacobi7"), (18, 16, 20), 1, chunks, iters=5)


@pytest.mark.parametrize("k", [2, 4])
def test_temporal_chunked(k):
    check(get_spec("jacobi7"), (24, 16, 20), k, 3, iters=2 * k, seed=True)


def test_box_corners_through_chunk_faces():
    check(get_spec("jacobi27"), (16, 16, 20), 2, 2, iters=4, seed=True)


def test_radius2_chunked():
    check(star(3, 2), (16, 16, 20), 2, 2, iters=4, seed=True)


def test_remainder_iterations():
    # 7 = 2 outer steps of k=3 and a remainder of 1
    check(get_spec("jacobi7"), (18, 16, 20), 3, 3, iters=7, seed=True)


def test_ragged_chunks_and_shape():
    # n0=19 over 3 chunks: 7/6/6, two plans
    m = StreamedStencil(get_spec("jacobi7"), (19, 13, 21),
                        sweeps_per_call=2, chunks=3, device="cpu")
    assert [b - a for a, b in m.bounds] == [7, 6, 6]
    assert m.plans[0] is not m.plans[1] and m.plans[1] is m.plans[2]
    check(get_spec("jacobi7"), (19, 13, 21), 2, 3, iters=4, seed=True)


def test_periodic_d0_through_chunks():
    bc = REF.with_periodic([0])
    check(get_spec("jacobi7"), (18, 16, 20), 2, 3, iters=4, bc=bc,
          seed=True)


@pytest.mark.parametrize("shape,chunks", [((18, 16, 20), 1),
                                          ((19, 13, 21), 3)])
def test_periodic_d0_wraps_in_the_staging_rows(shape, chunks):
    """The wrapped planes ride in the staging buffer's spare rows: one
    chunk holds both wraps, and a ragged shallower tail its own."""
    bc = REF.with_periodic([0])
    check(get_spec("jacobi7"), shape, 2, chunks, iters=4, bc=bc, seed=True)


def test_neumann_d0_and_periodic_d1():
    bc = REF.with_neumann([0]).with_periodic([1])
    check(get_spec("jacobi7"), (18, 16, 20), 2, 2, iters=4, bc=bc,
          seed=True)


def test_box_dynamic_corners_chunked():
    bc = REF.with_periodic([0]).with_neumann([1])
    check(get_spec("jacobi27"), (16, 16, 20), 2, 2, iters=4, bc=bc,
          seed=True)


def test_dynamic_lane_k1():
    bc = REF.with_periodic([2])
    check(get_spec("jacobi7"), (16, 16, 20), 1, 2, iters=4, bc=bc,
          seed=True)


def test_all_periodic_remainder():
    bc = DirichletBC.periodic_all(3)
    check(get_spec("jacobi7"), (12, 10, 9), 1, 3, iters=3, bc=bc)


def test_bf16_smoke():
    check(get_spec("jacobi7"), (16, 16, 20), 2, 2, iters=4,
          dtype="bfloat16", atol=3e-2, seed=True)


@pytest.mark.parametrize("shape,k,chunks,iters,bc", [
    ((12, 8, 16), 2, 3, 4, JBC.reference_default(3)),
    ((12, 8, 16), 2, 2, 5, JBC.reference_default(3).with_periodic([0])),
    ((12, 8, 16), 2, 2, 4,
     JBC.reference_default(3).with_neumann([0]).with_periodic([1]))])
def test_matches_jax_streamed(shape, k, chunks, iters, bc):
    """JAX's streamed method in interpret mode on the same seeded input:
    within the golden's tolerance (the same schedule; XLA may reassociate
    the interpreted kernel's sums)."""
    x0 = np.random.default_rng(2).random(shape).astype(np.float32)
    want = JStreamed(jget_spec("jacobi7"), shape, sweeps_per_call=k,
                     chunks=chunks, interpret=True).iterate_host(
                         x0, iters, bc=bc)
    tbc = DirichletBC(values=bc.values, periodic=bc.periodic,
                      neumann=bc.neumann)
    got = StreamedStencil(get_spec("jacobi7"), shape, sweeps_per_call=k,
                          chunks=chunks, device="cpu").iterate_host(
                              x0, iters, bc=tbc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6,
                               rtol=5e-6)
    assert _chunk_bounds(shape[0], chunks) == jchunk_bounds(shape[0],
                                                            chunks)


def test_pins_and_transfer_bytes():
    m = StreamedStencil(get_spec("jacobi7"), (18, 16, 20),
                        sweeps_per_call=2, chunks=3, device="cpu")
    assert [m.chunk_pins(c, REF) for c in range(3)] == [
        (1, 0, 1, 1), (0, 0, 1, 1), (0, 1, 1, 1)]
    per = REF.with_periodic([0, 1])
    assert {m.chunk_pins(c, per) for c in range(3)} == {(0, 0, 0, 0)}
    up, down = m.transfer_bytes()
    plane = 16 * 20 * 4
    assert down == 18 * plane
    assert up == (8 + 10 + 8) * plane  # each chunk's 6 planes, 2 ghosts


def test_iterate_adapter_roundtrip():
    """A grid in, a host grid out, equal to the tiled method's."""
    spec = get_spec("jacobi7")
    shape = (16, 16, 20)
    grid = HaloGrid.create(shape, halo=1, device="cpu")
    out = StreamedStencil(spec, shape, sweeps_per_call=2, chunks=2,
                          device="cpu").iterate(grid, 4)
    ref = TiledStencil(spec, shape, sweeps_per_call=2,
                       device="cpu").iterate(grid, 4)
    assert out.device.type == "cpu" and out.bc == grid.bc
    assert torch.equal(out.data, ref.data)
    with pytest.raises(ValueError, match="grid dtype"):
        StreamedStencil(spec, shape, dtype="bfloat16", chunks=2,
                        device="cpu").iterate(grid, 1)


def test_host_halo_grid_matches_device_grid():
    host = host_halo_grid((6, 7, 9), halo=2)
    dev = HaloGrid.create((6, 7, 9), halo=2, device="cpu")
    assert host.device.type == "cpu"
    assert torch.equal(host.data, dev.data)


def test_auto_chunks_small_memory():
    spec = get_spec("jacobi7")
    c = auto_chunks(spec, (18, 16, 140), "float32", 1, hbm=2 << 20)
    assert c > 1
    check(spec, (18, 16, 140), 1, c, iters=3)
    with pytest.raises(ValueError, match="cannot be streamed"):
        auto_chunks(spec, (18, 16, 140), "float32", 8, hbm=1 << 16)


def test_auto_chunks_env_override(monkeypatch):
    monkeypatch.setenv("STENCIL_TPU_HBM_MB", "2")
    m = StreamedStencil(get_spec("jacobi7"), (18, 16, 140),
                        sweeps_per_call=1, device="cpu")
    assert m.num_chunks > 1


def test_gate_chunk_shallower_than_kr():
    with pytest.raises(ValueError, match="k\\*r"):
        StreamedStencil(get_spec("jacobi7"), (8, 16, 20),
                        sweeps_per_call=8, chunks=4, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        StreamedStencil(get_spec("jacobi7"), (8, 16, 20), chunks=9,
                        device="cpu")


def test_gate_asymmetric_neumann_deep_k():
    asym = weighted(3, [((0, 0, 0), 0.5), ((1, 0, 0), 0.5)],
                    name="asym3d")
    bc = REF.with_neumann([0])
    m = StreamedStencil(asym, (16, 16, 20), sweeps_per_call=2, chunks=2,
                        device="cpu")
    with pytest.raises(ValueError, match="mirror-symmetric"):
        m.iterate_host(torch.zeros((16, 16, 20)), 4, bc=bc)
    # and the k=1 run it suggests works, bitwise tiled
    check(asym, (16, 16, 20), 1, 2, iters=3, bc=bc, seed=True)


def test_gate_dynamic_lane_needs_k1():
    bc = REF.with_periodic([2])
    m = StreamedStencil(get_spec("jacobi7"), (16, 16, 20),
                        sweeps_per_call=2, chunks=2, device="cpu")
    with pytest.raises(ValueError, match="lane"):
        m.iterate_host(torch.zeros((16, 16, 20)), 4, bc=bc)


def test_gate_shallow_dynamic_dim():
    bc = REF.with_periodic([1])
    m = StreamedStencil(get_spec("jacobi7"), (16, 3, 20),
                        sweeps_per_call=4, chunks=2, device="cpu")
    with pytest.raises(ValueError, match="dynamic dim 1 needs"):
        m.iterate_host(torch.zeros((16, 3, 20)), 4, bc=bc)


def test_gate_2d_refused():
    with pytest.raises(ValueError, match="3D-only"):
        StreamedStencil(get_spec("jacobi5"), (64, 64), chunks=2,
                        device="cpu")


def test_registry_runner():
    """The CLI's path: the factory takes --chunks and -k."""
    spec = get_spec("jacobi7")
    cfg = RunConfig(size=(16, 16, 20), spec="jacobi7", device="cpu",
                    methods=("streamed",), chunks=2, temporal=2)
    grid = HaloGrid.create((16, 16, 20), halo=1, device="cpu")
    runner = registry.get_runner("streamed", cfg, spec, grid)
    assert runner.name == "streamed(C=2,k=2)" and runner.granularity == 2
    info = runner.plan_info
    assert info["kernel"] == "streamed" and info["chunks"] == 2
    assert info["chunk_planes"] == [8, 8] and info["k"] == 2
    assert info["schedule"] in ("march", "window")
    out = runner.iterate(grid, 4)
    want = golden.golden_iterate(np.zeros((16, 16, 20)), spec, 4,
                                 bc=grid.bc)
    np.testing.assert_allclose(out.interior().double().numpy(), want,
                               atol=5e-6, rtol=5e-6)


def test_make_grid_goes_to_the_host_past_the_memory(monkeypatch):
    """Two iterates past the device's memory (``STENCIL_TPU_HBM_MB``, the
    JAX package's override): ``cli.make_grid`` builds the grid in host
    memory, as ``stencil_tpu/cli.py:55-72`` does."""
    from stencil_tpu_torch import cli, device_model, streaming

    cfg = RunConfig(size=(64, 64, 64), spec="jacobi7", device="cpu")
    spec = cfg.resolved_spec()
    calls = []
    orig = streaming.host_halo_grid

    def spy(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(streaming, "host_halo_grid", spy)
    cli.make_grid(cfg, spec)
    assert calls == []
    monkeypatch.setenv("STENCIL_TPU_HBM_MB", "1")  # 2 x 1 MiB > 1 MiB
    assert device_model.hbm_bytes("cpu") == 1 << 20
    grid = cli.make_grid(cfg, spec)
    assert len(calls) == 1 and grid.device.type == "cpu"
    assert torch.equal(grid.data, HaloGrid.create(
        (64, 64, 64), halo=1, device="cpu").data)


def test_hbm_bytes(monkeypatch):
    from stencil_tpu_torch import device_model

    monkeypatch.delenv("STENCIL_TPU_HBM_MB", raising=False)
    import os

    assert device_model.hbm_bytes("cpu") == \
        os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_model.hbm_bytes("cuda")
    monkeypatch.setenv("STENCIL_TPU_HBM_MB", "3")
    assert device_model.hbm_bytes("cuda") == 3 << 20
