"""The device-timeline reader on synthetic Chrome traces: the union of the
device intervals, the idle gaps by what the host was doing, and the checks
that end a traced run whose trace does not account for every launch."""

import pytest

from benchmark import trace

NAMES = ("tiled_sweep_kernel", "tiled_march_kernel")
MARCH = "tiled_march_kernel"


def chrome(*events):
    return {"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in events]}


def slice_of_one_call():
    return trace.Timeline.from_chrome(chrome(
        ("user_annotation", "iterate", 0.0, 100.0),
        ("cpu_op", "aten::clone", 5.0, 20.0),
        ("cpu_op", "aten::zeros", 62.0, 10.0),
        ("kernel", "void (anonymous namespace)::tiled_march_kernel<6, 0, "
         "float>(float const*)", 20.0, 30.0),
        ("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 40.0, 20.0),
        ("kernel", "at::native::vectorized_elementwise_kernel<4>", 80.0,
         10.0),
        ("user_annotation", "sync", 100.0, 5.0),
        ("gpu_user_annotation", "iterate", 20.0, 70.0),
        ("cuda_runtime", "cudaLaunchKernel", 18.0, 2.0)))


def test_account_reads_the_timeline():
    launches = {"launches": 1, "march_launches": 1}
    got = trace.account(slice_of_one_call(), 0.071, launches, NAMES, MARCH,
                        calls=1)
    assert got.busy_s == pytest.approx(50e-6)        # [20, 60] + [80, 90]
    assert got.span_s == pytest.approx(70e-6)
    assert got.stencil_s == pytest.approx(30e-6)
    assert got.nonstencil_s == pytest.approx(30e-6)
    assert got.kernel_events == 2
    assert got.breakdown["idle_gaps"] == [["iterate", pytest.approx(20e-6)]]
    names = [n for n, _ in got.breakdown["device_ops"]]
    assert names[0].startswith("(anonymous namespace)::tiled_march_kernel")


def test_gap_labelled_by_the_open_host_operator():
    tl = trace.Timeline.from_chrome(chrome(
        ("user_annotation", "solve", 0.0, 100.0),
        ("cpu_op", "aten::add_", 45.0, 30.0),
        ("cpu_op", "aten::copy_", 50.0, 5.0),
        ("kernel", "a", 10.0, 40.0),
        ("kernel", "b", 70.0, 5.0)))
    assert trace.idle_gaps(tl) == {
        "solve: aten::add_": pytest.approx(20e-6)}


def test_gaps_named_from_the_labelled_slice():
    device_only = trace.Timeline.from_chrome(chrome(
        ("kernel", "tiled_march_kernel", 20.0, 30.0),
        ("kernel", "elementwise", 80.0, 10.0)))
    got = trace.account(device_only, 0.071,
                        {"launches": 1, "march_launches": 1}, NAMES, MARCH,
                        calls=1, labels=slice_of_one_call())
    assert got.busy_s == pytest.approx(40e-6)
    assert got.breakdown["idle_gaps"] == [["iterate", pytest.approx(20e-6)]]
    alone = trace.account(device_only, 0.071,
                          {"launches": 1, "march_launches": 1}, NAMES, MARCH,
                          calls=1)
    assert alone.breakdown["idle_gaps"] == [["harness",
                                             pytest.approx(30e-6)]]


def test_a_missed_launch_ends_the_run():
    launches = {"launches": 2, "march_launches": 2}
    with pytest.raises(trace.TraceMismatch,
                       match="1 stencil-kernel events .* 2 launches"):
        trace.account(slice_of_one_call(), 0.071, launches, NAMES, MARCH,
                      calls=1)


def test_a_trace_short_of_the_cuda_events_ends_the_run():
    launches = {"launches": 1, "march_launches": 1}
    with pytest.raises(trace.TraceMismatch, match="device span"):
        trace.account(slice_of_one_call(), 10.0, launches, NAMES, MARCH,
                      calls=1)


def test_no_device_event_ends_the_run():
    empty = trace.Timeline.from_chrome(chrome(
        ("user_annotation", "iterate", 0.0, 10.0)))
    with pytest.raises(trace.TraceMismatch, match="no device event"):
        trace.account(empty, 1.0, {"launches": 0, "march_launches": 0},
                      NAMES, MARCH, calls=1)


def _small_relax(device):
    from stencil_tpu_torch.config import RunConfig
    from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
    from stencil_tpu_torch.core.spec import NAMED_SPECS
    from stencil_tpu_torch.registry import get_runner

    import torch

    shape = (64, 48, 80)
    grid = HaloGrid.from_interior(
        torch.rand(shape, device=device), halo=1,
        bc=DirichletBC(values=((0.0, 1.0),) * 3), device=device)
    config = RunConfig(size=shape, spec="jacobi7",
                       methods=("pallas_temporal",), temporal=4,
                       device=str(device))
    runner = get_runner("pallas_temporal", config, NAMED_SPECS["jacobi7"](),
                        grid)
    return lambda i: runner.iterate(grid, 16)


@pytest.mark.cuda
def test_the_card_trace_accounts_for_every_launch(cuda_device):
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

    from benchmark import harness

    got = trace.trace_slice(_small_relax(cuda_device), 3, "iterate",
                            cuda_device,
                            lambda: harness.launch_counts(tiled_sweep),
                            harness.kernel_names(tiled_sweep), MARCH)
    assert got.stencil_events == got.launches["launches"] == 12
    assert 0 < got.busy_s <= got.slice_s
    assert got.labelled_calls == 1 and got.labelled_s > 0
    assert got.breakdown["idle_gaps"], "no gap named"


@pytest.mark.cuda
def test_the_card_trace_against_wrong_counters_ends_the_run(cuda_device):
    from stencil_tpu_torch.ops.tiled_kernel import tiled_sweep

    from benchmark import harness

    frozen = harness.launch_counts(tiled_sweep)
    with pytest.raises(trace.TraceMismatch, match="launches counted"):
        trace.trace_slice(_small_relax(cuda_device), 2, "iterate",
                          cuda_device, lambda: frozen,
                          harness.kernel_names(tiled_sweep), MARCH)
