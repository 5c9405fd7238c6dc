"""The program's spans in a traced run (``benchmark/spans.py``): on
synthetic Chrome traces, each device event put down to the innermost
program span open at its launch, idle gaps named by that span, and the
``runner.launch`` check; the readers with nothing to read; and both passes
on small cells on the CPU."""

import time

import pytest
import torch

from benchmark import harness, spans, trace

NAMES = ("tiled_sweep_kernel", "tiled_march_kernel")
NEW_READERS = ("host_syncs.solve", "coarse_host_ms.solve",
               "coarse_device_ms.solve", "plan_ms.solve",
               "runner_host_us.step")


def chrome(*events):
    out = []
    for ev in events:
        cat, name, ts, dur = ev[:4]
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if len(ev) > 4:
            e["args"] = {"correlation": ev[4]}
        out.append(e)
    return {"traceEvents": out}


def one_solve():
    """A solve whose second level smooths with one kernel and whose fine
    level launches the march; a gap opens inside each."""
    return spans.ProgramTrace.from_chrome(chrome(
        ("user_annotation", "solve", 0.0, 200.0),
        ("user_annotation", "cg.solve", 1.0, 198.0),
        ("user_annotation", "mg.fine.post", 10.0, 20.0),
        ("cuda_runtime", "cudaLaunchKernel", 12.0, 2.0, 7),
        ("user_annotation", "mg.level1", 40.0, 100.0),
        ("user_annotation", "mg.level2", 50.0, 60.0),
        ("user_annotation", "mg.smooth", 55.0, 30.0),
        ("cpu_op", "aten::add_", 56.0, 20.0),
        ("cuda_runtime", "cudaLaunchKernel", 60.0, 2.0, 8),
        ("cuda_runtime", "cudaLaunchKernel", 150.0, 2.0, 9),
        ("kernel", "tiled_march_kernel<6>", 15.0, 30.0, 7),
        ("kernel", "elementwise_add", 62.0, 10.0, 8),
        ("gpu_memcpy", "Memcpy DtoD", 152.0, 8.0, 9),
        ("kernel", "no_launch_traced", 170.0, 5.0, 99)))


def test_events_go_to_the_innermost_span_of_their_launch():
    pt = one_solve()
    assert [pt.spans[i].name if i >= 0 else None for i in pt.owners()] \
        == ["mg.fine.post", "mg.smooth", "cg.solve", None]
    got = spans.device_by_span(pt, calls=1)
    assert got["mg.fine.post"] == [pytest.approx(0.030), 1]
    assert got["mg.smooth"] == [pytest.approx(0.010), 1]
    assert got["(none)"] == [pytest.approx(0.005), 1]
    # only the smoother's kernel lies under a level span
    assert spans.device_ms_under(pt, spans.LEVEL_PREFIX, 1) \
        == pytest.approx(0.010)
    assert spans.device_ms_under(pt, "plan.", 1) is None


def test_a_gap_is_named_by_the_innermost_program_span():
    # the device idles at 45 (inside mg.level1), at 72 (inside mg.level2's
    # smoother and its add_) and at 160 (inside cg.solve alone)
    assert spans.named_gaps(one_solve()) == {
        "solve › mg.level1": pytest.approx(17e-6),
        "solve › mg.level2 › mg.smooth: aten::add_": pytest.approx(80e-6),
        "solve › cg.solve": pytest.approx(10e-6)}


def test_gap_labels_by_time():
    pt = spans.ProgramTrace.from_chrome(chrome(
        ("user_annotation", "solve", 0.0, 100.0),
        ("user_annotation", "mg.level3", 20.0, 60.0),
        ("user_annotation", "mg.smooth", 30.0, 40.0),
        ("cpu_op", "aten::add_", 35.0, 10.0),
        ("kernel", "a", 10.0, 26.0),       # ends at 36: in mg.smooth, add_
        ("kernel", "b", 50.0, 5.0),        # ends at 55: in mg.smooth
        ("kernel", "c", 90.0, 5.0)))       # ends at 95: in solve alone
    assert spans.named_gaps(pt) == {
        "solve › mg.level3 › mg.smooth: aten::add_": pytest.approx(14e-6),
        "solve › mg.level3 › mg.smooth": pytest.approx(35e-6)}


def test_a_level_span_is_its_own_label():
    pt = spans.ProgramTrace.from_chrome(chrome(
        ("user_annotation", "mg.level1", 0.0, 50.0),
        ("user_annotation", "mg.level2", 10.0, 30.0),
        ("kernel", "a", 0.0, 15.0),
        ("kernel", "b", 30.0, 5.0)))
    assert spans.named_gaps(pt) == {"harness › mg.level2":
                                    pytest.approx(15e-6)}


def relax_call(extra=False):
    events = [
        ("user_annotation", "iterate", 0.0, 100.0),
        ("user_annotation", "runner.iterate", 1.0, 98.0),
        ("user_annotation", "runner.pad", 2.0, 8.0),
        ("cuda_runtime", "cudaMemcpyAsync", 3.0, 1.0, 1),
        ("user_annotation", "runner.launch", 20.0, 10.0),
        ("cuda_runtime", "cudaLaunchKernel", 22.0, 2.0, 2),
        ("user_annotation", "runner.launch", 40.0, 10.0),
        ("cuda_runtime", "cudaLaunchKernel", 42.0, 2.0, 3),
        ("gpu_memcpy", "Memcpy DtoD", 5.0, 10.0, 1),
        ("kernel", "tiled_march_kernel<6>", 25.0, 10.0, 2),
        ("kernel", "tiled_march_kernel<6>", 45.0, 10.0, 3)]
    if extra:
        events += [("cuda_runtime", "cudaLaunchKernel", 70.0, 2.0, 4),
                   ("kernel", "tiled_march_kernel<6>", 72.0, 10.0, 4)]
    return spans.ProgramTrace.from_chrome(chrome(*events))


def test_the_launch_spans_hold_every_counted_launch():
    spans.check_launch_spans(relax_call(), 2, NAMES)
    with pytest.raises(trace.TraceMismatch, match="2 kernels put down to "
                       "runner.launch, 3 launches counted"):
        spans.check_launch_spans(relax_call(), 3, NAMES)


def test_a_planted_kernel_outside_the_launch_spans_ends_the_run():
    with pytest.raises(trace.TraceMismatch, match="outside runner.launch"):
        spans.check_launch_spans(relax_call(extra=True), 2, NAMES)


def test_the_host_table_gives_self_time():
    from stencil_tpu_torch.utils.tracing import Span
    from stencil_tpu_torch.utils import tracing

    recorded = [Span("runner.iterate", 0, 10_000_000, -1, 1),
                Span("runner.pad", 1_000_000, 3_000_000, 0, 1),
                Span("runner.launch", 4_000_000, 5_000_000, 0, 1)]
    got = spans.host_table(tracing, recorded, calls=2)
    assert got["runner.iterate"] == {"count": 0.5, "ms": 5.0,
                                     "self_ms": 3.5}
    assert got["runner.pad"]["ms"] == got["runner.pad"]["self_ms"] == 1.0


def _record():
    return {"window": {"call_ms": [1.0, 2.0]}}


@pytest.mark.parametrize("name", NEW_READERS)
def test_a_reader_with_nothing_to_read_gives_none(name, monkeypatch):
    reader = harness.load_metric(harness.ROOT, name)
    # not a benchmark run: this process's __main__ is not run.py
    assert spans.run_context() is None
    assert reader.read(_record()) is None
    # a program without the tracing module (the parent of this change)
    monkeypatch.setattr(spans, "tracing_module", lambda: None)
    assert reader.read(_record()) is None
    # passes that found none of the metric's spans or counters
    monkeypatch.setattr(spans, "reading", lambda record: {
        "host": {}, "counters": {}, "level_device_ms": None})
    want = 0.0 if name == "plan_ms.solve" else None
    assert reader.read(_record()) == want


@pytest.mark.parametrize("cell,interior", [
    ("poisson_511.pcg", [15, 15, 15]), ("jacobi7_512.step", [12, 10, 14])])
def test_the_spans_pass_on_a_small_cell(cell, interior, capsys):
    c = harness.find_cell(cell).with_config(interior=interior)
    ctx = harness.Context(cell=c, seed=2 ** 31 + 11, seconds=0.1,
                          trace=True, device=torch.device("cpu"),
                          t_origin=time.perf_counter())
    got = spans.measure(ctx, window_call_ms=1.0)
    spans.report(got)
    assert "# spans host per call" in capsys.readouterr().err
    host = got["host"]
    if cell.endswith(".pcg"):
        assert got["counters"]["host_syncs"] == 3   # 2 checks, the stats
        assert got["counters"]["plans_made"] == 3
        assert host["cg.solve"]["count"] == 1
        assert host["mg.level1"]["count"] == 9      # 8 passes + setup
    else:
        for n in spans.RUNNER_COPIES:
            assert host[n]["count"] == 1, n
        assert host["runner.launch"]["count"] == 1
    assert all(row["self_ms"] >= 0 for row in host.values())
    assert "device" not in got          # no naming pass without a card


@pytest.mark.cuda
@pytest.mark.parametrize("cell,interior", [
    ("poisson_511.pcg", [63, 63, 63]), ("jacobi7_512.step", [64, 48, 80]),
    ("jacobi7_512.long", [64, 48, 80])])
def test_the_naming_pass_on_the_card(cuda_device, cell, interior):
    c = harness.find_cell(cell).with_config(interior=interior)
    ctx = harness.Context(cell=c, seed=2 ** 31 + 13, seconds=0.1,
                          trace=True, device=cuda_device,
                          t_origin=time.perf_counter())
    got = spans.measure(ctx, window_call_ms=1.0)   # checks runner.launch
    assert 0 < got["busy_ms"] <= got["labelled_call_ms"]
    assert got["idle_gaps"] and got["device"]
    if cell.endswith(".pcg"):
        assert 0 < got["level_device_ms"] <= got["busy_ms"]
        assert got["counters"]["host_syncs"] == 3
    else:
        assert got["device"]["runner.launch"][1] > 0
