#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stencil_tpu_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each ending in a line of its own:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles the two CUDA kernels (``csrc/tiled_sweep.cu``,
   ``csrc/slab_sweep.cu``) and the native golden from the sources in this
   checkout, all three compilers started together (into
   ``build/stencil_tpu_torch/``);
3. kernel vs plain: each kernel mode (3D tiled, 3D tiled with a source, 2D
   slab, 2D slab with a source) against its plain PyTorch version on the
   card, on random fp32 inputs from a numpy seed, at the main paths' shapes
   and at ragged, box and radius-2 cases, plus remainder runs; each source
   mode also at each of its Poisson paths' own shape, spec, k, tiles, walls
   and source (one launch, and the runner over 19 sweeps);
4. main paths, each with the launch counts set to 0 just before it and
   read just after: the 3D CLI (``-s 256 256 256 --spec jacobi7 -m
   pallas_temporal -k 8 -i 64 -c``), the 2D CLI (``-s 512 512 --spec
   jacobi5 -m pallas_temporal -k 16 -i 1024 -c`` and ``-s 4096 4096 --spec
   jacobi9 -m pallas_temporal -k 4 -b 256 -i 64 -c``), each passing the
   float64 golden check over every iteration; the Poisson model's
   manufactured solves (2D 63², 3D 31³, ``method="auto"``), each within
   5 h² of the exact solution; the Poisson runner (``method="auto"``, k=8)
   at 4096² and at 256³ against the float64 golden with the source over 16
   iterations (the NumPy golden; the native one has no source term);
5. times: GLUPS of the 3D tiled kernel at k=8 and k=1 and of ``eager`` at
   256³; of cfg1 (2D 5-pt 512², slab k=16) and cfg2 (2D 9-pt 4096², slab
   k=4, ``-b 256``) and ``eager`` at both sizes; of cfg8 (Poisson 256³, the
   tiled source kernel at k=8); one launch's kernel ms against its plain
   version's for each kernel mode, at a main path's shape (the source
   modes at the Poisson golden checks'); the device's busy share over
   cfg1's main-path run, from a ``torch.profiler`` trace.

Each kernel's ``launches`` in the kernel record sums the phase-4 runs of
that mode; its ``max_abs_err`` is the largest of its phase-3 cases.

The line before the last is the kernel record (JSON); the last line is
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
so does a host without a CUDA device, or a directory without the package.
"""

import concurrent.futures
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# kernel vs plain: the same taps in the same order, the source added after
# them, no FMA contraction, so the two should agree bitwise; a difference
# up to this much is tolerated (and reported) in case a compiler reorders
KERNEL_TOL = 1e-6
# the float64 golden bar, the reference's
GOLDEN_TOL = 1e-4
DEVICE = "cuda"
MAIN_SIZE = (256, 256, 256)
RAGGED_SIZE = (57, 50, 46)
BOX_SIZE = (64, 48, 80)
MAIN_ITERS = 64
CFG1 = ("jacobi5", (512, 512), 16, None, 1024)   # spec, size, k, -b, -i
CFG2 = ("jacobi9", (4096, 4096), 4, 256, 64)
POISSON_2D = (63, 63)
POISSON_3D = (31, 31, 31)
POISSON_BIG = (256, 256, 256)
POISSON_BIG_2D = (4096, 4096)
POISSON_BIG_ITERS = 16
POISSON_COMPARE_ITERS = 19   # two launches of k=8 and a remainder of 3
RAGGED_2D = (250, 333)
SLAB_SOURCE_SIZE = (4096, 4096)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def gpu_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def check_equal(label, got, want):
    """Kernel output against the plain version's; returns the max abs
    difference."""
    import torch

    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    diff = (got - want).abs().max().item()
    bitwise = torch.equal(got, want)
    print(f"  {label}: "
          f"{'bitwise equal' if bitwise else 'max abs diff %.3e' % diff}")
    if not bitwise:
        print(f"    not bitwise: the compiled kernel rounds differently "
              f"from the eager version somewhere; tolerated up to "
              f"{KERNEL_TOL:g}")
    require(diff <= KERNEL_TOL, f"{label}: kernel vs plain {diff} > "
            f"{KERNEL_TOL}")
    return diff


def random_grid(shape, radius, rng, device):
    import torch

    from stencil_tpu_torch.core.grid import HaloGrid

    x = rng.random(shape, dtype=np.float32)
    return HaloGrid.from_interior(torch.from_numpy(x), halo=radius,
                                  device=device)


def compare_launch(kernel, make_plan, spec, shape, k, rng, device,
                   t0=None, scale=None):
    """One launch of k sweeps against the plain version; ``scale`` adds a
    random source of that scale."""
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference

    plan = make_plan(spec, shape, "float32", k, t0_fixed=t0)
    grid = random_grid(shape, spec.radius, rng, device)
    cur = plan.layout.pad_grid(grid)
    src = None
    if scale is not None:
        src = pad_source(plan, rng.normal(size=shape), scale,
                         grid.bc).to(device)
    got = kernel(cur, cur.clone(), plan, src)
    want = sweep_reference(cur, plan, src)
    return check_equal(f"{kernel.name}{'+source' if src is not None else ''}"
                       f" {spec.name} {shape} k={k} tiles {plan.tiles}",
                       got, want)


def compare_iterate(stencil_cls, spec, shape, k, iters, rng, device,
                    scale=None):
    """The iterate (iters // k launches plus a remainder launch) against
    the eager iterate."""
    import torch

    from stencil_tpu_torch.ops import eager

    grid = random_grid(shape, spec.radius, rng, device)
    f = rng.normal(size=shape) if scale is not None else None
    got = stencil_cls(spec, shape, sweeps_per_call=k, device=device,
                      source=f, source_scale=scale or 1.0
                      ).iterate(grid, iters).data
    scaled = None
    if f is not None:
        scaled = torch.from_numpy(f).float().to(device) \
            * float(np.float32(scale))
    want = eager.iterate(grid, spec, iters, scaled).data
    return check_equal(f"{stencil_cls.__name__}"
                       f"{'+source' if f is not None else ''} {spec.name} "
                       f"{shape} k={k}, {iters} iterations", got, want)


def compare_poisson(prob, f, kernel, make_plan, rng, device):
    """A Poisson main path's kernel mode against its plain version at that
    path's own shape, spec, k, tiles, walls and source ``f``: one launch,
    then the runner (``method="auto"``) over POISSON_COMPARE_ITERS sweeps
    against the eager iterate, from a random u."""
    from stencil_tpu_torch.ops import eager
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference

    runner = prob.runner(f, method="auto")
    k = runner.plan_info["k"]
    plan = make_plan(prob.spec, prob.shape, "float32", k)
    require(list(plan.tiles) == runner.plan_info["tiles"],
            f"Poisson {prob.shape}: plan {plan.tiles} is not the runner's "
            f"{runner.plan_info}")
    grid = prob.initial_grid(rng.random(prob.shape, dtype=np.float32))
    cur = plan.layout.pad_grid(grid)
    src = pad_source(plan, f, prob.source_scale, grid.bc).to(device)
    label = (f"{kernel.name}+source Poisson {prob.spec.name} {prob.shape} "
             f"k={k} tiles {plan.tiles}")
    one = check_equal(f"{label}, one launch",
                      kernel(cur, cur.clone(), plan, src),
                      sweep_reference(cur, plan, src))
    iters = POISSON_COMPARE_ITERS
    got = runner.iterate(grid, iters).data
    want = eager.iterate(grid, prob.spec, iters,
                         src[plan.layout.interior_index]).data
    return max(one, check_equal(f"{label}, the runner over {iters} "
                                f"iterations", got, want))


def time_call(fn, device, reps):
    from stencil_tpu_torch.utils.timing import timed

    fn()
    return timed(lambda: [fn() for _ in range(reps)], device) / reps * 1e3


def run_cli(cli, args, kernel, label):
    """One CLI main path with ``kernel``'s counts set to 0 just before;
    returns (record, launches)."""
    kernel.launches = kernel.source_launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "main.jsonl"
        rc = cli.main([*args, "-c", "--device", DEVICE,
                       "--json-out", str(out)])
        launches = kernel.launches
        rec = json.loads(out.read_text().splitlines()[0])
    iters = int(args[args.index("-i") + 1])
    require(rc == 0, f"main path {args} returned {rc}")
    chk = rec["check"]
    require(chk["ok"] and not chk["capped"]
            and chk["iterations_checked"] == iters
            and np.isfinite(chk["max_abs_err"]),
            f"main path {args} check: {chk}")
    require(launches > 0, f"main path {args} launched no {kernel.name}")
    print(f"main path {' '.join(args)}: check OK over "
          f"{chk['iterations_checked']} iterations vs the float64 golden, "
          f"max abs err {chk['max_abs_err']:.3e}; {launches} {kernel.name} "
          f"launches; plan {rec['plan']}; {rec['glups']:.2f} GLUPS "
          f"[{label}]")
    return rec, launches


def poisson_solve(shape, kernel, device):
    """The manufactured solve through ``method="auto"``; returns the
    source-mode launches it made."""
    from stencil_tpu_torch.models.poisson import (
        PoissonProblem, manufactured_sine,
    )

    prob = PoissonProblem(shape=shape, device=device)
    f, u_exact = manufactured_sine(shape)
    kernel.launches = kernel.source_launches = 0
    t0 = time.perf_counter()
    res = prob.solve(f, tolerance=1e-6, max_iterations=100_000,
                     check_every=200, method="auto")
    seconds = time.perf_counter() - t0
    launches = kernel.source_launches
    u = res.grid.interior().double().cpu().numpy()
    err = float(np.max(np.abs(u - u_exact)))
    bar = 5.0 * prob.h ** 2
    print(f"Poisson {shape} auto: {res.summary()} in {seconds:.2f} s; max "
          f"err vs exact {err:.3e} (bar 5 h^2 = {bar:.3e}); "
          f"{launches} {kernel.name}+source launches")
    require(res.converged, f"Poisson {shape} did not converge")
    require(np.isfinite(err) and err < bar,
            f"Poisson {shape}: error {err} >= {bar}")
    require(launches > 0 and launches == kernel.launches,
            f"Poisson {shape} did not run the {kernel.name} source mode")
    return launches


def poisson_golden(shape, kernel, rng):
    """The Poisson runner (``method="auto"``, k=8) over POISSON_BIG_ITERS
    sweeps at ``shape``, against the float64 NumPy golden with the source
    (full shape, iterations cut); returns (runner, problem, f, source-mode
    launches), the launch count set to 0 just before the run."""
    from stencil_tpu_torch.models.poisson import PoissonProblem
    from stencil_tpu_torch.ops import golden

    prob = PoissonProblem(shape=shape, device=DEVICE)
    u0 = rng.random(shape, dtype=np.float32)
    # f of size 1/h^2 makes the source's share of each sweep O(1), so a
    # missing or misplaced source fails the check
    f = rng.normal(size=shape) / prob.h ** 2
    runner = prob.runner(f, method="auto")
    kernel.launches = kernel.source_launches = 0
    out = runner.iterate(prob.initial_grid(u0), POISSON_BIG_ITERS)
    n_src = kernel.source_launches
    got = out.interior().double().cpu().numpy()
    want = golden.golden_iterate(u0, prob.spec, POISSON_BIG_ITERS,
                                 bc=prob.bc, source=f,
                                 source_scale=prob.source_scale)
    moved = np.max(np.abs(want - golden.golden_iterate(
        u0, prob.spec, POISSON_BIG_ITERS, bc=prob.bc)))
    chk = golden.check_against_golden(got, want, GOLDEN_TOL)
    print(f"Poisson {shape} {runner.name} tiles {runner.plan_info['tiles']}, "
          f"{POISSON_BIG_ITERS} iterations vs the float64 NumPy golden with "
          f"the source (full shape, iterations cut to {POISSON_BIG_ITERS}): "
          f"{'OK' if chk.ok else 'FAILED'} {chk.message()}; the source "
          f"moves the golden by {moved:.3e}; {n_src} {kernel.name}+source "
          f"launches")
    require(chk.ok and np.isfinite(chk.max_abs_err),
            f"Poisson {shape} golden check")
    require(moved > 100 * GOLDEN_TOL,
            f"Poisson {shape}: the source does not move the golden")
    require(n_src == POISSON_BIG_ITERS // runner.plan_info["k"]
            and n_src == kernel.launches, f"Poisson {shape} launches")
    return runner, prob, f, n_src


def bench(runner, grid, points, device, hbm, label, name=None):
    from stencil_tpu_torch.utils import roofline
    from stencil_tpu_torch.utils.timing import measure_marginal

    g = max(1, runner.granularity)
    m = measure_marginal(lambda n: runner.iterate(grid, n).data, device,
                         warmup_iters=g, granularity=g, repeats=2)
    rep = roofline.report(points, 1, m.seconds_per_iteration, "float32",
                          hbm)
    print(f"{name or runner.name}: {rep.glups:.2f} GLUPS, "
          f"{rep.roofline_fraction:.3f} x naive roofline "
          f"({rep.roofline_glups:.1f} GLUPS at {hbm:.1f} GB/s), marginals "
          f"{[f'{x * 1e3:.4f}' for x in m.marginals]} ms/sweep [{label}]")
    return rep.glups


def device_busy(run, device):
    """(host wall ms, device busy ms, device span ms) of ``run()`` from a
    ``torch.profiler`` trace; busy is None when the trace holds no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ranges = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ranges:
        return wall, None, None
    busy = sum(end - start for start, end in ranges) / 1e3
    span = (max(e for _, e in ranges) - min(s for s, _ in ranges)) / 1e3
    return wall, busy, span


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "stencil_tpu_torch").is_dir():
        print(f"chip_smoke: no stencil_tpu_torch package beside "
              f"{Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()

    # 1. device
    device = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    label = gpu_label()
    print(f"device: {kind}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(label)
    print("PHASE 1 device: ok")

    # 2. build: nvcc for each kernel and g++ for the golden, together
    from stencil_tpu_torch import native
    from stencil_tpu_torch.ops import slab_kernel, tiled_kernel

    kernels = (tiled_kernel.tiled_sweep, slab_kernel.slab_sweep)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        t0 = time.perf_counter()
        golden = pool.submit(native.available)
        builds = [pool.submit(kernel.build) for kernel in kernels]
        builds = [b.result() for b in builds]
        require(golden.result(), "native golden failed to build (g++)")
    print(f"parallel build: {time.perf_counter() - t0:.2f} s")
    for kernel, b in zip(kernels, builds):
        kernel.library()
        print(f"nvcc build of {kernel.source.relative_to(ROOT)}: "
              f"{b.seconds:.2f} s{' (cached)' if b.cached else ''}")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print("PHASE 2 build: ok")

    # 3. kernel vs plain on the card, per kernel mode
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.models.poisson import (
        PoissonProblem, manufactured_sine,
    )
    from stencil_tpu_torch.ops.slab import SlabStencil, make_slab_plan
    from stencil_tpu_torch.ops.tiled import TiledStencil, make_tiled_plan

    tiled = tiled_kernel.tiled_sweep
    slab = slab_kernel.slab_sweep
    rng = np.random.default_rng(SEED)
    j5, j7, j9 = get_spec("jacobi5"), get_spec("jacobi7"), get_spec("jacobi9")
    err = {}
    err["tiled_sweep"] = max(
        [compare_launch(tiled, make_tiled_plan, j7, s, k, rng, device)
         for s in (MAIN_SIZE, RAGGED_SIZE) for k in (1, 2, 8)]
        + [compare_launch(tiled, make_tiled_plan, get_spec(n), BOX_SIZE, 4,
                          rng, device)
           for n in ("jacobi27", "laplace3d_ho")]
        + [compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng,
                           device)])
    err["tiled_sweep+source"] = max(
        compare_launch(tiled, make_tiled_plan, j7, MAIN_SIZE, 8, rng, device,
                       scale=-0.01),
        compare_launch(tiled, make_tiled_plan, j7, RAGGED_SIZE, 3, rng,
                       device, scale=-0.01),
        compare_iterate(TiledStencil, j7, RAGGED_SIZE, 3, 7, rng, device,
                        scale=-0.01))
    err["slab_sweep"] = max(
        compare_launch(slab, make_slab_plan, j5, CFG1[1], 1, rng, device),
        compare_launch(slab, make_slab_plan, j5, CFG1[1], CFG1[2], rng,
                       device),
        compare_launch(slab, make_slab_plan, j9, CFG2[1], CFG2[2], rng,
                       device, t0=CFG2[3]),
        compare_launch(slab, make_slab_plan, get_spec("star2d_r2"),
                       RAGGED_2D, 3, rng, device),
        compare_iterate(SlabStencil, j5, RAGGED_2D, 4, 11, rng, device))
    err["slab_sweep+source"] = max(
        compare_launch(slab, make_slab_plan, j5, SLAB_SOURCE_SIZE, 4, rng,
                       device, scale=-0.01),
        compare_iterate(SlabStencil, j9, RAGGED_2D, 4, 11, rng, device,
                        scale=-0.01))
    # the Poisson main paths' own shapes, k, tiles and sources: the
    # manufactured solves and the golden checks of phase 4
    poisson_f = {}
    for shape, kernel, make_plan, mode in (
            (POISSON_2D, slab, make_slab_plan, "slab_sweep+source"),
            (POISSON_3D, tiled, make_tiled_plan, "tiled_sweep+source"),
            (POISSON_BIG_2D, slab, make_slab_plan, "slab_sweep+source"),
            (POISSON_BIG, tiled, make_tiled_plan, "tiled_sweep+source")):
        prob = PoissonProblem(shape=shape, device=DEVICE)
        f = manufactured_sine(shape)[0] if shape in (POISSON_2D, POISSON_3D) \
            else rng.normal(size=shape) / prob.h ** 2
        err[mode] = max(err[mode], compare_poisson(prob, f, kernel,
                                                   make_plan, rng, device))
    print(f"PHASE 3 kernel vs plain: ok (max abs diff per mode "
          f"{ {k: float(f'{v:.3e}') for k, v in err.items()} })")

    # 4. main paths, launch counts set to 0 just before each
    from stencil_tpu_torch import cli

    launches = {}
    rec3d, launches["tiled_sweep"] = run_cli(
        cli, ["-s", *map(str, MAIN_SIZE), "--spec", "jacobi7", "-m",
              "pallas_temporal", "-k", "8", "-i", str(MAIN_ITERS)],
        tiled, label)
    require(tiled.source_launches == 0, "3D main path ran the source mode")
    slab_runs = []
    for spec_name, size, k, block, iters in (CFG1, CFG2):
        args = ["-s", *map(str, size), "--spec", spec_name, "-m",
                "pallas_temporal", "-k", str(k), "-i", str(iters)]
        if block is not None:
            args += ["-b", str(block)]
        rec, n = run_cli(cli, args, slab, label)
        require(rec["plan"]["kernel"] == "slab", f"{args} ran {rec['plan']}")
        slab_runs.append(n)
    launches["slab_sweep"] = sum(slab_runs)
    # each source mode: a manufactured solve and a golden check, at the
    # shapes phase 3 held the kernel at
    poisson_big = {}
    for mode, kernel, small, big in (
            ("slab_sweep+source", slab, POISSON_2D, POISSON_BIG_2D),
            ("tiled_sweep+source", tiled, POISSON_3D, POISSON_BIG)):
        n_solve = poisson_solve(small, kernel, device)
        poisson_big[mode] = poisson_golden(big, kernel, rng)
        launches[mode] = n_solve + poisson_big[mode][3]
    print(f"PHASE 4 main paths: ok (launches {launches})")

    # 5. times
    from stencil_tpu_torch import registry
    from stencil_tpu_torch.config import RunConfig
    from stencil_tpu_torch.ops.layout import pad_source
    from stencil_tpu_torch.ops.sweep_kernel import sweep_reference
    from stencil_tpu_torch.utils import roofline

    hbm = roofline.measure_hbm_bandwidth(device)
    print(f"measured HBM bandwidth: {hbm:.1f} GB/s [{label}]")
    for spec, size, methods in (
            (j7, MAIN_SIZE, (("tiled", 8, None), ("tiled", 1, None),
                             ("eager", 1, None))),
            (j5, CFG1[1], (("slab", CFG1[2], CFG1[3]), ("eager", 1, None))),
            (j9, CFG2[1], (("slab", CFG2[2], CFG2[3]), ("eager", 1, None)))):
        for method, k, block in methods:
            cfg = RunConfig(size=size, spec=spec.name, temporal=k,
                            block=block, methods=(method,), device=DEVICE)
            grid = cli.make_grid(cfg, spec)
            runner = registry.get_runner(method, cfg, spec, grid)
            bench(runner, grid, int(np.prod(size)), device, hbm, label,
                  f"{spec.name} {size} {runner.name}")
    # cfg8: Poisson 256^3 through the tiled source kernel at k=8
    prob = PoissonProblem(shape=POISSON_BIG, device=DEVICE)
    f = np.random.default_rng(SEED).normal(size=POISSON_BIG) \
        .astype(np.float32)
    runner = prob.runner(f, method="pallas_tiled", sweeps_per_call=8)
    bench(runner, prob.initial_grid(), int(np.prod(POISSON_BIG)), device,
          hbm, label, f"cfg8 Poisson {POISSON_BIG} {runner.name} "
          f"{runner.plan_info['tiles']}")

    # one launch per kernel mode at the shape, spec, k, tiles and source
    # of a main path that phase 3 held it at and phase 4 counted
    launch_inputs = []  # (mode, kernel, plan, padded u, padded source)
    for mode, kernel, make_plan, spec, size, k in (
            ("tiled_sweep", tiled, make_tiled_plan, j7, MAIN_SIZE, 8),
            ("slab_sweep", slab, make_slab_plan, j5, CFG1[1], CFG1[2])):
        plan = make_plan(spec, size, "float32", k)
        launch_inputs.append((mode, kernel, plan, plan.layout.pad_grid(
            random_grid(size, spec.radius, rng, device)), None))
    for mode, kernel, make_plan in (
            ("tiled_sweep+source", tiled, make_tiled_plan),
            ("slab_sweep+source", slab, make_slab_plan)):
        runner, prob, f, _ = poisson_big[mode]
        plan = make_plan(prob.spec, prob.shape, "float32",
                         runner.plan_info["k"])
        require(list(plan.tiles) == runner.plan_info["tiles"],
                f"{mode}: plan {plan.tiles} is not the runner's")
        grid = prob.initial_grid(rng.random(prob.shape, dtype=np.float32))
        launch_inputs.append((mode, kernel, plan, plan.layout.pad_grid(grid),
                              pad_source(plan, f, prob.source_scale,
                                         grid.bc).to(device)))
    ms, plain_ms = {}, {}
    for mode, kernel, plan, cur, src in launch_inputs:
        nxt = cur.clone()
        ms[mode] = time_call(lambda: kernel(cur, nxt, plan, src), device, 20)
        plain_ms[mode] = time_call(lambda: sweep_reference(cur, plan, src),
                                   device, 5)
        print(f"one call of {mode} {plan.spec.name} {plan.interior_shape} "
              f"k={plan.sweeps_per_call}, tiles {plan.tiles}: kernel "
              f"{ms[mode]:.4f} ms, plain {plain_ms[mode]:.4f} ms [{label}]")

    # the device's busy share over cfg1's main-path run (1024 iterations)
    cfg = RunConfig(size=CFG1[1], spec="jacobi5", temporal=CFG1[2],
                    methods=("slab",), device=DEVICE)
    grid = cli.make_grid(cfg, j5)
    runner = registry.get_runner("slab", cfg, j5, grid)
    wall, busy, span = device_busy(lambda: runner.iterate(grid, CFG1[4]),
                                   device)
    if busy is None:
        print(f"cfg1 {CFG1[4]} iterations: host wall {wall:.3f} ms; device "
              f"busy share not measured (the trace holds no device events)")
    else:
        print(f"cfg1 {CFG1[4]} iterations ({runner.name}): host wall "
              f"{wall:.3f} ms unprofiled; device busy {busy:.3f} ms of a "
              f"{span:.3f} ms span, idle {100 * (1 - busy / span):.1f}% "
              f"[{label}]")
    print(f"PHASE 5 times: ok ({time.perf_counter() - t_start:.1f} s in "
          "all)")

    modules = {"tiled_sweep": tiled_kernel, "slab_sweep": slab_kernel}
    print(json.dumps({"kernels": [{
        "name": mode, "route": "cuda",
        "source": str(modules[mode.split("+")[0]].SOURCE.relative_to(ROOT)),
        "replaces": modules[mode.split("+")[0]].REPLACES,
        "launches": launches[mode], "max_abs_err": err[mode],
        "ms": ms[mode], "plain_ms": plain_ms[mode],
    } for mode in ("tiled_sweep", "tiled_sweep+source", "slab_sweep",
                   "slab_sweep+source")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
