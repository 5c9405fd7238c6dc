"""Benchmark CLI driver.

Counterpart of ``stencil_tpu/cli.py`` (``make_grid``, ``check_method``,
``bench_method``, ``run_all``, ``main``): for each requested method,
optionally check it against the float64 golden model, then time it
(marginal, autoranged) and report GLUPS and the fraction of the
measured-HBM roofline, plus ``-R`` wall-clock repeats; ``--profile DIR``
traces the timed runs with ``torch.profiler`` (CUDA and CPU activities,
with the port's own spans, ``utils/tracing.py``) into DIR as Chrome
traces, ``--checkpoint-dir`` then runs the iterations
again with checkpoints (one subdirectory per method when there are
several) and ``--dump-image`` writes the final iterate's heat map (a
filename prefix per method when there are several). Grids live on
``--device`` (default ``cuda``), but a grid of which two iterates do not
fit the device's memory lives in host memory, where only ``-m streamed``
runs it. ``--solve`` hands the run to ``solve_cli.run_solve``, as the JAX
CLI does.

  python -m stencil_tpu_torch -s 256 256 256 --spec jacobi7 \\
      -m pallas_temporal -k 8 -c
  python -m stencil_tpu_torch --solve poisson -s 255 255 255 \\
      --smoother chebyshev --tol 1e-5 -c
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from stencil_tpu_torch import device_model, native, registry
from stencil_tpu_torch.config import RunConfig, parse_args
from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, check_device, torch_dtype,
)
from stencil_tpu_torch.ops import golden
from stencil_tpu_torch.utils import roofline, tracing
from stencil_tpu_torch.utils.timing import (
    TinyTimer, measure_marginal, measure_wall,
)

# NumPy golden fallback cap (no C++ compiler): the check covers only this
# many iterations, and the CLI says so
NUMPY_GOLDEN_CAP = 50
# autoranged timing signal: long enough on the card; on the CPU (tests)
# the timing is only exercised, never reported as a device metric
MIN_SIGNAL_SECONDS = {"cuda": 0.75, "cpu": 0.02}


def make_grid(config: RunConfig, spec) -> HaloGrid:
    """Reference initial conditions: interior 0, Dirichlet halo;
    ``--periodic`` dims wrap and ``--neumann`` dims mirror instead.

    When every dim is dynamic a zero interior is a fixed point, and ``-c``
    would compare zero with zero; that one case seeds a deterministic
    nonzero interior (the same numbers as the JAX CLI). A grid of which two
    iterates exceed the device's memory (``device_model.hbm_bytes``) is
    built in host memory (``streaming.host_halo_grid``)."""
    bc = None
    interior_seed = None
    if config.periodic or config.neumann:
        bc = DirichletBC.reference_default(len(config.size))
        if config.periodic:
            bc = bc.with_periodic(config.periodic_dims())
        if config.neumann:
            bc = bc.with_neumann(config.neumann_dims())
        if all(bc.dynamic_mask(len(config.size))):
            interior_seed = np.random.default_rng(0).random(
                config.size).astype(np.float32)
    grid_bytes = int(np.prod(config.size)) * torch_dtype(
        config.dtype).itemsize
    if 2 * grid_bytes > device_model.hbm_bytes(config.device):
        from stencil_tpu_torch.streaming import host_halo_grid

        return host_halo_grid(config.size, halo=spec.radius, bc=bc,
                              dtype=config.dtype, interior=interior_seed)
    if interior_seed is not None:
        return HaloGrid.from_interior(
            torch.from_numpy(interior_seed).to(torch_dtype(config.dtype)),
            halo=spec.radius, bc=bc, device=config.device)
    return HaloGrid.create(config.size, halo=spec.radius, dtype=config.dtype,
                           bc=bc, device=config.device)


def check_method(config: RunConfig, spec, runner):
    """Run the golden-model differential check.

    Returns ``(CheckResult, iterations_checked)``. The native float64
    golden verifies the full iteration count; without a C++ compiler the
    NumPy golden is capped at ``NUMPY_GOLDEN_CAP`` iterations, and the
    caller must say so. A runner with its own ``golden_fn`` (NumPy, for
    updates the spec golden cannot represent) is checked against it,
    capped the same way."""
    grid = make_grid(config, spec)
    x0 = grid.interior().double().cpu().numpy()
    iters = config.iterations
    if runner.golden_fn is not None:
        iters = min(config.iterations, NUMPY_GOLDEN_CAP)
        ref = runner.golden_fn(x0, iters, grid.bc)
    else:
        ref = native.golden_iterate_native(x0, spec, iters, bc=grid.bc)
    if ref is None:
        iters = min(config.iterations, NUMPY_GOLDEN_CAP)
        ref = golden.golden_iterate(x0, spec, iters, bc=grid.bc)
    out = runner.iterate(grid, iters)
    tol = config.check_tolerance
    if tol is None:
        tol = 3e-2 if config.dtype == "bfloat16" else 1e-4
    chk = golden.check_against_golden(
        out.interior().double().cpu().numpy(), ref, tolerance=tol)
    return chk, iters


def bench_method(config: RunConfig, spec, runner):
    grid = make_grid(config, spec)

    def run_n(n: int):
        return runner.iterate(grid, n).data

    g = max(1, runner.granularity)
    device = torch.device(config.device)
    return measure_marginal(
        run_n, device, warmup_iters=max(1, config.warmup) * g,
        granularity=g, repeats=max(2, config.repeat),
        min_signal_seconds=MIN_SIGNAL_SECONDS[device.type])


def run_all(config: RunConfig, out=None) -> List[dict]:
    out = out if out is not None else sys.stdout
    if config.solve:
        from stencil_tpu_torch import solve_cli

        return solve_cli.run_solve(config, out)
    spec = config.resolved_spec()
    points = int(np.prod(config.size))
    device = check_device(config.device)
    # the roofline is the card's own measured bandwidth; a CPU run has no
    # device roofline
    hbm = (roofline.measure_hbm_bandwidth(device)
           if device.type == "cuda" else None)
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    results = []
    for name in config.methods:
        rec: dict = {"method": name, "size": list(config.size),
                     "spec": spec.name, "iterations": config.iterations,
                     "dtype": config.dtype, "device": device_name}
        grid = make_grid(config, spec)
        try:
            if grid.device != device and name != "streamed":
                raise ValueError(
                    f"two {config.dtype} iterates of {tuple(config.size)} "
                    f"exceed {device}'s memory: the grid lies in host "
                    "memory, which only -m streamed runs")
            runner = registry.get_runner(name, config, spec, grid)
        except (KeyError, ValueError, NotImplementedError) as e:
            print(f"[{name}] unavailable: {e}", file=out)
            rec["error"] = str(e)
            results.append(rec)
            continue
        if runner.plan_info:
            rec["plan"] = runner.plan_info

        if config.check:
            chk, iters_checked = check_method(config, spec, runner)
            capped = iters_checked < config.iterations
            rec["check"] = {
                "ok": bool(chk.ok),
                "max_abs_err": chk.max_abs_err,
                "max_rel_err": chk.max_rel_err,
                "iterations_checked": iters_checked,
                "capped": capped,
            }
            status = "OK" if chk.ok else "FAILED"
            print(f"[{name}] correctness: {status} "
                  f"({iters_checked} iterations verified) — "
                  f"{chk.message()}", file=out)
            if capped:
                why = ("method-specific field golden"
                       if runner.golden_fn is not None
                       else "no C++ toolchain — NumPy golden fallback")
                print(f"[{name}] WARNING: {why} verified only "
                      f"{iters_checked} of {config.iterations} iterations",
                      file=out)
            if not chk.ok:
                results.append(rec)
                continue

        if config.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            tracing.enable()  # the port's spans join the profiler's trace
            try:
                with profile(activities=activities) as prof:
                    m = bench_method(config, spec, runner)
            finally:
                tracing.disable()
                tracing.drain()
            trace_dir = Path(config.profile_dir)
            trace_dir.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(trace_dir / f"{name}.trace.json"))
            print(f"[{name}] profiler trace -> {config.profile_dir}",
                  file=out)
        else:
            m = bench_method(config, spec, runner)
        rep = roofline.report(points, 1, m.seconds_per_iteration,
                              config.dtype, hbm)
        rec["seconds_per_sweep"] = rep.seconds_per_sweep
        rec["glups"] = rep.glups
        rec["hbm_gbps"] = rep.hbm_gbps
        rec["roofline_fraction"] = rep.roofline_fraction
        print(f"[{name}] {device_name}: {rep.summary()}", file=out)

        wall = measure_wall(
            lambda: runner.iterate(grid, config.iterations).data,
            device, repeats=config.repeat)
        rec["wall_seconds"] = [float(t) for t in wall]
        for j, t in enumerate(wall, 1):
            print(f"[{name}] run {j}: {t * 1e3:.3f} ms", file=out)
        print(f"[{name}] average: {sum(wall) / len(wall) * 1e3:.3f} ms "
              f"({config.iterations} iterations)", file=out)
        results.append(rec)

        if config.checkpoint_dir:
            from stencil_tpu_torch.utils.checkpoint import CheckpointedRun

            # a directory per method: a shared one would make every method
            # after the first resume from the previous one's last
            # checkpoint and do no work
            ckpt_dir = (Path(config.checkpoint_dir) / name
                        if len(config.methods) > 1
                        else config.checkpoint_dir)
            _, done = CheckpointedRun(
                runner, ckpt_dir, every=config.checkpoint_every,
                spec_name=spec.name,
            ).run(make_grid(config, spec), config.iterations,
                  progress=lambda msg: print(f"[{name}] {msg}", file=out))
            rec["checkpointed_iterations"] = done

        if config.dump_image:
            from stencil_tpu_torch.utils.image import dump_heatmap

            final = runner.iterate(grid, config.iterations)
            # a filename prefix per method (not a path prefix, which would
            # break absolute paths) when several methods share the flag
            p = Path(config.dump_image)
            path = (str(p) if len(config.methods) == 1
                    else str(p.with_name(f"{name}_{p.name}")))
            dump_heatmap(path, final.interior())
            print(f"[{name}] heat map -> {path}", file=out)

    if config.json_out:
        with open(config.json_out, "w") as f:
            for rec in results:
                f.write(json.dumps(rec) + "\n")
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    config = parse_args(argv)
    try:
        if not config.solve:  # solve mode has no iterate spec
            config.resolved_spec()
        overlap = set(config.periodic_dims()) & set(config.neumann_dims())
        if overlap:
            raise ValueError(
                f"dim(s) {sorted(overlap)} listed as both --periodic and "
                "--neumann; a dim may be periodic or Neumann, not both")
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    timer = TinyTimer().start()
    results = run_all(config)
    if config.verbose:
        print(f"total driver time: {timer.pretty()}")
    bad = [r for r in results
           if r.get("check", {}).get("ok") is False or "error" in r
           or r.get("converged") is False]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
