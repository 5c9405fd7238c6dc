"""Weak-scaling harness: throughput per rank against the mesh size.

Counterpart of ``stencil_tpu/scaling.py``. BASELINE.json's multi-chip
target is a sharded 3D 7-point Jacobi at >= 90% weak-scaling efficiency:
hold the per-rank block constant, grow a 1D mesh over d0, report the GLUPS
per rank and the efficiency against the one-rank run.

Each point runs the sharded kernel path (``parallel/sharded_kernel.py:
ShardedKernelStencil``, method ``sharded_pallas``) on a single-controller
mesh (``parallel/mesh.py``), and times JAX's path: the blocks scattered
once, then the outer steps on them (``ShardedKernelStencil.run_steps``,
the marginal of ``utils/timing.measure_marginal``); the result is gathered
after the timing. The first mesh wider than one rank prints the exchange's
audit (``parallel/comm_audit.py``): ppermutes and MB per rank per outer
step, ``2 * k * r`` ghost planes per sharded dim whatever the mesh size.

By default the mesh sizes climb 1, 2, 4, ... up to the visible cards. An
explicit ``--mesh-sizes`` may put several ranks on one card (rank i on
``devices[i % len]``); such a point shares the card's SMs and memory among
its ranks, so it measures the exchange, not scaling, and the progress line
and the CLI's output say so.

  python -m stencil_tpu_torch.scaling --local 64 128 128 -k 4 \\
      --mesh-sizes 1 2 4
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence, Tuple

SHARED_NOTE = ("ranks share a device: this point measures the exchange, "
               "not scaling")


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    global_shape: Tuple[int, ...]
    glups: float
    glups_per_chip: float
    efficiency: float  # vs the 1-rank per-rank rate
    # ranks on the busiest device: above 1 the ranks share it
    ranks_per_device: int = 1


def run_weak_scaling(
    local_shape: Sequence[int] = (64, 128, 128),
    spec_name: str = "jacobi7",
    temporal: int = 4,
    mesh_sizes: Optional[Sequence[int]] = None,
    dtype: str = "float32",
    periodic: Sequence[int] = (),
    neumann: Sequence[int] = (),
    progress=print,
    device: str = "cuda",
) -> List[ScalePoint]:
    import torch

    from stencil_tpu_torch.cli import MIN_SIGNAL_SECONDS
    from stencil_tpu_torch.core.grid import (
        DirichletBC, HaloGrid, check_device,
    )
    from stencil_tpu_torch.core.spec import get_spec
    from stencil_tpu_torch.parallel import comm_audit
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.sharded_kernel import (
        ShardedKernelStencil,
    )
    from stencil_tpu_torch.utils.timing import measure_marginal

    dev = check_device(device)
    spec = get_spec(spec_name)
    # a periodic sharded d0 is the torus-wrapped domain classic weak
    # scaling assumes: the exchange's chain closes into a ring
    bc = DirichletBC.reference_default(len(local_shape))
    if periodic:
        bc = bc.with_periodic(tuple(periodic))
    if neumann:
        bc = bc.with_neumann(tuple(neumann))
    n_avail = torch.cuda.device_count() if dev.type == "cuda" else 1
    if mesh_sizes is None:
        mesh_sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= n_avail]

    points: List[ScalePoint] = []
    base_per_rank = None
    audited = False
    for n in mesh_sizes:
        gshape = (local_shape[0] * n,) + tuple(local_shape[1:])
        mesh = make_mesh((n,), ("x",), dev)
        grid = HaloGrid.create(gshape, halo=spec.radius, dtype=dtype, bc=bc,
                               device=dev)
        method = ShardedKernelStencil(spec, gshape, axis_names=("x",),
                                      dtype=dtype, sweeps_per_call=temporal)
        # the steps on the scattered blocks: iterate() would scatter and
        # gather every call, which is not the steady state's cost
        blocks = method.scatter(grid, mesh)
        scratch = [block.clone() for block in blocks]

        def run(it, blocks=blocks, scratch=scratch, method=method,
                mesh=mesh):
            return method.run_steps(mesh, blocks, scratch, bc, it)

        if not audited and n > 1:
            with comm_audit.audit() as a:
                run(temporal)
            planes = sum(t.shape[0] for t in a.transfers)
            progress(
                f"comm audit: {a.ppermute_count} ppermutes/step, "
                f"{a.ppermute_bytes / 1e6:.2f} MB/rank/step, {planes} "
                f"ghost planes per sharded dim (2*k*r = "
                f"{2 * temporal * spec.radius}; mesh-size independent)")
            audited = True

        m = measure_marginal(run, dev, warmup_iters=temporal,
                             granularity=temporal,
                             min_signal_seconds=MIN_SIGNAL_SECONDS[dev.type])
        glups = math.prod(gshape) / m.seconds_per_iteration / 1e9
        per_rank = glups / n
        if base_per_rank is None:
            base_per_rank = per_rank
        shared = max(mesh.devices.count(d) for d in set(mesh.devices))
        pt = ScalePoint(
            n_devices=n, global_shape=gshape, glups=glups,
            glups_per_chip=per_rank, efficiency=per_rank / base_per_rank,
            ranks_per_device=shared)
        points.append(pt)
        progress(
            f"n={n:3d}  global={'x'.join(map(str, gshape))}  "
            f"{glups:8.2f} GLUPS  {per_rank:7.2f}/rank  "
            f"eff={100 * pt.efficiency:.0f}%"
            + (f"  [{shared} {SHARED_NOTE}]" if shared > 1 else ""))
    return points


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="stencil-tpu-torch-scaling")
    p.add_argument("--local", type=int, nargs="+", default=[64, 128, 128],
                   help="per-rank interior block (weak scaling holds "
                        "this constant)")
    p.add_argument("--spec", type=str, default="jacobi7")
    p.add_argument("-k", "--temporal", type=int, default=4)
    p.add_argument("--mesh-sizes", type=int, nargs="*", default=None,
                   help="ranks per point (default 1, 2, 4, ... up to the "
                        "visible cards; more ranks than cards share them)")
    p.add_argument("--dtype", type=str, default="float32")
    p.add_argument("--periodic", type=int, nargs="*", default=[],
                   help="dims with wrap-around BCs (a periodic sharded "
                        "d0 = the torus-wrapped weak-scaling domain)")
    p.add_argument("--neumann", type=int, nargs="*", default=[],
                   help="dims with zero-flux mirror BCs")
    p.add_argument("--json-out", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda)")
    ns = p.parse_args(argv)
    pts = run_weak_scaling(tuple(ns.local), ns.spec, ns.temporal,
                           ns.mesh_sizes, ns.dtype,
                           periodic=ns.periodic, neumann=ns.neumann,
                           device=ns.device)
    shared = [pt.n_devices for pt in pts if pt.ranks_per_device > 1]
    if shared:
        print(f"note: at n = {shared} {SHARED_NOTE}; efficiency there "
              "falls with the ranks sharing the card's SMs and memory")
    if ns.json_out:
        with open(ns.json_out, "w") as f:
            for pt in pts:
                f.write(json.dumps(dataclasses.asdict(pt)) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
