"""Where a step of the in-kernel exchange goes: the kernel
(``csrc/rma_iterate.cu``) built with ``-DRMA_TRACE``, whose first blocks
stamp the global timer at each phase of their first tile's steps (the
start, the wait on the flags done, the window loaded, each sweep done, the
pairs written, the epoch published), run at the bench cell and the
phase-5 sizes; prints per case the median step and the median of each
phase over the traced blocks and steps 8..63, in ns, with the card's name
and power limit. Needs a card:

    python -m stencil_tpu_torch.parallel.rma_trace

The traced build is its own library; the launches ``rma`` makes never
stamp."""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from stencil_tpu_torch import _build
from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, torch_dtype
from stencil_tpu_torch.core.spec import get_spec
from stencil_tpu_torch.ops.sweep_kernel import TAPS_HEADER
from stencil_tpu_torch.parallel.mesh import make_mesh
from stencil_tpu_torch.parallel.rma import RmaKernel, RmaStencil, rma_tiles

# rma_iterate.cu's kTraceBlocks, kTraceSteps, kTracePhases
BLOCKS, STEPS, PHASES = 8, 64, 9
# (global shape, mesh, dtype, neumann dims): the bench cell on (1,), (2, 2),
# with the refresh of --neumann 1 on (2,), in bf16; 8x8x16; 128^3
CASES = (((64, 64, 128), (1,), "float32", ()),
         ((64, 64, 128), (2, 2), "float32", ()),
         ((64, 64, 128), (2,), "float32", (1,)),
         ((64, 64, 128), (1,), "bfloat16", ()),
         ((8, 8, 16), (1,), "float32", ()),
         ((128, 128, 128), (1,), "float32", ()))


class TracedRmaKernel(RmaKernel):
    """The kernel built with ``-DRMA_TRACE``; :meth:`stamps` reads the
    last launch's stamps."""

    name = "rma_iterate_trace"

    def build(self) -> _build.BuildResult:
        return _build.build(_build.find_nvcc(), [self.source],
                            _build.NVCC_FLAGS + ("-DRMA_TRACE",), self.name,
                            headers=[TAPS_HEADER])

    def stamps(self) -> np.ndarray:
        lib = ctypes.CDLL(str(self.build().path))
        out = np.zeros((BLOCKS, STEPS, PHASES), np.uint64)
        rc = lib.rma_iterate_trace(ctypes.c_void_p(out.ctypes.data))
        if rc != 0:
            raise RuntimeError(f"reading the stamps failed ({rc})")
        return out.astype(np.int64)


def phases(stamps: np.ndarray, k: int) -> dict:
    """Median ns per step and per phase over the blocks and steps 8..63."""
    s = stamps[:, 8:, :]
    marks = [s[..., i] for i in (0, 1, 2)] + [s[..., 2 + t]
                                              for t in range(1, k + 1)]
    marks += [s[..., 7], s[..., 8]]
    names = (["wait", "load"] + [f"sweep {t}" for t in range(1, k + 1)]
             + ["pairs", "publish"])
    out = {"step": int(np.median(np.diff(stamps[:, 8:, 0], axis=1)))}
    for name, a, b in zip(names, marks, marks[1:]):
        out[name] = int(np.median(b - a))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("the trace runs the CUDA kernel: it needs a card",
              file=sys.stderr)
        return 1
    label = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(label)
    kernel = TracedRmaKernel()
    device = torch.device("cuda", 0)
    spec = get_spec("jacobi7")
    for shape, sizes, dtype, neumann in CASES:
        bc = DirichletBC(values=((0.5, -1.0), (2.0, 0.25), (1.0, 1.5)))
        if neumann:
            bc = bc.with_neumann(neumann)
        x = torch.rand(shape, generator=torch.Generator().manual_seed(0))
        grid = HaloGrid.from_interior(x.to(torch_dtype(dtype)), halo=1,
                                      bc=bc, device=device)
        mesh = make_mesh(sizes, ("x", "y")[:len(sizes)], device=device)
        method = RmaStencil(spec, shape, dtype, 2)
        plan = method.plan_for(mesh, bc)
        bufs = method.scatter(grid, mesh, plan)
        for _ in range(3):
            kernel(bufs, plan, STEPS)
        torch.cuda.synchronize()
        ph = phases(kernel.stamps(), plan.sweeps_per_call)
        walls = f"neumann {neumann}" if neumann else "dirichlet"
        print(f"jacobi7 {shape} mesh {sizes} k=2 {dtype} {walls}, tile "
              f"{plan.tile} x{rma_tiles(plan).ntiles}: step {ph.pop('step')}"
              " ns; " + ", ".join(f"{k} {v}" for k, v in ph.items())
              + f" [{label}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
