"""The hand-written CUDA kernel ``csrc/slab_sweep.cu`` (2D), its wrapper
and its plain PyTorch version.

The kernel replaces ``stencil_tpu/ops/pallas.py:build_sweep`` on 2D grids, in
its homogeneous mode and in its source mode (``has_source``): one launch runs k
sweeps of a ``StencilSpec`` over a deep-halo padded float32 or bfloat16 tensor,
Dirichlet ghosts held constant, tiled in both dims where the TPU kernel streams
full-width slabs; with the TPU kernel's lead-dim ``pins``, a periodic or
Neumann d0 face is live, its refreshed ghost rows updated like interior rows.
See the source's header for its design and what bounds it.

``slab_sweep(cur, nxt, plan, src=None, pins=None)`` takes the plain version
(:func:`sweep_reference`: ``plan.sweeps_per_call`` eager sweeps, the
source added after each) only for tensors on the CPU (the tests);
for CUDA tensors it launches the kernel or raises. ``slab_sweep.launches``
counts the launches. The binding and checks are shared with the 3D kernel
(``ops/sweep_kernel.py``).
"""

from __future__ import annotations

from stencil_tpu_torch import _build
from stencil_tpu_torch.ops.sweep_kernel import (  # noqa: F401 (re-export)
    SweepKernel, sweep_reference,
)

SOURCE = _build.PACKAGE_DIR / "csrc" / "slab_sweep.cu"
# where the TPU kernel this one replaces is defined (build_sweep)
REPLACES = "stencil_tpu/ops/pallas.py:280"
# the lead-dim pin bands, skipped on a live face (pins_ref[0/1] == 0)
REPLACES_MODE = {
    "slab_sweep+pins": "stencil_tpu/ops/pallas.py:575",
    "slab_sweep+source+pins": "stencil_tpu/ops/pallas.py:575",
    # the same kernel at dtype=bfloat16 (the slab's dtype, :292)
    "slab_sweep+bf16": "stencil_tpu/ops/pallas.py:292",
    "slab_sweep+source+bf16": "stencil_tpu/ops/pallas.py:586",
    "slab_sweep+pins+bf16": "stencil_tpu/ops/pallas.py:575",
}

slab_sweep = SweepKernel("slab_sweep", SOURCE, REPLACES, ndim=2)

