"""The hand-written CUDA kernels ``csrc/slab_sweep.cu`` and
``csrc/slab_march.cu`` (2D, the window and march schedules of one kernel),
their wrapper and their plain PyTorch version.

The kernel replaces ``stencil_tpu/ops/pallas.py:build_sweep`` on 2D grids, in
its homogeneous mode and in its source mode (``has_source``): one launch runs k
sweeps of a ``StencilSpec`` over a deep-halo padded float32 or bfloat16 tensor,
Dirichlet ghosts held constant, tiled in both dims where the TPU kernel streams
full-width slabs; with the TPU kernel's lead-dim ``pins``, a periodic or
Neumann d0 face is live, its refreshed ghost rows updated like interior rows.
See the sources' headers for their designs and what bounds them.

The march schedule (``plan.schedule == "march"``, ``ops/slab.py``) runs
every mode of the window: ``csrc/slab_march.cu`` walks each strip's chunk
of d0 rows through one shared-memory ring of rows per sweep level.
``slab_sweep`` launches it for a march plan (the library handle
``slab_march``) and counts the launch also in ``march_launches`` and its
mode's count (``march_source_launches``, ``march_pins_launches``,
``march_source_pins_launches``, ``march_bf16_launches``); a march plan on
a CUDA tensor launches the march or raises.

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


MARCH_SOURCE = _build.PACKAGE_DIR / "csrc" / "slab_march.cu"
# the TPU kernel body of each march mode (the march runs every mode of the
# window; the same TPU lines as the window's rows)
REPLACES_MODE.update({
    "slab_march": REPLACES,
    "slab_march+source": "stencil_tpu/ops/pallas.py:586",
    "slab_march+pins": REPLACES_MODE["slab_sweep+pins"],
    "slab_march+source+pins": REPLACES_MODE["slab_sweep+source+pins"],
    "slab_march+bf16": REPLACES_MODE["slab_sweep+bf16"],
    "slab_march+source+bf16": REPLACES_MODE["slab_sweep+source+bf16"],
    "slab_march+pins+bf16": REPLACES_MODE["slab_sweep+pins+bf16"],
    "slab_march+source+pins+bf16": "stencil_tpu/ops/pallas.py:575",
})

# the march library (launched through slab_sweep for a march plan)
slab_march = SweepKernel("slab_march", MARCH_SOURCE, REPLACES, ndim=2,
                         schedule="march")
slab_sweep = SweepKernel("slab_sweep", SOURCE, REPLACES, ndim=2,
                         march=slab_march)

