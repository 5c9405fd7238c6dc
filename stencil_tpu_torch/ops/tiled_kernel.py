"""The hand-written CUDA kernels ``csrc/tiled_sweep.cu`` and
``csrc/tiled_march.cu`` (3D, the window and march schedules of one
kernel), their wrapper and their plain PyTorch version.

The kernel replaces ``stencil_tpu/ops/pallas_tiled.py:build_tiled_sweep``
in six modes and its tile subsets (B1f, ``subset=``: a launch over a list
of tile columns, every mode but the two-level one): homogeneous and
source (``has_source``), where one launch runs k sweeps of a
``StencilSpec`` over a deep-halo padded tensor,
Dirichlet ghosts held constant, optionally adding a padded pre-scaled
source after the taps of every interior update; the Chebyshev
(``cheby_coeffs``) and dual (``cheby_dual``) modes of the multigrid fine
level; the two-level mode (``two_level``) of the wave equation; and the
coefficient mode (``coeff_scales``) of heterogeneous diffusion. The
homogeneous, source, two-level and coefficient modes also take the TPU
kernel's ``pins``: a periodic or Neumann face of d0 or d1 is live, its
refreshed ghosts updated like interior points. Every mode but the
coefficient one runs in float32 or bfloat16 (the plan's dtype; separate C
entries per type). See the source's header for its design and what bounds
it.

The march schedule (``plan.schedule == "march"``, ``ops/tiled.py``)
replaces the window kernel in its homogeneous and source modes, with pins
and tile subsets, in both types: ``csrc/tiled_march.cu`` walks each
(d1, d2) tile's chunk of d0 planes through one shared-memory ring of planes
per sweep level. ``tiled_sweep`` launches it for a march plan (the
library handle ``tiled_march``) and counts the launch also in
``march_launches`` and its mode's ``march_*`` count.

``tiled_sweep(cur, nxt, plan, src=None, pins=None, out2=None, prev=None,
coeff=None, subset=None)`` takes the plain
version (:func:`sweep_reference`) only for tensors on the CPU (the tests);
for CUDA tensors it launches the kernel or raises. The binding, checks and
plain version are shared with the 2D kernel (``ops/sweep_kernel.py``).
"""

from __future__ import annotations

from stencil_tpu_torch import _build
from stencil_tpu_torch.ops.sweep_kernel import (  # noqa: F401 (re-export)
    SweepKernel, sweep_reference, tap_table,
)

SOURCE = _build.PACKAGE_DIR / "csrc" / "tiled_sweep.cu"
# where the TPU kernel this one replaces is defined (build_tiled_sweep)
REPLACES = "stencil_tpu/ops/pallas_tiled.py:704"
# the TPU kernel's body of each mode beyond the homogeneous one
REPLACES_MODE = {
    "tiled_sweep+source": "stencil_tpu/ops/pallas_tiled.py:1326",
    "tiled_sweep+cheby": "stencil_tpu/ops/pallas_tiled.py:1433",
    "tiled_sweep+dual": "stencil_tpu/ops/pallas_tiled.py:1476",
    "tiled_sweep+two_level": "stencil_tpu/ops/pallas_tiled.py:1374",
    "tiled_sweep+coeff": "stencil_tpu/ops/pallas_tiled.py:1195",
    # the pin bands, skipped on a live face (pins_ref[i] == 0)
    "tiled_sweep+pins": "stencil_tpu/ops/pallas_tiled.py:1270",
    "tiled_sweep+source+pins": "stencil_tpu/ops/pallas_tiled.py:1270",
    "tiled_sweep+two_level+pins": "stencil_tpu/ops/pallas_tiled.py:1270",
    "tiled_sweep+coeff+pins": "stencil_tpu/ops/pallas_tiled.py:1270",
    # the same kernel at dtype=bfloat16 (its dtype taken from the plan,
    # :721), each bf16 mode beside the body of its fp32 mode; the coeff
    # mode needs a 4-byte dtype (:451-455)
    "tiled_sweep+bf16": "stencil_tpu/ops/pallas_tiled.py:721",
    "tiled_sweep+source+bf16": "stencil_tpu/ops/pallas_tiled.py:1326",
    "tiled_sweep+cheby+bf16": "stencil_tpu/ops/pallas_tiled.py:1433",
    "tiled_sweep+dual+bf16": "stencil_tpu/ops/pallas_tiled.py:1476",
    "tiled_sweep+two_level+bf16": "stencil_tpu/ops/pallas_tiled.py:1374",
    "tiled_sweep+pins+bf16": "stencil_tpu/ops/pallas_tiled.py:1270",
    "tiled_sweep+source+pins+bf16": "stencil_tpu/ops/pallas_tiled.py:1270",
    "tiled_sweep+two_level+pins+bf16":
        "stencil_tpu/ops/pallas_tiled.py:1270",
    # a launch over a tile subset (B1f: build_tiled_sweep(subset=...), its
    # run list of tile ids at :746-758), the phase split of the overlapped
    # sharded step
    "tiled_sweep+subset": "stencil_tpu/ops/pallas_tiled.py:746",
    "tiled_sweep+source+subset": "stencil_tpu/ops/pallas_tiled.py:746",
    "tiled_sweep+subset+bf16": "stencil_tpu/ops/pallas_tiled.py:746",
    "tiled_sweep+source+subset+bf16": "stencil_tpu/ops/pallas_tiled.py:746",
}

MARCH_SOURCE = _build.PACKAGE_DIR / "csrc" / "tiled_march.cu"
# the TPU kernel body of each march mode (the march replaces the window in
# these; the same TPU lines as the window's rows of these modes)
REPLACES_MODE.update({
    "tiled_march": REPLACES,
    "tiled_march+source": REPLACES_MODE["tiled_sweep+source"],
    "tiled_march+pins": REPLACES_MODE["tiled_sweep+pins"],
    "tiled_march+source+pins": REPLACES_MODE["tiled_sweep+source+pins"],
    "tiled_march+bf16": REPLACES_MODE["tiled_sweep+bf16"],
    "tiled_march+source+bf16": REPLACES_MODE["tiled_sweep+source+bf16"],
    "tiled_march+pins+bf16": REPLACES_MODE["tiled_sweep+pins+bf16"],
    "tiled_march+source+pins+bf16":
        REPLACES_MODE["tiled_sweep+source+pins+bf16"],
    "tiled_march+subset": REPLACES_MODE["tiled_sweep+subset"],
    "tiled_march+source+subset": REPLACES_MODE["tiled_sweep+source+subset"],
    "tiled_march+subset+bf16": REPLACES_MODE["tiled_sweep+subset+bf16"],
    "tiled_march+source+subset+bf16":
        REPLACES_MODE["tiled_sweep+source+subset+bf16"],
})

# the march library (launched through tiled_sweep for a march plan)
tiled_march = SweepKernel("tiled_march", MARCH_SOURCE, REPLACES, ndim=3,
                          schedule="march")
tiled_sweep = SweepKernel("tiled_sweep", SOURCE, REPLACES, ndim=3,
                          march=tiled_march)

