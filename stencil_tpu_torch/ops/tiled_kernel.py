"""The hand-written CUDA kernels ``csrc/tiled_sweep.cu`` and
``csrc/tiled_march.cu`` (3D, the window and march schedules of one
kernel) and ``csrc/coeff_weights.cu`` (the coefficient mode's weights),
their wrappers and their plain PyTorch versions.

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
replaces the window kernel in its homogeneous, source, two-level,
Chebyshev and dual modes, in both types, and in its coefficient mode, each
with pins and (but the two-level mode) tile subsets:
``csrc/tiled_march.cu`` walks each (d1, d2) tile's chunk of d0 planes
through one shared-memory ring of planes per sweep level.
``tiled_sweep`` launches it for a march plan (the library handle
``tiled_march``) and counts the launch also in ``march_launches`` and its
mode's ``march_*`` count. A homogeneous float32 march launch of
jacobi7's tap table (six radius-1 taps in one group of uniform weight) at
k <= 8 runs the march's point-table kernel (:func:`point_tables`, which
asks the march library once per plan; entry
``stencil_tiled_march_tables``), which forms each thread's points, their
offsets and their interior bits once per launch; it counts again in
``march_table_launches``. The split follows the plan and the launch, not
a setting: every other launch runs ``tiled_march_kernel``. A march
coefficient launch reads the four weight fields that
``coeff_weights(coeff, plan)`` forms from the padded a(x) once per run
(``csrc/coeff_weights.cu``; plain version
``sweep_kernel.coeff_weights_reference``; count ``launches``), in place
of the a(x) the window reads.

``tiled_sweep(cur, nxt, plan, src=None, pins=None, out2=None, prev=None,
coeff=None, subset=None)`` takes the plain
version (:func:`sweep_reference`) only for tensors on the CPU (the tests);
for CUDA tensors it launches the kernel or raises. The binding, checks and
plain version are shared with the 2D kernel (``ops/sweep_kernel.py``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from stencil_tpu_torch import _build
from stencil_tpu_torch.ops.sweep_kernel import (  # noqa: F401 (re-export)
    SweepKernel, all_pinned, coeff_of, coeff_weights_reference,
    launch_tables, sweep_reference, tap_table,
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
    "tiled_march+coeff": REPLACES_MODE["tiled_sweep+coeff"],
    "tiled_march+coeff+pins": REPLACES_MODE["tiled_sweep+coeff+pins"],
    "tiled_march+two_level": REPLACES_MODE["tiled_sweep+two_level"],
    "tiled_march+two_level+pins":
        REPLACES_MODE["tiled_sweep+two_level+pins"],
    "tiled_march+two_level+bf16":
        REPLACES_MODE["tiled_sweep+two_level+bf16"],
    "tiled_march+two_level+pins+bf16":
        REPLACES_MODE["tiled_sweep+two_level+pins+bf16"],
    "tiled_march+cheby": REPLACES_MODE["tiled_sweep+cheby"],
    "tiled_march+dual": REPLACES_MODE["tiled_sweep+dual"],
    "tiled_march+cheby+bf16": REPLACES_MODE["tiled_sweep+cheby+bf16"],
    "tiled_march+dual+bf16": REPLACES_MODE["tiled_sweep+dual+bf16"],
    "tiled_march+cheby+subset": REPLACES_MODE["tiled_sweep+subset"],
    "tiled_march+dual+subset": REPLACES_MODE["tiled_sweep+subset"],
})

WEIGHTS_SOURCE = _build.PACKAGE_DIR / "csrc" / "coeff_weights.cu"
# the TPU kernel's weight synthesis of the coefficient mode (prep_weights)
REPLACES_MODE["coeff_weights"] = "stencil_tpu/ops/pallas_tiled.py:871"


def point_tables(plan, src=None) -> bool:
    """Whether a launch of ``plan`` with the padded source ``src`` runs the
    march's point-table kernel: a march plan in the homogeneous mode (no
    source, Chebyshev, dual, two-level or coefficient) in float32, which
    the march library's point-table kernel takes
    (``stencil_tiled_march_tables_fit``: jacobi7's tap table, six radius-1
    taps in one group of uniform weight, k <= 8, every level's plane within
    the passes of its instance), asked once per plan. Every other launch
    runs ``tiled_march_kernel``."""
    return src is None and getattr(plan, "schedule", "window") == "march" \
        and plan.dtype == "float32" and not (
            plan.cheby_coeffs or plan.two_level or plan.has_coeff) \
        and _tables_fit(plan)


@functools.lru_cache(maxsize=64)
def _tables_fit(plan) -> bool:
    geom, offsets, sizes, weights, uniform, uw, _ = launch_tables(
        plan, all_pinned(3))
    return tiled_march._entry["tables_fit"](
        geom.ctypes.data, len(geom), offsets.ctypes.data, sizes.ctypes.data,
        weights.ctypes.data, len(offsets) // 3, len(sizes), int(uniform),
        uw) == 1


# the march library (launched through tiled_sweep for a march plan)
tiled_march = SweepKernel("tiled_march", MARCH_SOURCE, REPLACES, ndim=3,
                          schedule="march")
tiled_sweep = SweepKernel("tiled_sweep", SOURCE, REPLACES, ndim=3,
                          march=tiled_march, tables=point_tables)



class WeightsKernel:
    """The hand-written kernel ``csrc/coeff_weights.cu``: its build, its
    wrapper (``coeff_weights(coeff, plan)``) and its count of launches,
    ``launches`` (plain-version calls do not count)."""

    name = "coeff_weights"

    def __init__(self):
        self.source = WEIGHTS_SOURCE
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = 0

    def build(self) -> _build.BuildResult:
        """Compile the source (cached by content). Raises
        ``_build.BuildError`` with the compiler's stderr on failure."""
        return _build.build(_build.find_nvcc(), [self.source],
                            _build.NVCC_FLAGS, self.name)

    @functools.cached_property
    def _entries(self):
        lib = ctypes.CDLL(str(self.build().path))
        P, I = ctypes.c_void_p, ctypes.c_int
        fn = lib.stencil_coeff_weights
        fn.restype = I
        # a, w (device); padded shape int32[3] and (nb, c0, cs) float32[3]
        # (host), each with its length; device, stream
        fn.argtypes = [P, P, P, I, P, I, I, P]
        err = lib.stencil_coeff_weights_error
        err.restype = ctypes.c_char_p
        err.argtypes = [I]
        return fn, err

    def library(self):
        """Build and load the library; returns its C entry."""
        return self._entries[0]

    def __call__(self, coeff: torch.Tensor, plan) -> torch.Tensor:
        """The four weight fields ``[4, *padded]`` (float32) of the
        coefficient mode of ``plan`` over the padded coefficient ``coeff``
        (``ops/tiled.py:pad_coeff``), as a new tensor on its device.

        A CUDA tensor launches the kernel on the current stream (no
        synchronisation) and raises ``RuntimeError`` if the launch fails;
        a CPU tensor runs :func:`coeff_weights_reference`."""
        if not getattr(plan, "has_coeff", False):
            raise ValueError("coeff_weights() takes a coeff_scales plan")
        shape = plan.layout.padded_shape
        if coeff.dtype != torch.float32 or tuple(coeff.shape) != shape \
                or not coeff.is_contiguous():
            raise ValueError(f"coeff must be a contiguous float32 tensor of "
                             f"the padded layout {shape}, not "
                             f"{coeff.dtype} {tuple(coeff.shape)}")
        if coeff.device.type == "cpu":
            return coeff_weights_reference(coeff, plan)
        if coeff.device.type != "cuda":
            raise ValueError(f"{self.name} runs on cuda (or cpu for the "
                             f"plain version), not {coeff.device}")
        fn, err = self._entries
        w = torch.empty((4, *shape), dtype=torch.float32,
                        device=coeff.device)
        dims = np.asarray(shape, dtype=np.int32)
        scales = np.asarray(coeff_of(plan), dtype=np.float32)
        device = coeff.device.index if coeff.device.index is not None \
            else torch.cuda.current_device()
        rc = fn(coeff.data_ptr(), w.data_ptr(), dims.ctypes.data, len(dims),
                scales.ctypes.data, len(scales), device,
                torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed ({rc}): "
                               f"{err(rc).decode()}")
        self.launches += 1
        return w


coeff_weights = WeightsKernel()
