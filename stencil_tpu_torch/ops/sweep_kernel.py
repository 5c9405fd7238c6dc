"""What the hand-written sweep kernels share: their ``ctypes`` binding, the
checks and launch of their wrappers, and their plain PyTorch version.

Two kernels sit behind it, one source each: ``csrc/tiled_sweep.cu`` (3D,
``ops/tiled_kernel.py``) and ``csrc/slab_sweep.cu`` (2D,
``ops/slab_kernel.py``); both include the tap evaluator
``csrc/stencil_taps.cuh``. They take the same C arguments: the padded input
and output, an optional padded source, the plan's int32 geometry, the tap
table in ``weight_groups`` order, the device and the stream. Each launch
runs ``plan.sweeps_per_call`` sweeps with the Dirichlet ghosts held
constant, and agrees bitwise with :func:`sweep_reference`.

The 3D kernel has two more modes, for a plan with ``cheby_coeffs``
(the multigrid smoothers): the Chebyshev recurrence
``u_t = n_t*S(u_{t-1}) + c_t*u_{t-1} + pv_t*u_{t-2} + s_t*f`` over the raw
padded ``f``, and its dual form (``plan.cheby_dual``), which also writes
sweep k-1 to a second output. They have their own C entry,
``stencil_<name>_cheby``, which takes the coefficients as float32[4k] and
the second output pointer.

A wrapper takes the plain version only for tensors on the CPU (the tests);
for CUDA tensors it launches the kernel or raises. :class:`KernelStencil`
is the iterate both user-facing handles (``TiledStencil``,
``SlabStencil``) run.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch import _build
from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, check_device
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.ops.layout import pad_source

TAPS_HEADER = _build.PACKAGE_DIR / "csrc" / "stencil_taps.cuh"


def tap_table(spec):
    """The spec's taps in ``weight_groups`` order, as the kernels take
    them: (offsets int32[ntaps*ndim], group sizes int32, group weights
    float32, uniform flag, uniform weight)."""
    groups = spec.weight_groups()
    offsets = np.asarray([off for _, offs in groups for off in offs],
                         dtype=np.int32).reshape(-1)
    sizes = np.asarray([len(offs) for _, offs in groups], dtype=np.int32)
    weights = np.asarray([w for w, _ in groups], dtype=np.float32)
    uw = spec.uniform_weight
    return offsets, sizes, weights, uw is not None, float(
        np.float32(uw if uw is not None else 0.0))


def cheby_of(plan) -> Tuple[Tuple[float, float, float, float], ...]:
    """The plan's Chebyshev coefficients, each rounded to float32 once
    (kernel and plain version use these values); () outside that mode."""
    return tuple(tuple(float(np.float32(v)) for v in c)
                 for c in getattr(plan, "cheby_coeffs", ()))


@functools.lru_cache(maxsize=64)
def launch_tables(plan):
    """The host arrays one launch of ``plan`` passes (geometry, then
    :func:`tap_table`, then the Chebyshev coefficients as float32[4k], empty
    outside that mode), built once per plan rather than per launch."""
    return (np.asarray(plan.kernel_geometry(), dtype=np.int32),
            *tap_table(plan.spec),
            np.asarray(cheby_of(plan), dtype=np.float32).reshape(-1))


def _cheby_reference(cur: torch.Tensor, plan, src: torch.Tensor):
    """Plain version of the Chebyshev modes, in the kernel's per-point
    order: ``((n*S(u) + c*u) + s*f) + pv*prev``, each a whole-array eager
    op with the float32-rounded coefficient, no ``prev`` term at t = 1."""
    h = plan.layout.halo
    idx = plan.layout.interior_index
    f = src[idx]
    prev, u = None, cur
    outs = []
    for t, (c, n, pv, s) in enumerate(cheby_of(plan), 1):
        y = eager.apply_spec(u, plan.spec, halo=h)
        y.mul_(n)
        y.add_(u[idx] * c)
        y.add_(f * s)
        if t >= 2:
            y.add_(prev[idx] * pv)
        nxt = cur.clone()
        nxt[idx] = y
        prev, u = u, nxt
        outs.append(nxt)
    return (outs[-1], outs[-2]) if plan.cheby_dual else outs[-1]


def sweep_reference(cur: torch.Tensor, plan,
                    src: Optional[torch.Tensor] = None):
    """Plain version of a sweep kernel: ``plan.sweeps_per_call``
    whole-array eager sweeps of the padded tensor ``cur``, ghosts held
    constant. With ``src`` (padded like ``cur``), each sweep adds its
    interior after the taps. Returns a new padded tensor; ``cur`` is
    unchanged.

    A plan with ``cheby_coeffs`` runs the Chebyshev recurrence over the raw
    ``src`` instead; in its dual mode the result is the pair ``(sweep k,
    sweep k-1)``, the residual and the smoothed iterate."""
    if getattr(plan, "cheby_coeffs", ()):
        return _cheby_reference(cur, plan, src)
    h = plan.layout.halo
    a = cur.clone()
    b = cur.clone()
    idx = plan.layout.interior_index
    source = src[idx] if src is not None else None
    scratch = torch.empty_like(a[idx]) \
        if len(plan.spec.weight_groups()) > 1 else None
    for _ in range(plan.sweeps_per_call):
        eager.apply_spec(a, plan.spec, halo=h, out=b[idx], scratch=scratch)
        if source is not None:
            b[idx].add_(source)
        a, b = b, a
    return a


class SweepKernel:
    """One hand-written sweep kernel: its build, its wrapper (call it as
    ``kernel(cur, nxt, plan, src=None, out2=None)``) and its counts of
    launches: ``launches`` in all, of them ``source_launches`` in source
    mode, ``cheby_launches`` in Chebyshev mode and ``dual_launches`` in
    its dual mode.

    ``name`` names the library and its C entry ``stencil_<name>``;
    ``source`` is the ``.cu`` file; ``replaces`` is where the TPU kernel
    it replaces is defined."""

    def __init__(self, name: str, source: Path, replaces: str, ndim: int):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.ndim = ndim
        # kernel launches since the last reset (plain-version calls do not
        # count)
        self.launches = 0
        self.source_launches = 0
        self.cheby_launches = 0
        self.dual_launches = 0

    def reset_counts(self) -> None:
        self.launches = self.source_launches = 0
        self.cheby_launches = self.dual_launches = 0

    def build(self) -> _build.BuildResult:
        """Compile the source (cached by content). Raises
        ``_build.BuildError`` with the compiler's stderr on failure."""
        return _build.build(_build.find_nvcc(), [self.source],
                            _build.NVCC_FLAGS, self.name,
                            headers=[TAPS_HEADER])

    @functools.cached_property
    def _entry(self):
        lib = ctypes.CDLL(str(self.build().path))
        fn = getattr(lib, f"stencil_{self.name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # in (device)
            ctypes.c_void_p,  # out (device)
            ctypes.c_void_p,  # padded source (device), or null
            ctypes.c_void_p,  # geometry, int32 (host)
            ctypes.c_int,     # geometry length
            ctypes.c_void_p,  # tap offsets, int32[ntaps * ndim] (host)
            ctypes.c_void_p,  # group sizes, int32[ngroups] (host)
            ctypes.c_void_p,  # group weights, float32[ngroups] (host)
            ctypes.c_int,     # ntaps
            ctypes.c_int,     # ngroups
            ctypes.c_int,     # uniform
            ctypes.c_float,   # uniform weight
            ctypes.c_int,     # device index
            ctypes.c_void_p,  # cudaStream_t
        ]
        err = getattr(lib, f"stencil_{self.name}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        cheby = getattr(lib, f"stencil_{self.name}_cheby", None)
        if cheby is not None:
            cheby.restype = ctypes.c_int
            cheby.argtypes = [
                ctypes.c_void_p,  # in (device)
                ctypes.c_void_p,  # out (device)
                ctypes.c_void_p,  # out2 (device), or null
                ctypes.c_void_p,  # padded raw source (device)
                ctypes.c_void_p,  # geometry, int32 (host)
                ctypes.c_int,     # geometry length
                ctypes.c_void_p,  # coefficients, float32[4k] (host)
                ctypes.c_int,     # coefficient count, 4k
                *fn.argtypes[5:],  # the tap table, device and stream
            ]
        return fn, err, cheby

    def library(self):
        """Build and load the library; returns its C entry
        ``stencil_<name>``."""
        return self._entry[0]

    def check(self, cur: torch.Tensor, nxt: torch.Tensor, plan,
              src: Optional[torch.Tensor] = None, pins=None,
              out2: Optional[torch.Tensor] = None) -> None:
        """Raise ``ValueError`` on what the kernel does not take."""
        # one pin per face of every dim but the last (the TPU kernels' own)
        all_pinned = (1,) * (2 * (self.ndim - 1))
        if pins is not None and tuple(int(p) for p in pins) != all_pinned:
            raise ValueError(
                f"pins {tuple(pins)}: only all-ones (every Dirichlet face "
                "pinned) is ported; dynamic and mesh-internal faces are not")
        if plan.dtype != "float32":
            raise ValueError(f"{self.name} dtype {plan.dtype!r}: only "
                             "float32 is ported")
        cheby = bool(getattr(plan, "cheby_coeffs", ()))
        dual = cheby and plan.cheby_dual
        if cheby and src is None:
            raise ValueError("a cheby_coeffs plan needs the padded source f")
        if dual != (out2 is not None):
            raise ValueError("out2 goes with a cheby_dual plan, and only "
                             "with one")
        shape = plan.layout.padded_shape
        tensors = (("cur", cur), ("nxt", nxt))
        if src is not None:
            tensors += (("src", src),)
        if out2 is not None:
            tensors += (("out2", out2),)
        for name, t in tensors:
            if t.dtype != torch.float32:
                raise ValueError(f"{name} dtype {t.dtype} != torch.float32")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} shape {tuple(t.shape)} != padded "
                                 f"layout {shape}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.device != cur.device:
                raise ValueError(f"cur on {cur.device}, {name} on "
                                 f"{t.device}")
        ptrs = [t.data_ptr() for t in (cur, nxt, out2) if t is not None]
        if len(set(ptrs)) != len(ptrs):
            raise ValueError("cur, nxt and out2 must be distinct tensors")

    def __call__(self, cur: torch.Tensor, nxt: torch.Tensor, plan,
                 src: Optional[torch.Tensor] = None, pins=None,
                 out2: Optional[torch.Tensor] = None):
        """``plan.sweeps_per_call`` sweeps of ``cur`` into the interior of
        ``nxt`` (both padded per ``plan.layout``; ``nxt``'s ghosts must
        already hold the BC), adding the padded source ``src`` after the
        taps of every interior update when given. Returns ``nxt``.

        A plan with ``cheby_coeffs`` runs the Chebyshev recurrence with the
        plan's coefficients over the padded raw ``src`` (required); a
        ``cheby_dual`` plan also takes ``out2`` (padded, ghosts holding the
        BC), receives sweep k-1 there and sweep k in ``nxt``, and returns
        ``(nxt, out2)``.

        A CUDA tensor launches the kernel on the current stream (no
        synchronisation) and raises ``RuntimeError`` if the launch fails;
        a CPU tensor runs :func:`sweep_reference`. ``pins`` other than all
        ones is refused."""
        self.check(cur, nxt, plan, src, pins, out2)
        if cur.device.type == "cpu":
            want = sweep_reference(cur, plan, src)
            if out2 is None:
                nxt.copy_(want)
                return nxt
            nxt.copy_(want[0])
            out2.copy_(want[1])
            return nxt, out2
        if cur.device.type != "cuda":
            raise ValueError(f"{self.name} runs on cuda (or cpu for the "
                             f"plain version), not {cur.device}")
        fn, err, cheby_fn = self._entry
        geom, offsets, sizes, weights, uniform, uw, coeffs = \
            launch_tables(plan)
        device = cur.device.index if cur.device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        taps = (offsets.ctypes.data, sizes.ctypes.data, weights.ctypes.data,
                len(offsets) // self.ndim, len(sizes), int(uniform), uw,
                device, stream)
        if len(coeffs):
            if cheby_fn is None:
                raise ValueError(f"{self.name} has no Chebyshev mode")
            rc = cheby_fn(cur.data_ptr(), nxt.data_ptr(),
                          out2.data_ptr() if out2 is not None else None,
                          src.data_ptr(), geom.ctypes.data, len(geom),
                          coeffs.ctypes.data, len(coeffs), *taps)
        else:
            rc = fn(cur.data_ptr(), nxt.data_ptr(),
                    src.data_ptr() if src is not None else None,
                    geom.ctypes.data, len(geom), *taps)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed ({rc}): "
                               f"{err(rc).decode()}")
        self.launches += 1
        if out2 is not None:
            self.dual_launches += 1
            return nxt, out2
        if len(coeffs):
            self.cheby_launches += 1
        else:
            self.source_launches += src is not None
        return nxt


class KernelStencil:
    """k sweeps per launch of ``kernel`` over a Dirichlet ``HaloGrid`` on
    ``device``: the iterate of ``TiledStencil`` and ``SlabStencil``.

    ``source`` (interior-shaped, static; numpy or torch) makes every sweep
    the affine update ``u' = S(u) + source_scale * source``; it is padded
    once per BC (:func:`pad_source`) and passed to every launch, the
    remainder launch included.

    ``iterate`` pads the grid once into two deep-halo tensors, runs
    ``iterations // k`` launches and one launch of ``iterations % k``
    sweeps, swapping the two tensors after each, and unpads once."""

    kernel: SweepKernel
    # the JAX code whose pins a later port needs for dynamic walls
    pins_of: str

    def __init__(self, plan, device, source=None, source_scale=1.0):
        self.device = check_device(device)
        self.plan = plan
        self.spec = plan.spec
        if source is not None \
                and tuple(np.shape(source)) != plan.interior_shape:
            raise ValueError(f"source shape {tuple(np.shape(source))} != "
                             f"interior {plan.interior_shape}")
        self.source = source
        self.source_scale = source_scale
        self._src_padded = {}  # bc -> padded source on self.device

    def padded_source(self, bc: DirichletBC) -> torch.Tensor:
        if bc not in self._src_padded:
            self._src_padded[bc] = pad_source(
                self.plan, self.source, self.source_scale, bc
            ).to(self.device)
        return self._src_padded[bc]

    def iterate(self, grid: HaloGrid, iterations: int) -> HaloGrid:
        plan = self.plan
        if getattr(plan, "cheby_dual", False):
            raise ValueError("a cheby_dual plan has two outputs; run it "
                             "through ops.tiled.cheby_dual, not iterate")
        if grid.dtype != torch.float32:
            raise ValueError(f"grid dtype {grid.dtype} != plan dtype "
                             f"{plan.dtype}")
        if grid.device != self.device:
            raise ValueError(f"grid on {grid.device}, stencil on "
                             f"{self.device}")
        if grid.interior_shape != plan.interior_shape:
            raise ValueError(f"grid interior {grid.interior_shape} != plan "
                             f"{plan.interior_shape}")
        if grid.bc.any_dynamic:
            raise NotImplementedError(
                f"periodic/Neumann walls on the {self.kernel.name} kernel "
                f"are not ported yet (needs the kernel's pins; "
                f"{self.pins_of}); use the eager method")
        src = None if self.source is None else self.padded_source(grid.bc)
        k = plan.sweeps_per_call
        n_outer, rem = divmod(iterations, k)
        cur = plan.layout.pad_grid(grid)
        nxt = cur.clone()
        for _ in range(n_outer):
            self.kernel(cur, nxt, plan, src)
            cur, nxt = nxt, cur
        if rem:
            self.kernel(cur, nxt, plan.with_sweeps(rem), src)
            cur, nxt = nxt, cur
        return HaloGrid.from_interior(plan.layout.unpad(cur),
                                      halo=grid.halo, bc=grid.bc,
                                      device=grid.device)
