"""What the hand-written sweep kernels share: their ``ctypes`` binding, the
checks and launch of their wrappers, and their plain PyTorch version.

Two kernels sit behind it, each with a window and a march schedule
(below), one source each: ``csrc/tiled_sweep.cu`` (3D,
``ops/tiled_kernel.py``) and ``csrc/slab_sweep.cu`` (2D,
``ops/slab_kernel.py``) for the windows; all include the tap evaluator
``csrc/stencil_taps.cuh``. They take the same C arguments: the padded input
and output, an optional padded source, the plan's int32 geometry, the tap
table in ``weight_groups`` order, the device and the stream. Each launch
runs ``plan.sweeps_per_call`` sweeps with the Dirichlet ghosts held
constant, and agrees bitwise with :func:`sweep_reference`.

The geometry ends in the launch's ``pins``, one flag per face of every dim
but the last (the TPU kernels' own, ``pallas_tiled.py:_dynamic_pins`` and
``pallas.py:_cached_iterate``): 1 for a pinned (Dirichlet) face, 0 for a
live one, a periodic or Neumann wall whose ghosts the caller refreshed to
the launch's full depth k*r (:func:`~stencil_tpu_torch.ops.layout.
refresh_dynamic_layout`). At sweep t a point beyond a live face is updated
like an interior one while its padded index lies in [t*r, P - t*r); every
other ghost is held. The Chebyshev modes take every face pinned.

The 3D kernel has four more modes, each with its own C entry. For a plan
with ``cheby_coeffs`` (the multigrid smoothers), ``stencil_<name>_cheby``:
the Chebyshev recurrence ``u_t = n_t*S(u_{t-1}) + c_t*u_{t-1} +
pv_t*u_{t-2} + s_t*f`` over the raw padded ``f``, and its dual form
(``plan.cheby_dual``), which also writes sweep k-1 to a second output; it
takes the coefficients as float32[4k]. For a ``two_level`` plan (the wave
equation), ``stencil_<name>_two_level``: the leapfrog ``L_t = S(L_{t-1}) -
L_{t-2}`` from two padded levels, sweeps k and k-1 to two outputs. For a
plan with ``coeff_scales`` (heterogeneous diffusion),
``stencil_<name>_coeff``: the radius-1 operator whose face weights are
``nb * harm(a(p), a(p +- e_d))`` of a padded coefficient field and whose
center is ``c0 + cs * (sum of the six face means)``. On the window
schedule it takes the padded a(x) and (nb, c0, cs) as float32[3], and
forms the weights at every update; on the march it takes the four weight
fields that ``csrc/coeff_weights.cu`` forms once per run
(:func:`coeff_weights_reference`, ``ops/tiled.py:coeff_operand``).

The 3D kernel's entries but the two-level one also take a tile subset
(B1f, ``build_tiled_sweep(subset=...)``): a device int32 list of tile
columns, each an (i0, i1) pair with all of its d2 tiles
(``ops/tiled.py:partition_tiles``), after the geometry; a launch with one
sweeps those columns only and leaves every other point of its outputs as
it was. The list is built once per subset and device and kept there
(:func:`column_ids`).

Each entry has a twin for bfloat16 tensors, ``stencil_<name>..._bf16``
(none for the coefficient mode, which is float32 only, as in JAX): the
same arguments, the windows and every tensor in bfloat16, every add and
multiply computed in float32 and rounded to bfloat16, as the plain version
computes them in torch. The tap weights and the mode's coefficients travel
as float32 either way, each rounded once to the plan dtype on the host
(:func:`~stencil_tpu_torch.ops.eager.round_to`).

The 3D kernel has a second schedule, the d0 march (``csrc/tiled_march.cu``,
``plan.schedule == "march"``): the homogeneous and source modes, in both
types, through entries ``stencil_tiled_march`` and
``stencil_tiled_march_bf16`` of the arguments of ``stencil_tiled_sweep``,
the two-level mode through ``stencil_tiled_march_two_level`` and its
``_bf16`` twin (the arguments of ``stencil_tiled_sweep_two_level``), the
Chebyshev and dual modes through ``stencil_tiled_march_cheby`` and its
``_bf16`` twin (the arguments of ``stencil_tiled_sweep_cheby``), and the
coefficient mode through ``stencil_tiled_march_coeff`` (the weights in
place of a(x), no scales), each with pins (every face pinned in the
Chebyshev modes) and, but the two-level one, tile subsets. The
2D kernel has one too (``csrc/slab_march.cu``): every mode of the window,
through ``stencil_slab_march`` and ``stencil_slab_march_bf16`` of the
arguments of ``stencil_slab_sweep``. Each wrapper launches the march for a
march plan and the window kernel for a window plan.

A wrapper takes the plain version only for tensors on the CPU (the tests);
for CUDA tensors it launches the kernel or raises. :class:`KernelStencil`
is the iterate both user-facing handles (``TiledStencil``,
``SlabStencil``) run.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch import _build
from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, check_device, torch_dtype,
)
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.ops.eager import round_to
from stencil_tpu_torch.ops.layout import pad_source, refresh_dynamic_layout
from stencil_tpu_torch.utils.tracing import span

TAPS_HEADER = _build.PACKAGE_DIR / "csrc" / "stencil_taps.cuh"


def tap_table(spec, dtype="float32"):
    """The spec's taps in ``weight_groups`` order, as the kernels take
    them: (offsets int32[ntaps*ndim], group sizes int32, group weights
    float32, uniform flag, uniform weight), each weight rounded once to
    ``dtype`` (the plan's), as the plain version multiplies by it."""
    groups = spec.weight_groups()
    offsets = np.asarray([off for _, offs in groups for off in offs],
                         dtype=np.int32).reshape(-1)
    sizes = np.asarray([len(offs) for _, offs in groups], dtype=np.int32)
    weights = np.asarray([round_to(w, dtype) for w, _ in groups],
                         dtype=np.float32)
    uw = spec.uniform_weight
    return offsets, sizes, weights, uw is not None, round_to(
        uw if uw is not None else 0.0, dtype)


def cheby_of(plan) -> Tuple[Tuple[float, float, float, float], ...]:
    """The plan's Chebyshev coefficients, each rounded once to the plan
    dtype (kernel and plain version use these values, exact in float32);
    () outside that mode."""
    return tuple(tuple(round_to(v, plan.dtype) for v in c)
                 for c in getattr(plan, "cheby_coeffs", ()))


def coeff_of(plan) -> Tuple[float, ...]:
    """The plan's coefficient-mode scales (nb, c0, cs), each rounded once
    to the plan dtype, float32 (kernel and plain version use these
    values); () outside that mode."""
    return tuple(round_to(v, plan.dtype)
                 for v in getattr(plan, "coeff_scales", ()))


def all_pinned(ndim: int) -> Tuple[int, ...]:
    """The pins of a launch with every face pinned (Dirichlet walls)."""
    return (1,) * (2 * (ndim - 1))


@functools.lru_cache(maxsize=64)
def launch_tables(plan, pins: Tuple[int, ...]):
    """The host arrays one launch of ``plan`` with ``pins`` passes
    (geometry and pins, then :func:`tap_table`, then the mode's scalars as
    float32: the Chebyshev coefficients [4k] or the coefficient mode's (nb,
    c0, cs), empty otherwise), built once per plan and pins rather than per
    launch."""
    return (np.asarray((*plan.kernel_geometry(), *pins), dtype=np.int32),
            *tap_table(plan.spec, plan.dtype),
            np.asarray(cheby_of(plan) or coeff_of(plan),
                       dtype=np.float32).reshape(-1))


def update_boxes(plan, pins: Tuple[int, ...]) -> Tuple[tuple, ...]:
    """The region each sweep of a launch updates, as one index tuple of the
    padded tensor per sweep t = 1..k: the interior, widened on each live
    face to padded index t*r (lo) or P - t*r (hi). A live update at sweep
    t reads [(t-1)*r, P - (t-1)*r), inside the padded array."""
    h, r = plan.layout.halo, plan.spec.radius
    shape = plan.layout.padded_shape
    boxes = []
    for t in range(1, plan.sweeps_per_call + 1):
        box = []
        for d, n in enumerate(plan.interior_shape):
            lo, hi = h, h + n
            if d < len(pins) // 2:
                lo = h if pins[2 * d] else t * r
                hi = h + n if pins[2 * d + 1] else shape[d] - t * r
            box.append(slice(lo, hi))
        boxes.append(tuple(box))
    return tuple(boxes)


def column_boxes(plan, subset) -> Tuple[tuple, ...]:
    """The padded-index box of each tile column of ``subset`` (ids ``i0 *
    nt1 + i1`` of a 3D plan): the clamped tiles' extent in d0 and d1, the
    whole interior in d2, the points a subset launch writes."""
    h = plan.layout.halo
    t0, t1, _ = plan.tiles
    starts0, starts1 = plan.tile_starts(0), plan.tile_starts(1)
    boxes = []
    for col in subset:
        i0, i1 = divmod(col, len(starts1))
        s0, s1 = starts0[i0], starts1[i1]
        boxes.append((slice(h + s0, h + s0 + t0), slice(h + s1, h + s1 + t1),
                      slice(h, h + plan.interior_shape[2])))
    return tuple(boxes)


def check_subset(plan, subset) -> Tuple[int, ...]:
    """``subset`` as a tuple of column ids; ``ValueError`` where the
    kernel cannot sweep it, with JAX's messages (``pallas_tiled.py:
    747-757``): the two-level mode takes none, the ids must be a non-empty
    list inside [0, nt0 * nt1)."""
    if getattr(plan, "two_level", False):
        raise ValueError(
            "tile subsets are not implemented for the two-level "
            "(leapfrog) recursion")
    ids = tuple(int(c) for c in subset)
    nt = plan.num_tiles[0] * plan.num_tiles[1]
    if not ids or any(c < 0 or c >= nt for c in ids):
        raise ValueError(f"tile subset out of range [0, {nt})")
    return ids


@functools.lru_cache(maxsize=256)
def column_ids(subset: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The device int32 list a subset launch passes, built once per subset
    and device: a launch copies nothing from the host."""
    return torch.tensor(subset, dtype=torch.int32, device=device)


def subset_reference(cur: torch.Tensor, nxt: torch.Tensor, plan, subset,
                     src: Optional[torch.Tensor] = None,
                     coeff: Optional[torch.Tensor] = None, pins=None,
                     out2: Optional[torch.Tensor] = None):
    """Plain version of a subset launch: :func:`sweep_reference` of
    ``cur``, copied into a clone of ``nxt`` on the subset's column boxes
    (:func:`column_boxes`) only, every other point passing through as the
    TPU kernel's output aliasing leaves it; a dual plan's second output
    likewise into a clone of ``out2``. Returns the new tensor, or the pair;
    ``nxt`` and ``out2`` are unchanged."""
    want = sweep_reference(cur, plan, src, coeff=coeff, pins=pins)
    pairs = [(want, nxt)] if out2 is None else list(zip(want, (nxt, out2)))
    got = []
    for full, base in pairs:
        out = base.clone()
        for box in column_boxes(plan, check_subset(plan, subset)):
            out[box] = full[box]
        got.append(out)
    return got[0] if out2 is None else tuple(got)


def _grown(box, r: int):
    """``box`` grown by ``r`` on every side: the points its update reads."""
    return tuple(slice(b.start - r, b.stop + r) for b in box)


def _with_ghosts_of(cur: torch.Tensor, plan, result: torch.Tensor,
                    pins: Tuple[int, ...]):
    """``result``'s interior with ``cur``'s ghosts, as a launch leaves its
    output (live ghost updates are scratch; only the tile is written).
    With every face pinned ``result``'s ghosts are ``cur``'s already."""
    if all(pins) or result is cur:
        return result
    out = cur.clone()
    idx = plan.layout.interior_index
    out[idx] = result[idx]
    return out


def _cheby_reference(cur: torch.Tensor, plan, src: torch.Tensor):
    """Plain version of the Chebyshev modes, in the kernel's per-point
    order: ``((n*S(u) + c*u) + s*f) + pv*prev``, each a whole-array eager
    op with the coefficient rounded to the plan dtype, no ``prev`` term at
    t = 1."""
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


def _two_level_reference(cur: torch.Tensor, prev: torch.Tensor, plan,
                         pins: Tuple[int, ...]):
    """Plain version of the two-level mode: k leapfrog steps ``L_t =
    S(L_{t-1}) - L_{t-2}`` over each sweep's region (the taps as
    ``eager.apply_spec`` sums them, then one subtraction), other ghosts
    held. Returns ``(L_{n+k}, L_{n+k-1})`` with the ghosts of ``cur`` and
    of ``prev``, as a launch leaves outputs that start as their clones (the
    wave runner's rotation)."""
    r = plan.spec.radius
    older, u = prev, cur
    for box in update_boxes(plan, pins):
        y = eager.apply_spec(u[_grown(box, r)], plan.spec, halo=r)
        y.sub_(older[box])
        nxt = u.clone()
        nxt[box] = y
        older, u = u, nxt
    return (_with_ghosts_of(cur, plan, u, pins),
            _with_ghosts_of(prev, plan, older, pins))


def _harm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The face mean ``(2x * y) / (x + y)``, each step a rounded fp32
    op, as the kernel's ``harm``."""
    return (x * 2.0).mul_(y).div_(x + y)


def coeff_weights_reference(coeff: torch.Tensor, plan) -> torch.Tensor:
    """Plain version of ``csrc/coeff_weights.cu``: the four weight fields
    of the coefficient mode of ``plan`` over the whole padded coefficient
    ``coeff``, float32 ``[4, *coeff.shape]``, with whole-array ops in the
    kernel's order. ``W[d] = nb * harm(a(p), a(p - e_d))`` for d = 0, 1, 2
    and ``W[3] = c0 + cs * (lo0 + hi0 + lo1 + hi1 + lo2 + hi2)``, the six
    face means ``harm(a(p), a(p -+ e_d))`` summed left to right. A
    neighbour beyond the padded array is the point itself (edge
    replication); no update reads a weight that depends on it. The hi
    face's weight at p is ``W[d](p + e_d)``: ``harm`` is bitwise
    symmetric."""
    nb, c0, cs = coeff_of(plan)
    edge = torch.nn.functional.pad(coeff[None, None], (1,) * 6,
                                   mode="replicate")[0, 0]
    inner = tuple(slice(1, n + 1) for n in coeff.shape)

    def shifted(d, s):
        return edge[tuple(slice(b.start + (s if e == d else 0),
                                b.stop + (s if e == d else 0))
                          for e, b in enumerate(inner))]

    means = [(_harm(coeff, shifted(d, -1)), _harm(coeff, shifted(d, 1)))
             for d in range(3)]
    total = means[0][0] + means[0][1]
    for m in (means[1][0], means[1][1], means[2][0], means[2][1]):
        total.add_(m)
    return torch.stack([lo * nb for lo, _ in means]
                       + [total.mul_(cs).add_(c0)])


def _coeff_reference(cur: torch.Tensor, plan, coeff: torch.Tensor,
                     pins: Tuple[int, ...]):
    """Plain version of the coefficient mode: the weight fields W
    (``coeff`` itself on the march; :func:`coeff_weights_reference` of the
    padded a(x) on the window, which forms the same values at every
    update), then k sweeps of ``((((W3*u + W1*u(-e1)) + W1(+e1)*u(+e1)) +
    W2*u(-e2)) + W2(+e2)*u(+e2)) + W0*u(-e0)) + W0(+e0)*u(+e0)`` over each
    sweep's region, other ghosts held."""
    w = coeff if plan.schedule == "march" else \
        coeff_weights_reference(coeff, plan)

    def shifted(t, box, d, s):
        return t[tuple(slice(b.start + (s if e == d else 0),
                             b.stop + (s if e == d else 0))
                       for e, b in enumerate(box))]

    u = cur
    for box in update_boxes(plan, pins):
        acc = w[3][box] * u[box]
        for d in (1, 2, 0):
            acc.add_(w[d][box] * shifted(u, box, d, -1))
            acc.add_(shifted(w[d], box, d, 1) * shifted(u, box, d, 1))
        nxt = u.clone()
        nxt[box] = acc
        u = nxt
    return _with_ghosts_of(cur, plan, u, pins)


def sweep_reference(cur: torch.Tensor, plan,
                    src: Optional[torch.Tensor] = None,
                    prev: Optional[torch.Tensor] = None,
                    coeff: Optional[torch.Tensor] = None, pins=None):
    """Plain version of a sweep kernel: ``plan.sweeps_per_call`` eager
    sweeps of the padded tensor ``cur`` with ``pins`` (default every face
    pinned): each sweep updates its region (:func:`update_boxes`), the
    interior and the live ghosts, and holds every other ghost. With ``src``
    (padded like ``cur``), each update adds it after the taps. Returns a
    new padded tensor with ``cur``'s ghosts and the result's interior, as a
    launch leaves its output; ``cur`` is unchanged.

    A plan with ``cheby_coeffs`` runs the Chebyshev recurrence over the raw
    ``src`` instead (every face pinned); in its dual mode the result is the
    pair ``(sweep k, sweep k-1)``, the residual and the smoothed iterate. A
    ``two_level`` plan runs the leapfrog from ``(cur, prev)`` and returns
    the pair ``(sweep k, sweep k-1)``; a plan with ``coeff_scales`` runs
    the coefficient operator of ``coeff``, the padded a(x) on the window
    schedule and its weight fields on the march.

    In bfloat16 every op is torch's: computed in float32 and rounded to
    bfloat16, each scalar rounded to bfloat16 first (:func:`cheby_of`,
    ``eager.apply_spec``), the rule the kernels' bf16 entries follow."""
    pins = all_pinned(len(plan.interior_shape)) if pins is None \
        else tuple(int(p) for p in pins)
    if getattr(plan, "two_level", False):
        return _two_level_reference(cur, prev, plan, pins)
    if getattr(plan, "has_coeff", False):
        return _coeff_reference(cur, plan, coeff, pins)
    if getattr(plan, "cheby_coeffs", ()):
        return _cheby_reference(cur, plan, src)
    r = plan.spec.radius
    a = cur.clone()
    b = cur.clone()
    for box in update_boxes(plan, pins):
        eager.apply_spec(a[_grown(box, r)], plan.spec, halo=r, out=b[box])
        if src is not None:
            b[box].add_(src[box])
        a, b = b, a
    return _with_ghosts_of(cur, plan, a, pins)


class SweepKernel:
    """One hand-written sweep kernel: its build, its wrapper (call it as
    ``kernel(cur, nxt, plan, src=None, pins=None, out2=None, prev=None,
    coeff=None, subset=None)``) and its counts of launches: ``launches`` in
    all, of them
    ``source_launches`` in source mode, ``cheby_launches`` in Chebyshev
    mode, ``dual_launches`` in its dual mode, ``two_level_launches`` in
    two-level mode and ``coeff_launches`` in coefficient mode. Launches
    with a live face are counted again by mode: ``pins_launches`` in the
    homogeneous mode, ``source_pins_launches``, ``two_level_pins_launches``
    and ``coeff_pins_launches``; launches of a bfloat16 plan again in
    ``bf16_launches``; launches over a tile subset again in
    ``subset_launches``, those of the source mode also in
    ``source_subset_launches``. The launches of a march plan count in all
    of those and again in ``march_launches`` and, by mode,
    ``march_source_launches``, ``march_two_level_launches``,
    ``march_coeff_launches``, ``march_cheby_launches``,
    ``march_dual_launches``, ``march_pins_launches`` (homogeneous, a live
    face), ``march_source_pins_launches``,
    ``march_two_level_pins_launches``, ``march_coeff_pins_launches``,
    ``march_bf16_launches`` (of them ``march_cheby_bf16_launches`` and
    ``march_dual_bf16_launches``), ``march_subset_launches`` and
    ``march_source_subset_launches``; the march launches that ``tables``
    sends to the march library's point-table kernel (entry
    ``stencil_<march name>_tables``) again in ``march_table_launches``.

    ``name`` names the library and its C entry ``stencil_<name>``;
    ``source`` is the ``.cu`` file; ``replaces`` is where the TPU kernel
    it replaces is defined; ``schedule`` the plans' schedule its library
    runs; ``march``, the handle of the march library, which a plan of that
    schedule launches; ``tables(plan, src)``, whether a homogeneous march
    launch of ``plan`` (``src`` None) runs the point-table kernel."""

    MODE_COUNTS = ("source_launches", "cheby_launches", "dual_launches",
                   "two_level_launches", "coeff_launches", "pins_launches",
                   "source_pins_launches", "two_level_pins_launches",
                   "coeff_pins_launches", "bf16_launches",
                   "subset_launches", "source_subset_launches",
                   "march_launches", "march_source_launches",
                   "march_two_level_launches", "march_coeff_launches",
                   "march_pins_launches", "march_source_pins_launches",
                   "march_two_level_pins_launches",
                   "march_coeff_pins_launches", "march_bf16_launches",
                   "march_subset_launches", "march_source_subset_launches",
                   "march_cheby_launches", "march_dual_launches",
                   "march_cheby_bf16_launches", "march_dual_bf16_launches",
                   "march_table_launches")

    def __init__(self, name: str, source: Path, replaces: str, ndim: int,
                 schedule: str = "window",
                 march: Optional["SweepKernel"] = None,
                 tables: Optional[Callable] = None):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.ndim = ndim
        self.schedule = schedule
        self.march = march
        self.tables = tables
        # kernel launches since the last reset (plain-version calls do not
        # count)
        self.reset_counts()

    def reset_counts(self) -> None:
        self.launches = 0
        for count in self.MODE_COUNTS:
            setattr(self, count, 0)

    def build(self) -> _build.BuildResult:
        """Compile the source (cached by content). Raises
        ``_build.BuildError`` with the compiler's stderr on failure."""
        return _build.build(_build.find_nvcc(), [self.source],
                            _build.NVCC_FLAGS, self.name,
                            headers=[TAPS_HEADER])

    @functools.cached_property
    def _entry(self):
        """The library's C entries by mode: ``plain`` (also the source
        mode), ``error``, and where the source has them ``cheby``,
        ``two_level``, ``coeff`` and ``tables`` (the march's point-table
        kernel) with ``tables_fit`` (whether it takes a launch); each
        mode's bfloat16 twin, where the source has it, under the mode's
        name + ``_bf16``."""
        lib = ctypes.CDLL(str(self.build().path))
        P, I = ctypes.c_void_p, ctypes.c_int
        # the 3D kernel's tile subset: column ids (device) and their count
        cols = [P, I] if self.ndim == 3 else []
        taps = [
            P,                # tap offsets, int32[ntaps * ndim] (host)
            P,                # group sizes, int32[ngroups] (host)
            P,                # group weights, float32[ngroups] (host)
            I,                # ntaps
            I,                # ngroups
            I,                # uniform
            ctypes.c_float,   # uniform weight
            I,                # device index
            P,                # cudaStream_t
        ]
        argtypes = {
            # in, out, padded source or null (device); geometry int32
            # (host) and its length; [3D] the subset
            "": [P, P, P, P, I] + cols,
            # in, out, out2 or null, padded raw source (device); geometry;
            # coefficients float32[4k] (host) and their count; the subset
            "_cheby": [P, P, P, P, P, I, P, I] + cols,
            # in, prev, out, out2 (device); geometry
            "_two_level": [P, P, P, P, P, I],
            # in, padded coefficient, out (device); geometry; (nb, c0, cs)
            # float32[3] (host) and their count; the subset. The march's:
            # in, the weight fields, out (device); geometry; the subset
            "_coeff": ([P, P, P, P, I] if self.schedule == "march"
                       else [P, P, P, P, I, P, I]) + cols,
            # the plain mode's arguments, the source null
            "_tables": [P, P, P, P, I] + cols,
        }
        entries = {}
        for suffix, args in argtypes.items():
            for twin in ("", "_bf16"):
                fn = getattr(lib, f"stencil_{self.name}{suffix}{twin}", None)
                if fn is not None:
                    fn.restype = ctypes.c_int
                    fn.argtypes = args + taps
                entries[(suffix.lstrip("_") or "plain") + twin] = fn
        # whether the point-table kernel takes a launch: the geometry and
        # the tap table, no device or stream
        fit = getattr(lib, f"stencil_{self.name}_tables_fit", None)
        if fit is not None:
            fit.restype = ctypes.c_int
            fit.argtypes = [P, I] + taps[:7]
        entries["tables_fit"] = fit
        err = getattr(lib, f"stencil_{self.name}_error")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        entries["error"] = err
        return entries

    def library(self):
        """Build and load the library; returns its C entry
        ``stencil_<name>``."""
        return self._entry["plain"]

    def entries(self, plan):
        """The C entries that run ``plan``'s schedule: this library's, or
        the march library's for a march plan; ``ValueError`` if neither
        runs it."""
        schedule = getattr(plan, "schedule", "window")
        if schedule == self.schedule:
            return self._entry
        if schedule == "march" and self.march is not None:
            return self.march._entry
        raise ValueError(f"{self.name} does not run the {schedule} "
                         "schedule")

    def check(self, cur: torch.Tensor, nxt: torch.Tensor, plan,
              src: Optional[torch.Tensor], pins: Tuple[int, ...],
              out2: Optional[torch.Tensor] = None,
              prev: Optional[torch.Tensor] = None,
              coeff: Optional[torch.Tensor] = None,
              subset=None) -> Optional[Tuple[int, ...]]:
        """Raise ``ValueError`` on what the kernel does not take; returns
        the subset as a tuple of column ids, or None."""
        cheby = bool(getattr(plan, "cheby_coeffs", ()))
        if subset is not None:
            if self.ndim != 3:
                raise ValueError(f"{self.name} takes no tile subset (the 3D "
                                 "tiled kernel does)")
            subset = check_subset(plan, subset)
        # one pin per face of every dim but the last (the TPU kernels' own)
        if len(pins) != 2 * (self.ndim - 1) or \
                any(p not in (0, 1) for p in pins):
            raise ValueError(
                f"pins {pins}: {self.name} takes one 0 (live) or 1 "
                f"(pinned) per face of its first {self.ndim - 1} dims")
        if cheby and not all(pins):
            raise ValueError(
                f"pins {pins}: the Chebyshev modes run on static "
                "Dirichlet walls (multigrid refuses dynamic BCs upstream)")
        if plan.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"{self.name} dtype {plan.dtype!r}: float32 "
                             "or bfloat16")
        dual = cheby and plan.cheby_dual
        two_level = getattr(plan, "two_level", False)
        has_coeff = getattr(plan, "has_coeff", False)
        if has_coeff and plan.dtype != "float32":
            raise ValueError("the coefficient mode runs in float32 only")
        if cheby and src is None:
            raise ValueError("a cheby_coeffs plan needs the padded source f")
        if (dual or two_level) != (out2 is not None):
            raise ValueError("out2 goes with a cheby_dual or two_level "
                             "plan, and only with one")
        if two_level != (prev is not None):
            raise ValueError("prev (the level L_{n-1}) goes with a "
                             "two_level plan, and only with one")
        if has_coeff != (coeff is not None):
            raise ValueError("coeff (the padded coefficient, or on the "
                             "march its weight fields) goes with a "
                             "coeff_scales plan, and only with one")
        if (two_level or has_coeff) and src is not None:
            raise ValueError("the two_level and coeff modes take no source")
        shape = plan.layout.padded_shape
        tensors = [(name, t) for name, t in (
            ("cur", cur), ("nxt", nxt), ("src", src), ("out2", out2),
            ("prev", prev), ("coeff", coeff)) if t is not None]
        want = torch_dtype(plan.dtype)
        # a march coeff plan reads the four weight fields of a(x)
        weights = has_coeff and getattr(plan, "schedule", "") == "march"
        for name, t in tensors:
            if t.dtype != want:
                raise ValueError(f"{name} dtype {t.dtype} != plan dtype "
                                 f"{want}")
            expect = (4, *shape) if weights and name == "coeff" else shape
            if tuple(t.shape) != expect:
                raise ValueError(
                    f"{name} shape {tuple(t.shape)} != {expect}, the "
                    + ("weight fields (ops/tiled.py:coeff_operand)"
                       if expect != shape else "padded layout"))
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.device != cur.device:
                raise ValueError(f"cur on {cur.device}, {name} on "
                                 f"{t.device}")
        ptrs = [t.data_ptr() for name, t in tensors if name != "src"]
        if len(set(ptrs)) != len(ptrs):
            raise ValueError("cur, nxt, out2, prev and coeff must be "
                             "distinct tensors")
        return subset

    def count_launch(self, plan, src, pins: Tuple[int, ...], out2=None,
                     subset=None, tables: bool = False) -> None:
        """Add one launch of ``plan`` to the counts (the wrapper calls it
        after each kernel launch, and only there); ``tables``, whether the
        launch ran the march's point-table kernel."""
        self.launches += 1
        self.march_table_launches += tables
        bf16 = plan.dtype == "bfloat16"
        self.bf16_launches += bf16
        self.subset_launches += subset is not None
        live = not all(pins)
        if getattr(plan, "two_level", False):
            self.two_level_launches += 1
            self.two_level_pins_launches += live
        elif getattr(plan, "has_coeff", False):
            self.coeff_launches += 1
            self.coeff_pins_launches += live
        elif out2 is not None:
            self.dual_launches += 1
        elif getattr(plan, "cheby_coeffs", ()):
            self.cheby_launches += 1
        elif src is not None:
            self.source_launches += 1
            self.source_pins_launches += live
            self.source_subset_launches += subset is not None
        else:
            self.pins_launches += live
        if getattr(plan, "schedule", "window") == "march":
            self.march_launches += 1
            self.march_bf16_launches += bf16
            self.march_subset_launches += subset is not None
            if getattr(plan, "two_level", False):
                self.march_two_level_launches += 1
                self.march_two_level_pins_launches += live
            elif getattr(plan, "has_coeff", False):
                self.march_coeff_launches += 1
                self.march_coeff_pins_launches += live
            elif out2 is not None:
                self.march_dual_launches += 1
                self.march_dual_bf16_launches += bf16
            elif getattr(plan, "cheby_coeffs", ()):
                self.march_cheby_launches += 1
                self.march_cheby_bf16_launches += bf16
            elif src is not None:
                self.march_source_launches += 1
                self.march_source_pins_launches += live
                self.march_source_subset_launches += subset is not None
            else:
                self.march_pins_launches += live

    def __call__(self, cur: torch.Tensor, nxt: torch.Tensor, plan,
                 src: Optional[torch.Tensor] = None, pins=None,
                 out2: Optional[torch.Tensor] = None,
                 prev: Optional[torch.Tensor] = None,
                 coeff: Optional[torch.Tensor] = None, subset=None):
        """``plan.sweeps_per_call`` sweeps of ``cur`` into the interior of
        ``nxt`` (both padded per ``plan.layout``; ``nxt``'s ghosts must
        already hold the BC), adding the padded source ``src`` after the
        taps of every update when given. Returns ``nxt``. ``pins`` (one
        per face of every dim but the last; default all 1) marks the live
        faces, whose ghosts ``cur`` (and ``prev``, ``src``, ``coeff``) must
        hold refreshed to depth ``plan.halo``.

        A plan with ``cheby_coeffs`` runs the Chebyshev recurrence with the
        plan's coefficients over the padded raw ``src`` (required); a
        ``cheby_dual`` plan also takes ``out2`` (padded, ghosts holding the
        BC), receives sweep k-1 there and sweep k in ``nxt``, and returns
        ``(nxt, out2)``. A ``two_level`` plan takes the older level
        ``prev`` and ``out2`` and returns ``(nxt, out2)`` likewise. A plan
        with ``coeff_scales`` takes ``coeff``: the padded coefficient on the
        window schedule, its weight fields on the march
        (``ops/tiled.py:coeff_operand``).
        ``subset`` (3D, every mode but the two-level one) lists the tile
        columns to sweep; every other point of ``nxt`` (and ``out2``)
        keeps what it held.

        A CUDA tensor launches the kernel on the current stream (no
        synchronisation) and raises ``RuntimeError`` if the launch fails;
        a CPU tensor runs :func:`sweep_reference` (:func:`subset_reference`
        with a subset)."""
        pins = all_pinned(self.ndim) if pins is None \
            else tuple(int(p) for p in pins)
        subset = self.check(cur, nxt, plan, src, pins, out2, prev, coeff,
                            subset)
        if cur.device.type == "cpu":
            if subset is not None:
                want = subset_reference(cur, nxt, plan, subset, src, coeff,
                                        pins, out2)
            else:
                want = sweep_reference(cur, plan, src, prev, coeff, pins)
            if out2 is None:
                nxt.copy_(want)
                return nxt
            nxt.copy_(want[0])
            out2.copy_(want[1])
            return nxt, out2
        if cur.device.type != "cuda":
            raise ValueError(f"{self.name} runs on cuda (or cpu for the "
                             f"plain version), not {cur.device}")
        entries = self.entries(plan)
        march = getattr(plan, "schedule", "window") == "march"
        geom, offsets, sizes, weights, uniform, uw, scalars = \
            launch_tables(plan, pins)
        device = cur.device.index if cur.device.index is not None \
            else torch.cuda.current_device()
        stream = torch.cuda.current_stream(device).cuda_stream
        taps = (offsets.ctypes.data, sizes.ctypes.data, weights.ctypes.data,
                len(offsets) // self.ndim, len(sizes), int(uniform), uw,
                device, stream)
        geometry = (geom.ctypes.data, len(geom))
        scalar_args = (scalars.ctypes.data, len(scalars))
        cols = ()
        if self.ndim == 3:
            cols = (None, 0) if subset is None else (
                column_ids(subset, cur.device).data_ptr(), len(subset))
        if getattr(plan, "two_level", False):
            mode = "two_level"
            args = (cur.data_ptr(), prev.data_ptr(), nxt.data_ptr(),
                    out2.data_ptr(), *geometry)
        elif getattr(plan, "has_coeff", False):
            mode = "coeff"
            args = (cur.data_ptr(), coeff.data_ptr(), nxt.data_ptr(),
                    *geometry, *(() if march else scalar_args), *cols)
        elif len(scalars):
            mode = "cheby"
            args = (cur.data_ptr(), nxt.data_ptr(),
                    out2.data_ptr() if out2 is not None else None,
                    src.data_ptr(), *geometry, *scalar_args, *cols)
        else:
            mode = "tables" if self.tables is not None \
                and self.tables(plan, src) else "plain"
            args = (cur.data_ptr(), nxt.data_ptr(),
                    src.data_ptr() if src is not None else None, *geometry,
                    *cols)
        bf16 = plan.dtype == "bfloat16"
        fn = entries[mode + ("_bf16" if bf16 else "")]
        if fn is None:
            raise ValueError(f"{self.name} has no {mode} mode in "
                             f"{plan.dtype}"
                             + (" on the march schedule" if march else ""))
        rc = fn(*args, *taps)
        if rc != 0:
            raise RuntimeError(f"{self.name} launch failed ({rc}): "
                               f"{entries['error'](rc).decode()}")
        self.count_launch(plan, src, pins, out2, subset, mode == "tables")
        return nxt if out2 is None else (nxt, out2)


def dynamic_pins(bc: DirichletBC, ndim: int = 3) -> Tuple[int, ...]:
    """The kernels' ``pins`` for ``bc``: one flag per face of every dim but
    the last (d0 lo, d0 hi, then d1's in 3D), 0 on a periodic or Neumann
    face, 1 on a Dirichlet one. The deep refresh before each launch seeds
    k*r wrapped or mirrored ghost layers there, and the kernel treats the
    face like a mesh-internal one (no re-pinning).

    Counterpart of ``pallas_tiled._dynamic_pins`` (always 4 entries there;
    the 2D slab kernel's pins are its first two, ``pallas.py:767``)."""
    dyn = bc.dynamic_mask(ndim)
    return tuple(0 if dyn[d] else 1 for d in range(ndim - 1) for _ in (0, 1))


def check_dynamic_walls(plan, bc: DirichletBC) -> Tuple[int, ...]:
    """Raise ``ValueError`` where ``plan`` (3D tiled or 2D slab) cannot run
    ``bc``'s periodic and Neumann walls, with JAX's messages
    (``TiledPallasStencil.iterate``, ``pallas_tiled.py:2358-2398``, and
    ``PallasStencil.iterate``, ``pallas.py:909-955``): a dynamic lane
    (last) dim needs k=1, a Neumann leading dim at k>1 a spec
    mirror-symmetric in it. The Chebyshev modes refuse dynamic walls
    (``_cached_cheby_dual_fn``'s message). Returns the launches' pins.
    JAX's tap-mode gate has no counterpart: the port's one tap evaluator
    reads the ghosts."""
    ndim = len(plan.interior_shape)
    if not bc.any_dynamic:
        return dynamic_pins(bc, ndim)
    if plan.cheby_coeffs:
        raise ValueError(
            "the fused smooth+residual path runs on static Dirichlet "
            "walls (multigrid refuses dynamic BCs upstream)")
    neu = bc.neumann_mask(ndim)
    k = plan.sweeps_per_call
    problems = []
    if bc.dynamic_mask(ndim)[-1] and k != 1:
        problems.append(
            "a periodic/Neumann lane (last) dim needs "
            "sweeps_per_call=1 (use -k 1)")
    if k > 1:
        for d in range(ndim - 1):
            if neu[d] and not plan.spec.symmetric_in(d):
                problems.append(
                    f"a Neumann dim {d} at sweeps_per_call>1 "
                    f"needs the stencil mirror-symmetric in dim "
                    f"{d} (use -k 1 for asymmetric taps)")
    if problems:
        kernel = "tiled" if ndim == 3 else "2D slab"
        raise ValueError(
            f"periodic/Neumann BCs on the {kernel} Pallas kernel: "
            + "; ".join(problems))
    return dynamic_pins(bc, ndim)


def launch_plans(plan, n_outer: int, rem: int = 0) -> list:
    """The plans of ``n_outer`` launches of ``plan`` and one of its first
    ``rem`` sweeps (none when ``rem`` is 0), on the same padded layout."""
    return [plan] * n_outer + ([plan.with_sweeps(rem)] if rem else [])


class KernelStencil:
    """k sweeps per launch of ``kernel`` over a ``HaloGrid`` on ``device``:
    the iterate of ``TiledStencil`` and ``SlabStencil``.

    ``source`` (interior-shaped, static; numpy or torch) makes every sweep
    the affine update ``u' = S(u) + source_scale * source``; it is padded
    once per BC (:func:`pad_source`) and passed to every launch, the
    remainder launch included.

    ``iterate`` pads the grid once into two deep-halo tensors, runs
    ``iterations // k`` launches and one launch of ``iterations % k``
    sweeps, swapping the two tensors after each, and unpads once. Periodic
    and Neumann walls pass JAX's gates (:func:`check_dynamic_walls`);
    before every launch the dynamic ghosts of its input are
    refreshed to the launch's depth k*r, and the launch runs with those
    faces live (counterpart of ``pallas_tiled.py:_cached_tiled_iterate``
    and ``pallas.py:_cached_iterate``)."""

    kernel: SweepKernel

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
        if grid.dtype != torch_dtype(plan.dtype):
            raise ValueError(f"grid dtype {grid.dtype} != plan dtype "
                             f"{plan.dtype}; pass dtype= when "
                             "constructing the stencil")
        if grid.device != self.device:
            raise ValueError(f"grid on {grid.device}, stencil on "
                             f"{self.device}")
        if grid.interior_shape != plan.interior_shape:
            raise ValueError(f"grid interior {grid.interior_shape} != plan "
                             f"{plan.interior_shape}")
        with span("runner.iterate"):
            bc = grid.bc
            pins = check_dynamic_walls(plan, bc) if bc.any_dynamic else None
            src = None if self.source is None else self.padded_source(bc)
            with span("runner.pad"):
                cur = plan.layout.pad_grid(grid)
            with span("runner.clone"):
                nxt = cur.clone()
            for launch_plan in launch_plans(
                    plan, *divmod(iterations, plan.sweeps_per_call)):
                with span("runner.refresh"):
                    refresh_dynamic_layout(cur, plan.layout, bc,
                                           launch_plan.halo)
                with span("runner.launch"):
                    self.kernel(cur, nxt, launch_plan, src, pins)
                cur, nxt = nxt, cur
            with span("runner.unpad"):
                interior = plan.layout.unpad(cur)
            with span("runner.from_interior"):
                return HaloGrid.from_interior(interior, halo=grid.halo,
                                              bc=bc, device=grid.device)
