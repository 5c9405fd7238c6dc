"""Halo'd dense grid on a torch tensor.

Counterpart of ``stencil_tpu/core/grid.py``. ``DirichletBC`` and the numpy
twins are copied unchanged; the JAX functions become in-place torch ones:
``fill_halo`` and ``refresh_dynamic`` write into the padded tensor they are
given and return it, where the JAX versions return a new array.

The corner order is the reference's and matters: Dirichlet faces are filled
in increasing dimension order, so the highest Dirichlet dim wins in corners;
dynamic dims (periodic wraps, Neumann mirrors) run after, in increasing
order, over the full extent of the other dims. Box stencils read those
corners.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` ("float32", a numpy dtype or a torch dtype) as a torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else str(np.dtype(dtype))
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}; "
                         f"available: {sorted(_DTYPES)}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype ("float32")."""
    return str(dtype).removeprefix("torch.")


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index filled in.

    A CUDA device that torch cannot see raises ``RuntimeError``: the port
    never falls back to the CPU. The CPU runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain versions on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Per-dimension boundary conditions: Dirichlet (constant faces),
    periodic (wrap-around) or Neumann (zero-flux mirror) per dim.

    ``values[d] = (low_value, high_value)``. The default matches the
    reference's initial conditions: last-dim faces 1.0, all others 0.0.
    ``periodic[d]`` / ``neumann[d]`` make dim ``d`` dynamic; its ``values``
    entry is then ignored. Empty tuples (the default) mean all-Dirichlet.
    A dim may be periodic or Neumann, not both.
    """

    values: Tuple[Tuple[float, float], ...]
    periodic: Tuple[bool, ...] = ()
    neumann: Tuple[bool, ...] = ()

    @staticmethod
    def reference_default(ndim: int) -> "DirichletBC":
        vals = [(0.0, 0.0)] * (ndim - 1) + [(1.0, 1.0)]
        return DirichletBC(values=tuple(vals))

    @staticmethod
    def zero(ndim: int) -> "DirichletBC":
        return DirichletBC(values=tuple([(0.0, 0.0)] * ndim))

    @staticmethod
    def periodic_all(ndim: int) -> "DirichletBC":
        return DirichletBC(values=tuple([(0.0, 0.0)] * ndim),
                           periodic=tuple([True] * ndim))

    def with_periodic(self, dims) -> "DirichletBC":
        """This BC with the given dims made periodic."""
        ndim = len(self.values)
        per = list(self.periodic_mask(ndim))
        neu = self.neumann_mask(ndim)
        for d in dims:
            if not -ndim <= d < ndim:
                raise ValueError(f"periodic dim {d} out of range for "
                                 f"rank {ndim}")
            if neu[d % ndim]:
                raise ValueError(
                    f"dim {d % ndim} is already Neumann; a dim may be "
                    "periodic or Neumann, not both")
            per[d % ndim] = True
        # the all-Dirichlet mask normalizes to () so equal BCs hash equal
        return dataclasses.replace(
            self, periodic=tuple(per) if any(per) else ()
        )

    def with_neumann(self, dims) -> "DirichletBC":
        """This BC with the given dims made zero-flux (mirror) Neumann."""
        ndim = len(self.values)
        neu = list(self.neumann_mask(ndim))
        per = self.periodic_mask(ndim)
        for d in dims:
            if not -ndim <= d < ndim:
                raise ValueError(f"Neumann dim {d} out of range for "
                                 f"rank {ndim}")
            if per[d % ndim]:
                raise ValueError(
                    f"dim {d % ndim} is already periodic; a dim may be "
                    "periodic or Neumann, not both")
            neu[d % ndim] = True
        return dataclasses.replace(
            self, neumann=tuple(neu) if any(neu) else ()
        )

    def periodic_mask(self, ndim: int) -> Tuple[bool, ...]:
        """``periodic`` normalized to length ``ndim``."""
        per = tuple(self.periodic)
        return per + (False,) * (ndim - len(per))

    def neumann_mask(self, ndim: int) -> Tuple[bool, ...]:
        """``neumann`` normalized to length ``ndim``."""
        neu = tuple(self.neumann)
        return neu + (False,) * (ndim - len(neu))

    def dynamic_mask(self, ndim: int) -> Tuple[bool, ...]:
        """Dims whose ghosts hold current-iterate data (periodic wrap or
        Neumann mirror) rather than Dirichlet constants."""
        per = self.periodic_mask(ndim)
        neu = self.neumann_mask(ndim)
        return tuple(p or n for p, n in zip(per, neu))

    @property
    def any_dynamic(self) -> bool:
        return any(self.periodic) or any(self.neumann)

    def __hash__(self):
        return hash((self.values, self.periodic, self.neumann))


def _at(ndim: int, d: int, d_slice: slice):
    return tuple(d_slice if i == d else slice(None) for i in range(ndim))


def _face_slices(shape, halo: int, d: int):
    """(lo_ghost, hi_ghost, lo_src, hi_src) index tuples for dim ``d`` of
    a ``halo``-padded array: the two ghost slabs and the two interior bands
    a periodic wrap copies from. Each slab spans the other dims fully."""
    ndim, s = len(shape), shape[d]
    return (_at(ndim, d, slice(0, halo)), _at(ndim, d, slice(s - halo, None)),
            _at(ndim, d, slice(s - 2 * halo, s - halo)),
            _at(ndim, d, slice(halo, 2 * halo)))


def _mirror_slices(shape, halo: int, d: int):
    """(lo_src, hi_src) bands whose dim-``d`` flip fills the ghost slabs of
    a Neumann dim: ghost layer ``j`` mirrors interior layer ``j-1``."""
    ndim, s = len(shape), shape[d]
    return (_at(ndim, d, slice(halo, 2 * halo)),
            _at(ndim, d, slice(s - 2 * halo, s - halo)))


def _check_dynamic_depth(shape, halo: int, d: int, kind: str):
    n = shape[d] - 2 * halo
    if n < halo:
        raise ValueError(
            f"{kind} dim {d} needs interior extent >= halo depth "
            f"({n} < {halo}); shrink the temporal depth or grow the grid"
        )


def fill_halo(padded: torch.Tensor, halo: int,
              bc: DirichletBC) -> torch.Tensor:
    """Write the BC into the full halo ring of ``padded``, in place.

    Dirichlet faces are constant slabs spanning the other dims, later dims
    overwriting earlier ones in corners; dynamic dims are then refreshed
    from the interior (:func:`refresh_dynamic`). Returns ``padded``."""
    ndim = padded.ndim
    dyn = bc.dynamic_mask(ndim)
    for d in range(ndim):
        if dyn[d]:
            continue
        lo, hi = bc.values[d]
        idx_lo, idx_hi, _, _ = _face_slices(padded.shape, halo, d)
        padded[idx_lo] = lo
        padded[idx_hi] = hi
    return refresh_dynamic(padded, halo, bc)


def refresh_dynamic(padded: torch.Tensor, halo: int,
                    bc: DirichletBC) -> torch.Tensor:
    """Re-fill the ghost slabs of dynamic dims in place: periodic dims by
    wrap-around copy, Neumann dims by mirror copy, in increasing dim order
    over the full extent of the other dims. No-op for all-Dirichlet BCs.
    Returns ``padded``."""
    ndim = padded.ndim
    per = bc.periodic_mask(ndim)
    neu = bc.neumann_mask(ndim)
    for d in range(ndim):
        if per[d]:
            _check_dynamic_depth(padded.shape, halo, d, "periodic")
            idx_lo, idx_hi, src_lo, src_hi = _face_slices(
                padded.shape, halo, d)
            padded[idx_lo] = padded[src_lo]
            padded[idx_hi] = padded[src_hi]
        elif neu[d]:
            _check_dynamic_depth(padded.shape, halo, d, "Neumann")
            idx_lo, idx_hi, _, _ = _face_slices(padded.shape, halo, d)
            src_lo, src_hi = _mirror_slices(padded.shape, halo, d)
            padded[idx_lo] = torch.flip(padded[src_lo], dims=(d,))
            padded[idx_hi] = torch.flip(padded[src_hi], dims=(d,))
    return padded


def fill_halo_np(padded: np.ndarray, halo: int,
                 bc: DirichletBC) -> np.ndarray:
    """NumPy twin of :func:`fill_halo` for the float64 golden model."""
    ndim = padded.ndim
    dyn = bc.dynamic_mask(ndim)
    for d in range(ndim):
        if dyn[d]:
            continue
        lo, hi = bc.values[d]
        idx_lo, idx_hi, _, _ = _face_slices(padded.shape, halo, d)
        padded[idx_lo] = lo
        padded[idx_hi] = hi
    return refresh_dynamic_np(padded, halo, bc)


def refresh_dynamic_np(padded: np.ndarray, halo: int,
                       bc: DirichletBC) -> np.ndarray:
    """NumPy twin of :func:`refresh_dynamic` (golden model, per sweep)."""
    ndim = padded.ndim
    per = bc.periodic_mask(ndim)
    neu = bc.neumann_mask(ndim)
    for d in range(ndim):
        if per[d]:
            _check_dynamic_depth(padded.shape, halo, d, "periodic")
            idx_lo, idx_hi, src_lo, src_hi = _face_slices(
                padded.shape, halo, d)
            padded[idx_lo] = padded[src_lo]
            padded[idx_hi] = padded[src_hi]
        elif neu[d]:
            _check_dynamic_depth(padded.shape, halo, d, "Neumann")
            idx_lo, idx_hi, _, _ = _face_slices(padded.shape, halo, d)
            src_lo, src_hi = _mirror_slices(padded.shape, halo, d)
            padded[idx_lo] = np.flip(padded[src_lo], axis=d)
            padded[idx_hi] = np.flip(padded[src_hi], axis=d)
    return padded


def _interior_index(shape, halo: int):
    return tuple(slice(halo, s - halo) for s in shape)


@dataclasses.dataclass
class HaloGrid:
    """A dense grid with a BC-filled halo ring of width ``halo``.

    ``data`` is a torch tensor of shape ``interior_shape + 2 * halo`` per
    dim; its halo ring always holds the BC values."""

    data: torch.Tensor
    halo: int
    bc: DirichletBC

    @staticmethod
    def create(
        interior_shape: Sequence[int],
        halo: int = 1,
        bc: Optional[DirichletBC] = None,
        dtype="float32",
        interior_value: float = 0.0,
        device="cuda",
    ) -> "HaloGrid":
        """Interior = ``interior_value``, halo = BC values."""
        ndim = len(interior_shape)
        if bc is None:
            bc = DirichletBC.reference_default(ndim)
        padded_shape = tuple(s + 2 * halo for s in interior_shape)
        padded = torch.full(padded_shape, interior_value,
                            dtype=torch_dtype(dtype),
                            device=check_device(device))
        fill_halo(padded, halo, bc)
        return HaloGrid(data=padded, halo=halo, bc=bc)

    @staticmethod
    def from_interior(
        interior,
        halo: int = 1,
        bc: Optional[DirichletBC] = None,
        device="cuda",
    ) -> "HaloGrid":
        """Embed ``interior`` (tensor or array) into a new padded tensor on
        ``device``, halo = BC values."""
        device = check_device(device)
        interior = torch.as_tensor(interior, device=device)
        ndim = interior.ndim
        if bc is None:
            bc = DirichletBC.reference_default(ndim)
        padded = torch.zeros(tuple(s + 2 * halo for s in interior.shape),
                             dtype=interior.dtype, device=device)
        padded[_interior_index(padded.shape, halo)] = interior
        fill_halo(padded, halo, bc)
        return HaloGrid(data=padded, halo=halo, bc=bc)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def interior_shape(self) -> Tuple[int, ...]:
        return tuple(s - 2 * self.halo for s in self.data.shape)

    def interior(self) -> torch.Tensor:
        """A view of the interior."""
        return self.data[_interior_index(self.data.shape, self.halo)]


def fill_halo_deep(padded: torch.Tensor, halo: int,
                   bc: DirichletBC) -> torch.Tensor:
    """Fill a halo of any depth with the per-face BC values (every ring
    gets the face value), in place. Temporal blocking uses it."""
    return fill_halo(padded, halo, bc)
