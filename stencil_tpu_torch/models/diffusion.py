"""Heterogeneous (variable-coefficient) diffusion:
``u_t = div(a(x) grad u)`` with a spatially varying diffusivity.

Counterpart of ``stencil_tpu/models/diffusion.py``
(``face_harmonic_means``, ``two_material``, ``HeterogeneousDiffusion``,
``_restrict_fw_np``, ``HeterogeneousPoissonProblem``). The conservative
FTCS discretization is

    u'_i = u_i + (dt/h^2) * sum_faces a_face * (u_nb - u_i)

with the face diffusivity ``a_face`` the harmonic mean of the two cell
values (flux continuity across material interfaces): ``2*ndim + 1`` taps
whose weights are fields. Two engines evaluate it. The eager one
(``ops/eager.py:apply_fields``) reads the stacked float64-built weight
fields, any rank and walls. The tiled kernel's coefficient mode (3D fp32;
Dirichlet, periodic or Neumann d0 and d1) runs k sweeps per launch
(``ops/tiled.py:coeff_iterate``; at k=1, on Dirichlet walls, the Krylov
matvec ``coeff_apply``) from the padded a(x): on the d0 march its face
weights are formed once per runner or problem by the weights kernel
(``ops/tiled.py:coeff_operand``), on the window schedule at every update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid, torch_dtype
from stencil_tpu_torch.registry import Runner


def face_harmonic_means(a: np.ndarray,
                        periodic=None) -> Tuple[np.ndarray, ...]:
    """Per-dim (lo, hi) face diffusivities: harmonic mean of the two
    adjacent cell values. At physical walls the neighbour is
    edge-replicated (the boundary face sees the wall cell's own
    diffusivity); on periodic dims the neighbour wraps, so that both cells
    of a wrap face see the same coefficient and the scheme stays
    conservative."""
    ndim = a.ndim
    if periodic is None:
        periodic = (False,) * ndim
    faces = []
    for d in range(ndim):
        def shift(sign, _d=d):
            if periodic[_d]:
                return np.roll(a, -sign, axis=_d)
            pads = [(1, 1) if e == _d else (0, 0) for e in range(ndim)]
            ap = np.pad(a, pads, mode="edge")
            idx = tuple(
                slice(1 + sign, a.shape[e] + 1 + sign) if e == _d
                else slice(None)
                for e in range(ndim)
            )
            return ap[idx]

        for sign in (-1, 1):
            nb = shift(sign)
            faces.append(2.0 * a * nb / (a + nb))
    return tuple(faces)


def two_material(shape, lo: float = 0.01, hi: float = 1.0,
                 seed: int = 0) -> np.ndarray:
    """A deterministic two-material coefficient field: each cell is
    ``hi`` or ``lo`` with equal probability (seeded). The standard
    high-contrast test field for heterogeneous operators (also the CLI's
    ``--solve hetero`` and ``-m varcoeff`` field, ``--contrast`` =
    hi/lo)."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) > 0.5, float(hi), float(lo))


def _axial_offsets(ndim: int):
    """The center, then each dim's (-1, +1) face offsets."""
    offs = [(0,) * ndim]
    for d in range(ndim):
        for sign in (-1, 1):
            off = [0] * ndim
            off[d] = sign
            offs.append(tuple(off))
    return tuple(offs)


@dataclasses.dataclass(frozen=True)
class HeterogeneousDiffusion:
    """Explicit FTCS for ``u_t = div(a(x) grad u)`` on ``device``.

    ``a`` is the cell-centered diffusivity field (interior-shaped,
    positive). ``dt=None`` picks the largest stable step
    ``h^2 / (2 * ndim * max(a))``.
    """

    shape: Tuple[int, ...]
    a: np.ndarray
    h: float = 1.0
    dt: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"
    device: str = "cuda"

    def __post_init__(self):
        a = np.asarray(self.a, np.float64)
        object.__setattr__(self, "a", a)
        if a.shape != tuple(self.shape):
            raise ValueError(f"a shape {a.shape} != interior {self.shape}")
        if not np.all(a > 0):
            raise ValueError("diffusivity a(x) must be positive")
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.reference_default(len(self.shape)))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def stable_dt(self) -> float:
        return self.h ** 2 / (2 * self.ndim * float(self.a.max()))

    def _lam(self) -> float:
        dt = self.dt if self.dt is not None else self.stable_dt
        if dt > self.stable_dt * (1 + 1e-12):
            raise ValueError(
                f"unstable: dt={dt:g} > h^2/(2*ndim*max(a)) = "
                f"{self.stable_dt:g}")
        return dt / self.h ** 2

    def tap_fields(self):
        """(offsets, fields): center + 2*ndim neighbour taps with
        per-point float64 weights. Raises on an unstable ``dt``."""
        lam = self._lam()
        faces = face_harmonic_means(self.a,
                                    self.bc.periodic_mask(self.ndim))
        fields = [np.zeros(self.shape, np.float64)]  # center placeholder
        fields += [lam * face for face in faces]
        fields[0] = 1.0 - sum(fields[1:])
        return _axial_offsets(self.ndim), np.stack(fields)

    def uses_kernel(self) -> bool:
        """The ``auto`` rule, JAX's (``stencil_tpu/models/diffusion.py:
        153-158``): the tiled kernel for a 3D fp32 problem (JAX: any
        4-byte dtype), every dim >= 8, without a dynamic lane dim
        (periodic or Neumann leading dims run on it); else the eager field
        sweep."""
        return (self.ndim == 3 and self.dtype == "float32"
                and min(self.shape) >= 8 and not self.bc.dynamic_mask(3)[2])

    def runner(self, method: str = "auto", sweeps_per_call: int = 8,
               tiles=None, t0_fixed: Optional[int] = None,
               interpret=None) -> Runner:
        """Registry-compatible Runner; plugs into ``solver.solve`` for
        steady states.

        ``method``: ``pallas_tiled``/``tiled`` (3D fp32, a Dirichlet d2)
        runs the tiled kernel's coefficient mode, ``sweeps_per_call``
        sweeps per launch, its harmonic face weights formed once per
        runner (on the march; ``plan_info["schedule"]``); ``xla``/
        ``eager`` the rank-general eager field sweep; ``auto`` the kernel
        where :meth:`uses_kernel`, else eager.
        ``plan_info["kernel"]`` says which ran. ``tiles``/``t0_fixed`` pin
        the kernel's tile; the JAX package's ``interpret`` is accepted and
        ignored."""
        if method not in ("auto", "eager", "xla", "tiled", "pallas_tiled"):
            raise ValueError(f"unknown method {method!r}")
        use_kernel = method in ("tiled", "pallas_tiled")
        if method == "auto":
            use_kernel = self.uses_kernel()
        if use_kernel:
            return self._kernel_runner(int(sweeps_per_call), tiles,
                                       t0_fixed)
        from stencil_tpu_torch.ops import eager

        offsets, fields = self.tap_fields()
        fields = torch.as_tensor(fields).to(device=self.device,
                                            dtype=torch_dtype(self.dtype))
        return Runner(
            name=f"hetero_diffusion_eager({self.ndim}d)",
            iterate=lambda g, n: eager.iterate_fields(g, offsets, fields, n,
                                                      halo=1),
            description="variable-coefficient FTCS diffusion "
                        "(per-point tap weights, harmonic face means)",
            plan_info={"kernel": "eager"},
        )

    def _kernel_runner(self, k: int, tiles, t0_fixed) -> Runner:
        from stencil_tpu_torch.core.spec import get_spec
        from stencil_tpu_torch.ops.tiled import (
            coeff_iterate, coeff_operand, make_tiled_plan, pad_coeff,
        )
        from stencil_tpu_torch.registry import schedule_info

        if self.ndim != 3:
            raise ValueError("the tiled coefficient kernel is 3D-only; "
                             "use method='xla'")
        lam = self._lam()
        if self.bc.dynamic_mask(3)[2]:
            raise ValueError(
                "a periodic/Neumann lane (last) dim needs the XLA "
                "variable-coefficient path (method='xla')")
        plan = make_tiled_plan(get_spec("jacobi7"), tuple(self.shape),
                               self.dtype, k, tiles=tiles, t0_fixed=t0_fixed,
                               coeff_scales=(lam, 1.0, -lam))
        coeff = coeff_operand(plan, pad_coeff(plan, self.a, self.bc)
                              .to(self.device))
        bc = self.bc

        def iterate(grid: HaloGrid, n: int) -> HaloGrid:
            n_outer, rem = divmod(int(n), k)
            data = coeff_iterate(plan, grid.data, bc, coeff, n_outer,
                                 grid.halo, rem)
            return HaloGrid(data=data, halo=grid.halo, bc=grid.bc)

        return Runner(
            name=f"hetero_diffusion_tiled(k={k})",
            iterate=iterate,
            granularity=k,
            description="variable-coefficient FTCS diffusion on the tiled "
                        "kernel (harmonic face weights formed once per "
                        "runner on the march)",
            plan_info={"kernel": "tiled", "tiles": list(plan.tiles),
                       **schedule_info(plan), "tap_mode": "coeff",
                       "sweeps_per_call": k},
        )

    def initial_grid(self, interior=None) -> HaloGrid:
        if interior is None:
            return HaloGrid.create(self.shape, halo=1, bc=self.bc,
                                   dtype=self.dtype, device=self.device)
        return HaloGrid.from_interior(
            torch.as_tensor(interior).to(torch_dtype(self.dtype)), halo=1,
            bc=self.bc, device=self.device)


def _restrict_fw_np(r: np.ndarray) -> np.ndarray:
    """NumPy full-weighting restriction (per-dim [1/4, 1/2, 1/4],
    factor-2 subsample; fine width n = 2 n_c + 1): the host-side twin of
    ``multigrid._restrict_fw`` used to coarsen coefficient fields."""
    for d in range(r.ndim):
        n = r.shape[d]

        def take(lo, hi, _d=d):
            idx = tuple(
                slice(lo, hi, 2) if e == _d else slice(None)
                for e in range(r.ndim)
            )
            return r[idx]

        r = 0.25 * take(0, n - 2) + 0.5 * take(1, n - 1) \
            + 0.25 * take(2, n)
    return r


@dataclasses.dataclass(frozen=True)
class HeterogeneousPoissonProblem:
    """Steady heterogeneous diffusion ``-div(a(x) grad u) = f`` on
    Dirichlet walls, on ``device``: the boundary-value companion of the
    FTCS marcher above.

    Discretization: conservative flux form with harmonic face means
    (``face_harmonic_means``): center ``sum_faces a_face / h^2``, face
    taps ``-a_face / h^2``, an SPD M-matrix. It plugs into the
    matrix-free Krylov stack through the operator protocol
    (``operator_data``/``operator_apply``/``operator_inv_diagonal``) and
    into ``multigrid.OperatorMultigrid`` through ``with_discretization``,
    which full-weights a(x) down the vertex-centered ladder.

    ``kernel``: ``auto``/``eager``/``xla`` evaluate the matvec with the
    eager field sweep over the float64-built weight fields; ``pallas``
    (3D fp32) with the tiled kernel's coefficient mode at k=1
    (``ops/tiled.py:coeff_apply``), the face weights formed once per
    problem (:meth:`operator_data`).
    ``with_discretization`` keeps ``kernel``, so a preconditioning
    hierarchy runs the same engine at every level. ``interpret`` (the JAX
    package's Pallas flag) is accepted and ignored.
    """

    shape: Tuple[int, ...]
    a: np.ndarray
    h: Optional[float] = None
    bc: Optional[DirichletBC] = None
    dtype: str = "float32"
    kernel: str = "auto"
    interpret: Optional[bool] = None
    device: str = "cuda"

    def __post_init__(self):
        a = np.asarray(self.a, np.float64)
        object.__setattr__(self, "a", a)
        if a.shape != tuple(self.shape):
            raise ValueError(f"a shape {a.shape} != interior {self.shape}")
        if not np.all(a > 0):
            raise ValueError("diffusivity a(x) must be positive")
        if self.h is None:
            object.__setattr__(self, "h", 1.0 / (self.shape[0] + 1))
        if self.bc is None:
            object.__setattr__(
                self, "bc", DirichletBC.zero(len(self.shape)))
        if self.bc.any_dynamic:
            raise ValueError(
                "the steady heterogeneous operator needs Dirichlet "
                "walls (periodic/Neumann annihilate constants; march "
                "HeterogeneousDiffusion in time instead)")
        if self.kernel not in ("auto", "eager", "xla", "pallas"):
            raise ValueError(
                f"unknown kernel {self.kernel!r} (auto | xla | pallas)")
        use_kernel = self.kernel == "pallas"
        if use_kernel and (len(self.shape) != 3
                           or torch_dtype(self.dtype).itemsize != 4):
            raise ValueError(
                "kernel='pallas' needs a 3D fp32 problem")
        object.__setattr__(self, "_use_kernel", use_kernel)
        object.__setattr__(self, "_data_cache", None)
        object.__setattr__(self, "_plan_cache", None)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def _kernel_plan(self):
        """The k=1 coefficient-mode plan of the ``pallas`` matvec (nb =
        -1/h^2, c0 = 0, cs = 1/h^2)."""
        if self._plan_cache is None:
            from stencil_tpu_torch.core.spec import get_spec
            from stencil_tpu_torch.ops.tiled import make_tiled_plan

            inv_h2 = 1.0 / (float(self.h) ** 2)
            object.__setattr__(
                self, "_plan_cache",
                make_tiled_plan(get_spec("jacobi7"), tuple(self.shape),
                                self.dtype, sweeps_per_call=1,
                                coeff_scales=(-inv_h2, 0.0, inv_h2)))
        return self._plan_cache

    def operator_fields(self):
        """(offsets, stacked float64 fields) of the operator ``A``."""
        inv_h2 = 1.0 / (float(self.h) ** 2)
        fields = [np.zeros(self.shape, np.float64)]
        fields += [-inv_h2 * face for face in face_harmonic_means(self.a)]
        fields[0] = -sum(fields[1:])
        return _axial_offsets(self.ndim), np.stack(fields)

    # -- matrix-free operator protocol --

    def operator_data(self):
        """The operator's device tensors, built once: the stacked weight
        fields (the Jacobi diagonal and the eager matvec read them), and
        with ``kernel='pallas'`` the pair (fields, the kernel plan's
        coefficient operand: on the march the weight fields of the padded
        a(x), formed here by the weights kernel, once per problem and so
        once per ``OperatorMultigrid`` level)."""
        if self._data_cache is None:
            _, fields = self.operator_fields()
            data = torch.as_tensor(fields).to(
                device=self.device, dtype=torch_dtype(self.dtype))
            if self._use_kernel:
                from stencil_tpu_torch.ops.tiled import (
                    coeff_operand, pad_coeff,
                )

                plan = self._kernel_plan()
                data = (data, coeff_operand(plan, pad_coeff(
                    plan, self.a, self.bc).to(self.device)))
            object.__setattr__(self, "_data_cache", data)
        return self._data_cache

    def operator_apply(self, padded: torch.Tensor, data) -> torch.Tensor:
        """``A u`` of the halo-1 padded ``padded`` (its ghost ring is
        read), interior-shaped."""
        if self._use_kernel:
            from stencil_tpu_torch.ops.tiled import coeff_apply

            return coeff_apply(self._kernel_plan(), padded, data[1])
        from stencil_tpu_torch.ops.eager import apply_fields

        return apply_fields(padded, _axial_offsets(self.ndim), data, halo=1)

    def operator_inv_diagonal(self, data):
        if data is None:
            raise TypeError("field operator diagonal needs data")
        fields = data[0] if self._use_kernel else data
        return 1.0 / fields[0]

    def with_discretization(self, shape,
                            h) -> "HeterogeneousPoissonProblem":
        """Coarsen the coefficient field down the vertex-centered ladder
        (full weighting per skipped level) and rediscretize."""
        a = self.a
        while a.shape != tuple(shape):
            if any(n % 2 == 0 or n < 3 for n in a.shape):
                raise ValueError(
                    f"cannot coarsen a{a.shape} toward {tuple(shape)}")
            a = _restrict_fw_np(a)
        return dataclasses.replace(
            self, shape=tuple(shape), a=a, h=float(h),
            bc=DirichletBC.zero(self.ndim))

    # -- golden twin / convenience --

    def initial_grid(self, interior=None) -> HaloGrid:
        if interior is None:
            return HaloGrid.create(self.shape, halo=1, bc=self.bc,
                                   dtype=self.dtype, device=self.device)
        return HaloGrid.from_interior(
            torch.as_tensor(interior).to(torch_dtype(self.dtype)), halo=1,
            bc=self.bc, device=self.device)

    def apply_f64(self, interior) -> np.ndarray:
        """``A u`` in float64 with the true wall ghosts (certificate)."""
        from stencil_tpu_torch.core.grid import fill_halo_np

        u = np.asarray(interior, np.float64)
        if u.shape != tuple(self.shape):
            raise ValueError(f"interior shape {u.shape} != {self.shape}")
        padded = fill_halo_np(np.pad(u, 1), 1, self.bc)
        offsets, fields = self.operator_fields()
        n = tuple(self.shape)
        out = np.zeros(n, np.float64)
        for off, w in zip(offsets, fields):
            idx = tuple(slice(1 + off[d], 1 + off[d] + n[d])
                        for d in range(self.ndim))
            out += w * padded[idx]
        return out

    def residual_f64(self, grid: HaloGrid, f) -> float:
        """``max |f - A u|`` in float64: the certificate."""
        u = grid.interior().double().cpu().numpy()
        f64 = torch.as_tensor(f).double().cpu().numpy()
        return float(np.max(np.abs(f64 - self.apply_f64(u))))

    def solve(self, f, tolerance: float = 1e-5,
              max_iterations: int = 2000, preconditioned: bool = True,
              mesh=None, dim: int = 0):
        """Solve by (by default ``OperatorMultigrid``-preconditioned)
        BiCGStab; returns its ``CGResult``. ``mesh`` (the distributed
        solve) is not ported."""
        from stencil_tpu_torch.krylov import BiCGStab
        from stencil_tpu_torch.multigrid import OperatorMultigrid

        pre = OperatorMultigrid(self) if preconditioned else None
        return BiCGStab(self, preconditioner=pre).solve(
            f, tolerance=tolerance, max_iterations=max_iterations,
            mesh=mesh, dim=dim)
