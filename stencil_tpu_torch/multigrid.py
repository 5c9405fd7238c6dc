"""Geometric multigrid for ``laplacian(u) = f``: V- and W-cycles, FMG.

Counterpart of ``stencil_tpu/multigrid.py`` (``wjacobi_spec``,
``residual_spec``, ``nbsum_spec``, ``_cheby_sweep_coeffs``, the level ops,
``_level_shapes``, ``Multigrid``, ``OperatorMultigrid``). The
discretization and the transfers are
the JAX package's: the 2nd-order star Laplacian (``PoissonProblem``'s
operator), weighted-Jacobi or Chebyshev smoothing, full-weighting
restriction, linear prolongation, the coarsest level relaxed by damped
Jacobi, vertex-centered factor-2 coarsening while every width is odd.

Two fine levels, as in the JAX package:

- ``fine_method='xla'`` (or ``'eager'``): the whole cycle is eager torch
  ops, any rank;
- ``fine_method='pallas_tiled'`` (or ``'tiled'``), 3D: the fine level's
  smoothers and residual run on the hand-written tiled kernel
  (``ops/tiled.py``): weighted Jacobi in its source mode, Chebyshev in its
  Chebyshev mode, and, whenever ``nu1 >= 1``, the pre-smoother and the
  residual fused into one dual-mode launch. The padded sources are made
  from the cycle's right-hand side per call, so one set of plans serves
  every right-hand side (the PCG residuals included). Coarse levels stay
  eager torch ops.

Where the JAX level ops return new arrays, these update the padded tensor
they are given in place and return it; the cycle owns its tensors (the
runner clones the grid once). Nothing in a cycle syncs with the host: the
V-cycle loop of ``runner`` queues its work and returns. The JAX
``interpret`` flag is accepted and ignored.

``Multigrid.sharded_runner`` runs the same cycle on the single-controller
mesh (``parallel/mesh.py``): each level's arrays are fields of
``parallel/sharded_field.py`` on that level's layout (``_level_shardings``,
JAX's ladder: a level stays sharded along a mesh axis while it is at least
``replicate_below`` wide, narrower levels are replicated), the level ops
exchange one-deep halos and apply the one-device op per block, and the
transfers cross rank boundaries. The recursion is the one ``_make_cycle``
writes; only its level hooks (``_DenseLevels``, ``_MeshLevels``) differ, and
every operation is pointwise in a fixed order, so the sharded cycle is
bitwise the one-device eager cycle.

``OperatorMultigrid`` is the rediscretized cycle for a general operator
(the problem's ``with_discretization`` at every level, damped Jacobi on
the level operator's diagonal, the same transfers), the preconditioner of
``krylov.BiCGStab``; its levels run whatever engine each level's problem
applies, the tiled kernel's coefficient mode included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from stencil_tpu_torch.core.grid import HaloGrid, torch_dtype
from stencil_tpu_torch.core.spec import StencilSpec, weighted
from stencil_tpu_torch.models.poisson import PoissonProblem
from stencil_tpu_torch.parallel import sharded_field as sf
from stencil_tpu_torch.parallel.sharded_field import ShardedField
from stencil_tpu_torch.registry import Runner
from stencil_tpu_torch.utils.tracing import span

FINE_METHODS = ("xla", "eager", "pallas_tiled", "tiled")


def _axial_taps(ndim: int, center_w: float, nb_w: float):
    taps = [((0,) * ndim, center_w)]
    for d in range(ndim):
        for sign in (-1, 1):
            off = [0] * ndim
            off[d] = sign
            taps.append((tuple(off), nb_w))
    return taps


def wjacobi_spec(ndim: int, omega: float) -> StencilSpec:
    """Weighted-Jacobi smoother as a stencil: ``u' = (1-omega) u +
    omega/(2 ndim) * nb_sum(u)`` (the source term carries the RHS)."""
    return weighted(ndim, _axial_taps(ndim, 1.0 - omega,
                                      omega / (2 * ndim)),
                    name=f"wjacobi{ndim}d")


def residual_spec(ndim: int, h: float) -> StencilSpec:
    """The negated operator ``-A``: applied with source scale +1 it
    yields the residual ``r = f - A u`` in one stencil sweep."""
    inv_h2 = 1.0 / (h * h)
    return weighted(ndim, _axial_taps(ndim, 2 * ndim * inv_h2, -inv_h2),
                    name=f"neg_laplace{ndim}d")


def nbsum_spec(ndim: int) -> StencilSpec:
    """The center-less neighbor sum (all face taps, weight 1): the spec of
    the tiled kernel's Chebyshev mode, whose per-sweep weights multiply
    after it."""
    return weighted(ndim, _axial_taps(ndim, 0.0, 1.0)[1:],
                    name=f"nbsum{ndim}d")


def _cheby_sweep_coeffs(nu: int, ratio: float, ndim: int, h: float):
    """Per-sweep affine coefficients ``(c, n, pv, s)`` of the degree-nu
    Chebyshev smoother as tiled-kernel sweeps:

      u_t = c_t u_{t-1} + n_t nbsum(u_{t-1}) + pv_t u_{t-2} + s_t f

    (the ``_smooth_cheby`` recurrence with ``d_{t-1} = u_{t-1} - u_{t-2}``
    substituted; equal to it in exact arithmetic)."""
    lmax = 2.0
    lmin = lmax / float(ratio)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    two_d = 2.0 * ndim
    inv_d = (h * h) / two_d
    out = []
    a, b = 1.0 / theta, 0.0
    rho_prev = 1.0 / sigma
    for t in range(nu):
        if t > 0:
            rho = 1.0 / (2.0 * sigma - rho_prev)
            b = rho * rho_prev
            a = 2.0 * rho / delta
            rho_prev = rho
        out.append((1.0 + b - a, a / two_d, -b, -a * inv_d))
    return tuple(out)


def _interior(shape):
    return tuple(slice(1, s - 1) for s in shape)


def _nb_sum(padded: torch.Tensor) -> torch.Tensor:
    """Sum of the 2*ndim face neighbors, interior-shaped (padded has one
    ghost layer per face); a new tensor."""
    nd = padded.ndim
    acc = None
    for d in range(nd):
        for lo in (0, 2):
            t = padded[tuple(
                slice(lo, padded.shape[e] - 2 + lo) if e == d
                else slice(1, padded.shape[e] - 1) for e in range(nd))]
            if acc is None:
                acc = t.clone()
            else:
                acc.add_(t)
    return acc


def _smooth(padded, f_scaled, omega: float, inv2d: float, sweeps: int):
    """``sweeps`` weighted-Jacobi sweeps on a zero-wall level, in place:
    ``u' = u + omega * ((nb_sum(u) - h^2 f) / (2 ndim) - u)``.
    ``f_scaled`` carries ``h^2 * f`` pre-multiplied. A sharded field
    exchanges its halos before each sweep of its blocks."""
    if isinstance(padded, ShardedField):
        for _ in range(sweeps):
            padded.exchange().each(_smooth, f_scaled, omega, inv2d, 1)
        return padded
    idx = _interior(padded.shape)
    for _ in range(sweeps):
        u = padded[idx]
        jac = _nb_sum(padded).sub_(f_scaled).mul_(inv2d)
        padded[idx] = jac.sub_(u).mul_(omega).add_(u)
    return padded


def _residual(padded, f, inv_h2: float, two_d: float):
    """``r = f - (nb_sum(u) - 2 ndim u) / h^2``, interior-shaped (a sharded
    field: per block, after its halo exchange)."""
    if isinstance(padded, ShardedField):
        return padded.exchange().map(_residual, f, inv_h2, two_d)
    lap = _nb_sum(padded).sub_(padded[_interior(padded.shape)] * two_d)
    return f - lap.mul_(inv_h2)


def _smooth_cheby(padded, f, inv_h2: float, two_d: float, sweeps: int,
                  ratio: float):
    """``sweeps`` steps of Chebyshev polynomial smoothing on the
    Jacobi-preconditioned operator, in place. The diagonal of ``A = -L``
    is the constant ``2 ndim / h^2``, so ``D^-1 A`` has its spectrum in
    ``(0, 2)``; the polynomial equioscillates on ``[2/ratio, 2]``."""
    if sweeps <= 0:
        return padded
    lmax = 2.0
    lmin = lmax / float(ratio)
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    inv_d = 1.0 / (two_d * inv_h2)
    # residual of the SPD form: (-f) - A u = -(f - L u)
    r = -_residual(padded, f, inv_h2, two_d)
    d = (inv_d / theta) * r
    sf.add_interior(padded, d)
    rho_prev = 1.0 / sigma
    for _ in range(1, sweeps):
        rho = 1.0 / (2.0 * sigma - rho_prev)
        r = -_residual(padded, f, inv_h2, two_d)
        d = (rho * rho_prev) * d + (2.0 * rho / delta) * inv_d * r
        sf.add_interior(padded, d)
        rho_prev = rho
    return padded


def _restrict_fw(r: torch.Tensor) -> torch.Tensor:
    """Full-weighting restriction: per-dim [1/4, 1/2, 1/4] then factor-2
    subsample (fine width n = 2 n_c + 1, all dims)."""
    for d in range(r.ndim):
        n = r.shape[d]

        def take(lo, hi):
            return r[tuple(slice(lo, hi, 2) if e == d else slice(None)
                           for e in range(r.ndim))]

        r = 0.25 * take(0, n - 2) + 0.5 * take(1, n - 1) \
            + 0.25 * take(2, n)
    return r


def _prolong_lin(e: torch.Tensor) -> torch.Tensor:
    """Linear prolongation: coarse point i lands on fine 2i+1; fine even
    points average their coarse neighbors (walls are zero). Separable."""
    for d in range(e.ndim):
        n_f = 2 * e.shape[d] + 1

        def at(sl):
            return tuple(sl if i == d else slice(None)
                         for i in range(e.ndim))

        # the injected array with one zero layer on each side along d
        zp = torch.zeros(tuple(n_f + 2 if i == d else s
                               for i, s in enumerate(e.shape)),
                         dtype=e.dtype, device=e.device)
        zp[at(slice(2, n_f + 1, 2))] = e
        e = zp[at(slice(1, n_f + 1))] \
            + 0.5 * (zp[at(slice(0, n_f))] + zp[at(slice(2, n_f + 2))])
    return e


def _prolong_full(u_pad: torch.Tensor) -> torch.Tensor:
    """Ghost-aware linear prolongation for FMG: coarse PADDED level (nc+2
    per dim, walls in the ghosts) -> fine PADDED level (2 nc+3). Fine even
    index 2j injects coarse j; fine odd 2j+1 averages coarse j, j+1."""
    for d in range(u_pad.ndim):
        nc2 = u_pad.shape[d]
        nf2 = 2 * nc2 - 1

        def at(lo, hi, step):
            return tuple(slice(lo, hi, step) if i == d else slice(None)
                         for i in range(u_pad.ndim))

        z = torch.zeros(tuple(nf2 if i == d else s
                              for i, s in enumerate(u_pad.shape)),
                        dtype=u_pad.dtype, device=u_pad.device)
        z[at(0, None, 2)] = u_pad
        z[at(1, None, 2)] = 0.5 * (u_pad[at(0, nc2 - 1, 1)]
                                   + u_pad[at(1, None, 1)])
        u_pad = z
    return u_pad


def _level_shapes(shape: Tuple[int, ...],
                  min_size: int) -> Tuple[Tuple[int, ...], ...]:
    shapes = [tuple(shape)]
    while all(n % 2 == 1 and n >= max(3, min_size) for n in shapes[-1]) \
            and any(n > max(3, min_size) for n in shapes[-1]):
        nxt = tuple((n - 1) // 2 for n in shapes[-1])
        if any(n < 1 for n in nxt):
            break
        shapes.append(nxt)
    return tuple(shapes)


def _level_shardings_for(shapes, ndim: int, mesh, dim: int = 0,
                         replicate_below: Optional[int] = None):
    """Per-level layouts (``parallel/sharded_field.py:Layout``) of a
    coarsening hierarchy over a 1D or 2D mesh: mesh axis ``a`` shards grid
    dim ``dim + a`` on levels at least ``replicate_below`` interior points
    wide along that dim; narrower levels drop that axis, decided per axis
    (a level can stay sharded along d0 after its d1 width collapsed).
    Shared by ``Multigrid`` and ``OperatorMultigrid``; returns ``(layouts,
    sharded_flags, replicate_below_per_axis)``, JAX's rules and messages
    (``stencil_tpu/multigrid.py:317-365``)."""
    naxes = len(mesh.axis_names)
    if naxes not in (1, 2):
        raise ValueError(
            f"distributed multigrid wants a 1D or 2D mesh, got axes "
            f"{mesh.axis_names}")
    if not 0 <= dim <= ndim - naxes:
        raise ValueError(
            f"mesh axes {mesh.axis_names} shard grid dims "
            f"{dim}..{dim + naxes - 1}, out of range for {ndim}D")
    if replicate_below is None:
        # >= 2 interior planes per rank along each sharded dim, and never
        # below the point where halo traffic rivals the level's volume
        # (per axis: each axis sees only its own rank count)
        rb = tuple(max(2 * int(s), 17) for s in mesh.shape)
    else:
        rb = (int(replicate_below),) * naxes
    flags = [[shp[dim + a] >= rb[a] for a in range(naxes)]
             for shp in shapes]
    missing = [axis for a, axis in enumerate(mesh.axis_names)
               if shapes[0][dim + a] < rb[a]]
    if missing:
        raise ValueError(
            f"fine level {tuple(shapes[0])} is too narrow to use mesh "
            f"axis(es) {missing} (needs >= {rb} interior points along "
            f"dims {tuple(range(dim, dim + naxes))}); use a smaller/"
            "1D mesh or a bigger grid")
    layouts = sf.level_layouts(mesh, shapes, dim, flags)
    return layouts, [any(f) for f in flags], rb


class _DenseLevels:
    """The cycle's level hooks on one device: plain tensors."""

    @staticmethod
    def restrict(r, level):
        return _restrict_fw(r)

    @staticmethod
    def zeros_padded(like, level):
        return torch.zeros(tuple(s + 2 for s in like.shape),
                           dtype=like.dtype, device=like.device)

    @staticmethod
    def zeros(like, level):
        return torch.zeros_like(like)

    @staticmethod
    def prolong_padded(ec_pad, level):
        return _prolong_lin(ec_pad[_interior(ec_pad.shape)])

    @staticmethod
    def prolong(ec, level):
        return _prolong_lin(ec)


class _MeshLevels:
    """The cycle's level hooks on a mesh: each level a field on its layout
    (``layouts[level]``), the transfers across rank boundaries."""

    def __init__(self, layouts):
        self.layouts = tuple(layouts)

    def restrict(self, r, level):
        return sf.restrict(r, self.layouts[level], _restrict_fw)

    def zeros_padded(self, like, level):
        return sf.zeros(self.layouts[level], like.dtype, halo=1)

    def zeros(self, like, level):
        return sf.zeros(self.layouts[level], like.dtype)

    def prolong_padded(self, ec_pad, level):
        return sf.prolong(ec_pad, self.layouts[level], _prolong_lin)

    def prolong(self, ec, level):
        return self.prolong_padded(ec.padded(), level)


@dataclasses.dataclass(frozen=True)
class _FineOp:
    """One tiled-kernel operation of the fine level: its plan and the
    scale its padded source takes (1.0: the raw f)."""

    plan: object
    source_scale: float


@dataclasses.dataclass(frozen=True)
class Multigrid:
    """V-cycle solver for a ``PoissonProblem`` (Dirichlet walls only).

    ``nu1``/``nu2`` pre/post smoothing sweeps, ``omega`` the Jacobi
    damping, ``coarse_sweeps`` relaxations on the coarsest level;
    ``smoother`` 'wjacobi' or 'chebyshev' (the coarsest level always relaxes
    with damped Jacobi); ``gamma`` 1 (V-cycle) or 2 (W-cycle);
    ``fine_method`` as in the module docstring; ``tiles`` pins the tiled
    fine level's (t0, t1, t2)."""

    problem: PoissonProblem
    nu1: int = 2
    nu2: int = 2
    omega: float = 2.0 / 3.0
    coarse_sweeps: int = 32
    min_size: int = 3
    smoother: str = "wjacobi"
    cheby_ratio: float = 4.0
    gamma: int = 1
    fine_method: str = "xla"
    tiles: Optional[Tuple[int, int, int]] = None
    interpret: bool = False  # the JAX Pallas flag: accepted, ignored

    def __post_init__(self):
        if self.problem.bc.any_dynamic:
            raise ValueError(
                "multigrid supports Dirichlet walls only (the pure "
                "periodic/Neumann Poisson problem is singular)")
        if self.fine_method not in FINE_METHODS:
            raise ValueError(
                f"unknown fine_method {self.fine_method!r} "
                "(xla | eager | pallas_tiled | tiled)")
        if self.tiled_fine and self.problem.ndim != 3:
            raise ValueError(
                "fine_method='pallas_tiled' is 3D-only; use 'xla'")
        if self.smoother not in ("wjacobi", "chebyshev"):
            raise ValueError(
                f"unknown smoother {self.smoother!r} "
                "(wjacobi | chebyshev)")
        if self.cheby_ratio <= 1.0:
            raise ValueError("cheby_ratio must be > 1")
        if self.gamma not in (1, 2):
            raise ValueError("gamma must be 1 (V-cycle) or 2 (W-cycle)")
        shapes = _level_shapes(self.problem.shape, self.min_size)
        if (self.smoother == "chebyshev" and self.tiled_fine
                and len(shapes) == 1):
            # the single level is the coarsest, which relaxes with damped
            # Jacobi (Chebyshev is a band smoother, not a full solve)
            raise ValueError(
                "chebyshev + pallas_tiled needs a >= 2-level hierarchy "
                "(odd interior widths); use fine_method='xla' for "
                "non-coarsenable grids")
        object.__setattr__(self, "_shapes", shapes)

    @property
    def levels(self) -> int:
        return len(self._shapes)

    @property
    def tiled_fine(self) -> bool:
        return self.fine_method in ("pallas_tiled", "tiled")

    def _as_source(self, f) -> torch.Tensor:
        prob = self.problem
        t = torch.as_tensor(f).to(device=prob.device,
                                  dtype=torch_dtype(prob.dtype))
        if tuple(t.shape) != tuple(prob.shape):
            raise ValueError(f"source shape {tuple(t.shape)} != interior "
                             f"{tuple(prob.shape)}")
        return t

    def _make_cycle(self, levels=None):
        """The level recursion ``cycle(padded, f_scaled, f, level) ->
        padded``, all eager torch ops, in place on ``padded`` (shared by
        the runner's coarse levels, the FMG pass and the sharded runner).
        ``levels`` (``_MeshLevels``) runs it on sharded fields, each level
        on its layout; the default on plain tensors."""
        lv = _DenseLevels if levels is None else levels
        omega = float(self.omega)
        nu1, nu2 = int(self.nu1), int(self.nu2)
        coarse = int(self.coarse_sweeps)
        gamma = int(self.gamma)
        n_levels = self.levels
        two_d = float(2 * self.problem.ndim)
        inv2d = 1.0 / two_d
        h0 = float(self.problem.h)
        use_cheby = self.smoother == "chebyshev"
        ratio = float(self.cheby_ratio)

        def smooth(padded, f_scaled, f, inv_h2, n):
            if use_cheby:
                return _smooth_cheby(padded, f, inv_h2, two_d, n, ratio)
            return _smooth(padded, f_scaled, omega, inv2d, n)

        level_spans = [f"mg.level{n}" for n in range(n_levels)]

        def cycle(padded, f_scaled, f, level):
            with span(level_spans[level]):
                return level_cycle(padded, f_scaled, f, level)

        def level_cycle(padded, f_scaled, f, level):
            # f_scaled = h^2 * f at this level's h
            h = h0 * (2.0 ** level)
            inv_h2 = 1.0 / (h * h)
            if level == n_levels - 1:
                # the coarsest level is a solve over the whole spectrum:
                # always damped Jacobi
                with span("mg.coarsest"):
                    return _smooth(padded, f_scaled, omega, inv2d,
                                   coarse if n_levels > 1
                                   else max(coarse, nu1 + nu2))
            with span("mg.smooth"):
                padded = smooth(padded, f_scaled, f, inv_h2, nu1)
            with span("mg.residual"):
                r = _residual(padded, f, inv_h2, two_d)
            with span("mg.restrict"):
                rc = lv.restrict(r, level + 1)
                rc_scaled = (4.0 * h * h) * rc  # (2h)^2 * r_c
                ec_pad = lv.zeros_padded(rc, level + 1)
            # gamma applications of the coarse method (2: W-cycle), each
            # continuing from the previous estimate
            for _ in range(gamma):
                ec_pad = cycle(ec_pad, rc_scaled, rc, level + 1)
            with span("mg.prolong"):
                sf.add_interior(padded, lv.prolong_padded(ec_pad, level))
            with span("mg.smooth"):
                return smooth(padded, f_scaled, f, inv_h2, nu2)

        return cycle

    def _fine_ops(self):
        """The tiled fine level's ``(pre, res, post, fused)`` operations
        (``fused`` None when ``nu1 == 0``), as the JAX ``_fine_ops``
        builds them."""
        from stencil_tpu_torch.ops.tiled import make_tiled_plan

        ndim = self.problem.ndim
        h0 = float(self.problem.h)
        shape = tuple(self.problem.shape)
        kw = dict(dtype=self.problem.dtype, tiles=self.tiles,
                  has_source=True)
        inv_h2 = 1.0 / (h0 * h0)
        res_tuple = (2.0 * ndim * inv_h2, -inv_h2, 0.0, 1.0)
        fused = None
        if self.smoother == "chebyshev":
            def cheby_op(nu):
                k = max(1, nu)
                return _FineOp(make_tiled_plan(
                    nbsum_spec(ndim), shape, sweeps_per_call=k,
                    cheby_coeffs=_cheby_sweep_coeffs(
                        k, self.cheby_ratio, ndim, h0), **kw), 1.0)

            pre = cheby_op(self.nu1)
            post = pre if self.nu2 in (self.nu1, 0) else cheby_op(self.nu2)
            if self.nu1 >= 1:
                # the residual r = f - L u is one more affine sweep after
                # the smoother; the smoothed iterate is the second output
                fused = _FineOp(make_tiled_plan(
                    nbsum_spec(ndim), shape, sweeps_per_call=self.nu1 + 1,
                    cheby_coeffs=_cheby_sweep_coeffs(
                        self.nu1, self.cheby_ratio, ndim, h0)
                    + (res_tuple,), cheby_dual=True, **kw), 1.0)
        else:
            scale = -(self.omega / (2 * ndim)) * h0 * h0
            spec = wjacobi_spec(ndim, self.omega)
            pre = _FineOp(make_tiled_plan(
                spec, shape, sweeps_per_call=max(1, self.nu1), **kw), scale)
            post = pre if self.nu2 in (self.nu1, 0) else _FineOp(
                make_tiled_plan(spec, shape, sweeps_per_call=self.nu2,
                                **kw), scale)
            if self.nu1 >= 1:
                # weighted Jacobi is also a per-sweep affine form (c, n,
                # pv, s) = (1-omega, omega/2d, 0, -omega h^2/2d)
                wj = (1.0 - self.omega, self.omega / (2 * ndim), 0.0, scale)
                fused = _FineOp(make_tiled_plan(
                    nbsum_spec(ndim), shape, sweeps_per_call=self.nu1 + 1,
                    cheby_coeffs=(wj,) * self.nu1 + (res_tuple,),
                    cheby_dual=True, **kw), 1.0)
        res = _FineOp(make_tiled_plan(residual_spec(ndim, h0), shape,
                                      sweeps_per_call=1, **kw), 1.0)
        return (pre, res, post, fused)

    def _vcycle_fn(self, fine_ops=None):
        """The whole-hierarchy cycle ``vcycle(padded_u, f) -> padded_u``
        (``padded_u`` halo-1, may be updated in place). ``vcycle.prep(f)``
        makes what the cycle needs from ``f`` once, for a caller that runs
        many cycles on one right-hand side; ``vcycle(padded_u,
        vcycle.prep(f))`` equals ``vcycle(padded_u, f)``.

        With ``fine_ops`` (from :meth:`_fine_ops`) the fine level runs on
        the tiled kernel, its padded sources made from ``f`` by ``prep``,
        and only levels >= 1 take the eager ops."""
        nu1, nu2 = int(self.nu1), int(self.nu2)
        coarse = int(self.coarse_sweeps)
        n_levels = self.levels
        h0 = float(self.problem.h)
        bc = self.problem.bc
        cycle = self._make_cycle()

        if fine_ops is None:
            def prep_eager(f):
                return ((h0 * h0) * f, f)

            def vcycle_eager(padded_u, f):
                f_scaled, f = f if isinstance(f, tuple) else prep_eager(f)
                return cycle(padded_u, f_scaled, f, 0)

            vcycle_eager.prep = prep_eager
            return vcycle_eager

        from stencil_tpu_torch.ops.layout import pad_source
        from stencil_tpu_torch.ops.tiled import cheby_dual, source_iterate

        pre, res, post, fused = fine_ops
        gamma = int(self.gamma)
        if n_levels == 1:
            needed = [pre]  # a single level only smooths
        elif fused is not None:
            needed = [fused] + ([post] if nu2 else [])
        else:
            needed = ([pre] if nu1 else []) + [res] \
                + ([post] if nu2 else [])

        def prep_tiled(f):
            # the padded source of each operation the cycle runs, one per
            # distinct (layout, scale)
            made = {}
            for op in needed:
                key = (op.plan.layout, op.source_scale)
                if key not in made:
                    made[key] = pad_source(op.plan, f, op.source_scale, bc)
            return {op: made[(op.plan.layout, op.source_scale)]
                    for op in needed}

        def vcycle_tiled(padded_u, f):
            if isinstance(f, dict):
                src = f
            else:
                with span("mg.prep"):
                    src = prep_tiled(f)
            if n_levels == 1:
                n = -(-max(coarse, nu1 + nu2) // max(1, nu1))
                return source_iterate(pre.plan, padded_u, bc, src[pre],
                                      n_outer=n)
            with span("mg.fine.smooth_residual"):
                if fused is not None:
                    data, r = cheby_dual(fused.plan, padded_u, bc,
                                         src[fused])
                else:
                    data = padded_u
                    if nu1:
                        data = source_iterate(pre.plan, data, bc, src[pre])
                    r_pad = source_iterate(res.plan, data, bc, src[res])
                    r = r_pad[_interior(r_pad.shape)]
            with span("mg.fine.restrict"):
                rc = _restrict_fw(r)
                rc_scaled = (4.0 * h0 * h0) * rc
                ec_pad = torch.zeros(tuple(s + 2 for s in rc.shape),
                                     dtype=padded_u.dtype,
                                     device=padded_u.device)
            for _ in range(gamma):
                ec_pad = cycle(ec_pad, rc_scaled, rc, 1)
            with span("mg.fine.prolong"):
                data[_interior(data.shape)].add_(_prolong_lin(
                    ec_pad[_interior(ec_pad.shape)]))
            if nu2:
                with span("mg.fine.post"):
                    data = source_iterate(post.plan, data, bc, src[post])
            return data

        vcycle_tiled.prep = prep_tiled
        return vcycle_tiled

    def runner(self, f) -> Runner:
        """Registry Runner: ``iterate(grid, n)`` = n V-cycles (so
        ``solver.solve`` drives MG with its chunked protocol; use
        ``check_every=1``). The cycles are queued without a host sync."""
        f_dev = self._as_source(f)
        fine_ops = self._fine_ops() if self.tiled_fine else None
        vcycle = self._vcycle_fn(fine_ops)

        def iterate(grid: HaloGrid, n: int) -> HaloGrid:
            if grid.halo != 1:
                raise ValueError("multigrid expects halo=1 grids")
            aux = vcycle.prep(f_dev)  # hoisted out of the cycle loop
            data = grid.data.clone()
            for _ in range(n):
                data = vcycle(data, aux)
            return HaloGrid(data=data, halo=1, bc=grid.bc)

        info = {"levels": self.levels,
                "level_shapes": [list(s) for s in self._shapes],
                "nu": (self.nu1, self.nu2),
                "omega": self.omega,
                "smoother": self.smoother,
                "gamma": self.gamma,
                "fine_method": self.fine_method}
        if fine_ops is not None:
            info["fine_tiles"] = list(fine_ops[0].plan.tiles)
            info["fine_schedules"] = {
                name: op.plan.schedule for name, op in zip(
                    ("pre", "res", "post", "fused"), fine_ops)
                if op is not None}
        return Runner(
            name=f"multigrid({self.levels} levels, {self.fine_method})",
            iterate=iterate,
            description="geometric V-cycle (weighted-Jacobi smoother, "
                        "full-weighting / linear transfers)",
            plan_info=info,
        )

    def _level_shardings(self, mesh, dim: int = 0,
                         replicate_below: Optional[int] = None):
        """Per-level layouts over a 1D or 2D mesh (``_level_shardings_for``):
        ``(layouts, sharded_flags, replicate_below)``; shared by
        ``sharded_runner`` and the distributed PCG."""
        return _level_shardings_for(self._shapes, self.problem.ndim, mesh,
                                    dim, replicate_below)

    def sharded_runner(self, f, mesh, dim: int = 0,
                       replicate_below: Optional[int] = None) -> Runner:
        """The V/W-cycle over a 1D or 2D mesh (``parallel/mesh.py``): the
        fine grid cut into one block per rank (its ghosts from the padded
        grid, so the Dirichlet walls stay), each level a field on its
        layout, the coarse tail below ``replicate_below`` replicated, one
        copy per card. ``iterate`` scatters the grid and ``f`` once, runs
        the cycles and gathers the result, bitwise ``runner``'s with
        ``fine_method='xla'``. Counterpart of
        ``stencil_tpu/multigrid.py:Multigrid.sharded_runner`` (:744-820)."""
        if self.tiled_fine:
            raise ValueError(
                "sharded_runner runs the all-XLA cycle (GSPMD); "
                "fine_method='pallas_tiled' is single-device — use "
                "method 'sharded_pallas' for distributed plain sweeps")
        layouts, sharded, rb = self._level_shardings(mesh, dim,
                                                     replicate_below)
        cycle = self._make_cycle(_MeshLevels(layouts))
        f_dev = self._as_source(f)
        h0 = float(self.problem.h)

        def iterate(grid: HaloGrid, n: int) -> HaloGrid:
            if grid.halo != 1:
                raise ValueError("multigrid expects halo=1 grids")
            f_l = sf.scatter(layouts[0], f_dev)
            f_scaled = (h0 * h0) * f_l
            u = sf.scatter(layouts[0], grid.data, halo=1)
            for _ in range(n):
                u = cycle(u, f_scaled, f_l, 0)
            data = grid.data.clone()
            data[_interior(data.shape)] = sf.gather(u, data.device)
            return HaloGrid(data=data, halo=1, bc=grid.bc)

        info = {"levels": self.levels,
                "level_shapes": [list(s) for s in self._shapes],
                "nu": (self.nu1, self.nu2),
                "omega": self.omega,
                "smoother": self.smoother,
                "gamma": self.gamma,
                "fine_method": "xla+mesh",
                "mesh": list(mesh.shape),
                "sharded_dim": dim,
                "sharded_levels": sharded,
                "replicate_below": list(rb)}
        return Runner(
            name=f"multigrid_sharded({self.levels} levels, "
                 f"{mesh.size}-rank mesh)",
            iterate=iterate,
            description="distributed geometric V-cycle (sharded levels, "
                        "replicated coarse tail, halo exchange on the "
                        "mesh)",
            plan_info=info,
        )

    def fmg(self, f, n_vcycles: int = 2) -> HaloGrid:
        """Full multigrid: one coarse-to-fine pass that reaches
        discretization-level error. Every level solves the full problem
        with its own walls (level l's padded template is the fine one
        subsampled at even indices); ``f`` is restricted down, the
        coarsest level relaxed, and each finer level initialized by the
        ghost-aware prolongation and polished with ``n_vcycles`` cycles
        (level 0's are the runner's own, tiled fine level included)."""
        f_dev = self._as_source(f)
        G = self.problem.initial_grid()
        n_vcycles = int(n_vcycles)
        cycle = self._make_cycle()
        vcycle = self._vcycle_fn(self._fine_ops() if self.tiled_fine
                                 else None)
        n_levels = self.levels
        ndim = self.problem.ndim
        h0 = float(self.problem.h)
        tmpl = [G.data]
        fs = [f_dev]
        for _ in range(n_levels - 1):
            tmpl.append(tmpl[-1][(slice(None, None, 2),) * ndim])
            fs.append(_restrict_fw(fs[-1]))
        h_c = h0 * (2.0 ** (n_levels - 1))
        u = cycle(tmpl[-1].clone(), (h_c * h_c) * fs[-1], fs[-1],
                  n_levels - 1)
        for level in range(n_levels - 2, -1, -1):
            u = _prolong_full(u)
            # exact walls: re-seat the interior into the level's template
            idx = _interior(u.shape)
            seated = tmpl[level].clone()
            seated[idx] = u[idx]
            u = seated
            if level == 0:
                aux = vcycle.prep(fs[0])
                for _ in range(n_vcycles):
                    u = vcycle(u, aux)
            else:
                h_l = h0 * (2.0 ** level)
                f_scaled = (h_l * h_l) * fs[level]
                for _ in range(n_vcycles):
                    u = cycle(u, f_scaled, fs[level], level)
        return HaloGrid(data=u, halo=1, bc=G.bc)

    def residual_norm(self, grid: HaloGrid, f) -> float:
        """max |f - A u| on the fine level, in the problem dtype (the
        certificate; one host sync)."""
        h = float(self.problem.h)
        r = _residual(grid.data, self._as_source(f), 1.0 / (h * h),
                      float(2 * self.problem.ndim))
        return float(r.abs().max())

    def solve(self, f, tolerance: float = 1e-6,
              max_cycles: int = 50, progress=None):
        """Run V-cycles until the per-cycle update norm < tolerance;
        returns ``solver.SolveResult`` (iterations = cycles)."""
        from stencil_tpu_torch import solver

        return solver.solve(self.runner(f), self.problem.initial_grid(),
                            tolerance=tolerance,
                            max_iterations=max_cycles, check_every=1,
                            progress=progress)


@dataclasses.dataclass(frozen=True)
class OperatorMultigrid:
    """Geometric multigrid for a general stencil operator, built by
    per-level rediscretization: the preconditioning cycle of
    ``krylov.BiCGStab``.

    ``problem`` exposes ``shape``, ``h`` and the operator protocol
    (``with_discretization``, ``operator_data``, ``operator_apply``,
    ``operator_inv_diagonal``): ``HeterogeneousPoissonProblem``, and
    ``PoissonProblem`` too. Each level applies the problem's operator
    discretized at its own spacing; the smoother is damped point Jacobi on
    that operator's diagonal; transfers are the Poisson stack's
    full-weighting / linear pair. Everything is interior-shaped with zero
    walls: the cycle only solves correction equations."""

    problem: object
    nu1: int = 2
    nu2: int = 2
    omega: float = 2.0 / 3.0
    coarse_sweeps: int = 32
    min_size: int = 3
    gamma: int = 1

    def __post_init__(self):
        if self.gamma not in (1, 2):
            raise ValueError("gamma must be 1 (V-cycle) or 2 (W-cycle)")
        if self.nu1 < 0 or self.nu2 < 0 or self.nu1 + self.nu2 == 0:
            raise ValueError("need nu1 + nu2 >= 1 smoothing sweeps")
        shapes = _level_shapes(tuple(self.problem.shape), self.min_size)
        h0 = float(self.problem.h)
        probs = tuple(
            self.problem.with_discretization(shp, h0 * (2.0 ** lvl))
            for lvl, shp in enumerate(shapes))
        for lvl, p in enumerate(probs):
            try:
                p.operator_inv_diagonal(None)
            except ValueError as e:
                raise ValueError(f"level {lvl}: {e}") from e
            except TypeError:
                pass  # the diagonal needs the level's data (field operators)
        object.__setattr__(self, "_shapes", shapes)
        object.__setattr__(self, "_probs", probs)
        object.__setattr__(self, "_datas_cache", None)

    @property
    def levels(self) -> int:
        return len(self._probs)

    def _level_shardings(self, mesh, dim: int = 0,
                         replicate_below: Optional[int] = None):
        """Per-level layouts over a 1D or 2D mesh, the ladder of
        ``Multigrid`` (``_level_shardings_for``); the distributed
        preconditioned BiCGStab and GMRES run the cycle on them."""
        return _level_shardings_for(self._shapes, len(self.problem.shape),
                                    mesh, dim, replicate_below)

    def _level_datas(self, layouts=None):
        """Each level's operator data (``operator_data()``: None for
        constant-tap operators, the weight fields of field operators),
        built once; with ``layouts``, each level's weight fields cut like
        the level (no halo)."""
        if layouts is not None:
            return tuple(sf.distribute(d, lay, lead=1) for d, lay in
                         zip(self._level_datas(), layouts))
        if self._datas_cache is None:
            object.__setattr__(
                self, "_datas_cache",
                tuple(p.operator_data() for p in self._probs))
        return self._datas_cache

    def _make_cycle(self, levels=None):
        """``cycle(x, f, level, datas) -> x`` over interior-shaped
        zero-wall tensors, ``datas`` the ``_level_datas()`` tuple; a new
        tensor, ``x`` unchanged. ``levels`` (``_MeshLevels``) runs it on
        sharded fields, ``datas`` then ``_level_datas(layouts)``."""
        lv = _DenseLevels if levels is None else levels
        probs = self._probs
        nu1, nu2 = int(self.nu1), int(self.nu2)
        omega = float(self.omega)
        coarse = int(self.coarse_sweeps)
        gamma = int(self.gamma)
        n_levels = self.levels

        def A(e, level, data):
            return sf.per_block(probs[level].operator_apply, sf.pad1(e),
                                data)

        def smooth(x, f, level, data, n):
            inv = (probs[level].operator_inv_diagonal(data)
                   if not isinstance(data, ShardedField)
                   else data.map(probs[level].operator_inv_diagonal))
            w = omega * inv
            for _ in range(n):
                x = x + w * (f - A(x, level, data))
            return x

        def cycle(x, f, level, datas):
            if level == n_levels - 1:
                return smooth(x, f, level, datas[level],
                              coarse if n_levels > 1
                              else max(coarse, nu1 + nu2))
            x = smooth(x, f, level, datas[level], nu1)
            rc = lv.restrict(f - A(x, level, datas[level]), level + 1)
            ec = lv.zeros(rc, level + 1)
            for _ in range(gamma):
                ec = cycle(ec, rc, level + 1, datas)
            x = x + lv.prolong(ec, level)
            return smooth(x, f, level, datas[level], nu2)

        return cycle
