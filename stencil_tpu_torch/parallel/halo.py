"""Sharded eager stencil: per-rank blocks, radius-deep halo exchange every
sweep (methods ``sharded`` and ``sharded_noverlap``).

Counterpart of ``stencil_tpu/parallel/halo.py`` (``_dim_halos``,
``_exchange_dim``, ``ShardedStencil``, :104-304) over the port's eager
sweep (``ops/eager.py:apply_spec``) and single-controller mesh
(``parallel/mesh.py``). No kernel is involved: this is the semantics
reference of the sharded exchange.

- Dims are exchanged in order, each over the blocks already extended in
  the earlier dims, so corner (diagonal) values ride along and box
  stencils see them.
- A sharded periodic dim closes the permutation into the circular chain;
  every other sharded dim uses the open chain, and its mesh-edge ranks
  make their own ghosts: the Dirichlet face values, or for a Neumann dim
  their own edge strip mirrored. An unsharded dim's ghosts are the faces,
  the block's opposite strips (periodic) or its own mirrored strips.
- ``overlap=True`` splits each sweep into an interior part that needs no
  d0 halo and two r-deep bands that do, JAX's interior-first form
  (:218-277), with its corner fix: where a rank sits on a physical minor
  Dirichlet face, the minor ghost cells of its d0 halos take that face's
  values (later dims win in corners). Both forms compute every point with
  the same taps in the same order, so they agree bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from stencil_tpu_torch.core.grid import DirichletBC, HaloGrid
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.ops.eager import apply_spec
from stencil_tpu_torch.parallel.mesh import Mesh


def _on(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def check_divisible(shape, axis_names, mesh: Mesh) -> None:
    """JAX's refusal of a grid dim the mesh axis sharding it does not
    divide (``halo.py:295-300``)."""
    for d, name in enumerate(axis_names):
        if name is not None and shape[d] % mesh.axis_size(name) != 0:
            raise ValueError(
                f"dim {d} ({shape[d]}) not divisible by mesh "
                f"axis {name!r} ({mesh.axis_size(name)})")


def block_index(shape, axis_names, mesh: Mesh, rank: int) -> tuple:
    """The slice of a global array that ``rank`` holds: dim ``d`` cut in
    ``mesh.axis_size(axis_names[d])`` equal parts where sharded."""
    index = []
    for d, name in enumerate(axis_names):
        if name is None:
            index.append(slice(None))
            continue
        n = shape[d] // mesh.axis_size(name)
        i = mesh.axis_index(rank, name)
        index.append(slice(i * n, (i + 1) * n))
    return tuple(index)


@dataclasses.dataclass(frozen=True)
class ShardedStencil:
    """Distributed Jacobi iteration over a named mesh: ``axis_names[d]``
    names the mesh axis sharding grid dim ``d`` (None = not sharded). Each
    sweep exchanges r-deep halos and runs the eager sweep per rank."""

    spec: StencilSpec
    axis_names: Tuple[Optional[str], ...]
    overlap: bool = True

    def _dim_halos(self, mesh: Mesh, xs: List[torch.Tensor], dim: int,
                   bc_lo: float, bc_hi: float, periodic: bool,
                   neumann: bool) -> Tuple[list, list]:
        """Per rank, the (lo, hi) ghost layers, r thick along ``dim``, of
        the blocks ``xs`` (``halo.py:_dim_halos``)."""
        r = self.spec.radius
        name = self.axis_names[dim]
        los = [x.narrow(dim, 0, r) for x in xs]
        his = [x.narrow(dim, x.shape[dim] - r, r) for x in xs]

        def face(x, value):
            shape = tuple(r if d == dim else s for d, s in enumerate(x.shape))
            return torch.full(shape, value, dtype=x.dtype, device=x.device)

        if name is None:
            if periodic:
                return his, los
            if neumann:
                return ([torch.flip(s, (dim,)) for s in los],
                        [torch.flip(s, (dim,)) for s in his])
            return ([face(x, bc_lo) for x in xs],
                    [face(x, bc_hi) for x in xs])
        n = mesh.axis_size(name)
        if periodic:
            hi_halo = mesh.ppermute(los, name,
                                    [(i, (i - 1) % n) for i in range(n)])
            lo_halo = mesh.ppermute(his, name,
                                    [(i, (i + 1) % n) for i in range(n)])
        else:
            # my low strip -> previous rank's high halo; my high strip ->
            # next rank's low halo
            hi_halo = mesh.ppermute(los, name,
                                    [(i, i - 1) for i in range(1, n)])
            lo_halo = mesh.ppermute(his, name,
                                    [(i, i + 1) for i in range(n - 1)])
        out_lo, out_hi = [], []
        for rank, x in enumerate(xs):
            idx = mesh.axis_index(rank, name)
            lo, hi = lo_halo[rank], hi_halo[rank]
            if not periodic and idx == 0:
                lo = torch.flip(los[rank], (dim,)) if neumann \
                    else face(x, bc_lo)
            if not periodic and idx == n - 1:
                hi = torch.flip(his[rank], (dim,)) if neumann \
                    else face(x, bc_hi)
            out_lo.append(_on(lo, x.device))
            out_hi.append(_on(hi, x.device))
        return out_lo, out_hi

    def _exchange_dim(self, mesh: Mesh, xs: List[torch.Tensor], dim: int,
                      bc: DirichletBC) -> List[torch.Tensor]:
        """Each block extended by r ghost layers on both sides of ``dim``."""
        nd = self.spec.ndim
        lo_v, hi_v = bc.values[dim]
        los, his = self._dim_halos(mesh, xs, dim, lo_v, hi_v,
                                   bc.periodic_mask(nd)[dim],
                                   bc.neumann_mask(nd)[dim])
        return [torch.cat([lo, x, hi], dim) for lo, x, hi in
                zip(los, xs, his)]

    def _local_sweep(self, mesh: Mesh, blocks: List[torch.Tensor],
                     bc: DirichletBC) -> List[torch.Tensor]:
        """One sweep of every rank's block (``halo.py:_local_sweep``)."""
        r, nd = self.spec.radius, self.spec.ndim
        n0 = blocks[0].shape[0]
        if not self.overlap or self.axis_names[0] is None or n0 < 4 * r:
            ext = blocks
            for d in range(nd):
                ext = self._exchange_dim(mesh, ext, d, bc)
            return [apply_spec(x, self.spec) for x in ext]
        # interior-first: the minor dims first, then the d0 halos; the
        # interior rows need none of them
        ext1 = blocks
        for d in range(1, nd):
            ext1 = self._exchange_dim(mesh, ext1, d, bc)
        lo0, hi0 = bc.values[0]
        lo_halo, hi_halo = self._dim_halos(
            mesh, ext1, 0, lo0, hi0, bc.periodic_mask(nd)[0],
            bc.neumann_mask(nd)[0])
        dyn = bc.dynamic_mask(nd)
        fixes = [d for d in range(1, nd) if not dyn[d]]
        out = []
        for rank, x in enumerate(ext1):
            lo_h, hi_h = lo_halo[rank], hi_halo[rank]
            if fixes:
                # the corner fix: ghosts may be views of another rank's
                # block, so it writes into copies
                lo_h, hi_h = lo_h.clone(), hi_h.clone()
            for d in fixes:
                name = self.axis_names[d]
                lo_edge = name is None or mesh.axis_index(rank, name) == 0
                hi_edge = name is None or \
                    mesh.axis_index(rank, name) == mesh.axis_size(name) - 1
                lo_d, hi_d = bc.values[d]
                for halo in (lo_h, hi_h):
                    size = halo.shape[d]
                    if lo_edge:
                        halo.narrow(d, 0, r).fill_(lo_d)
                    if hi_edge:
                        halo.narrow(d, size - r, r).fill_(hi_d)
            inner = apply_spec(x, self.spec)
            lo_band = apply_spec(torch.cat([lo_h, x.narrow(0, 0, 2 * r)], 0),
                                 self.spec)
            hi_band = apply_spec(
                torch.cat([x.narrow(0, n0 - 2 * r, 2 * r), hi_h], 0),
                self.spec)
            out.append(torch.cat([lo_band, inner, hi_band], 0))
        return out

    def iterate(self, grid: HaloGrid, iterations: int,
                mesh: Mesh) -> HaloGrid:
        """``iterations`` sweeps of ``grid`` cut into one block per rank;
        ``grid`` is unchanged. Returns a new grid on ``grid``'s device."""
        interior = grid.interior()
        shape = tuple(interior.shape)
        check_divisible(shape, self.axis_names, mesh)
        index = [block_index(shape, self.axis_names, mesh, rank)
                 for rank in range(mesh.size)]
        blocks = [_on(interior[idx], dev)
                  for idx, dev in zip(index, mesh.devices)]
        for _ in range(iterations):
            blocks = self._local_sweep(mesh, blocks, grid.bc)
        out = torch.empty_like(interior)
        for idx, block in zip(index, blocks):
            out[idx] = _on(block, out.device)
        return HaloGrid.from_interior(out, halo=grid.halo, bc=grid.bc,
                                      device=grid.device)
