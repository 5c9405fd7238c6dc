"""Fields cut into one block per rank of the single-controller mesh, for the
distributed solvers (``multigrid.py``, ``krylov.py``).

Counterpart of ``NamedSharding`` plus ``with_sharding_constraint`` in the
JAX package's distributed multigrid and Krylov solves
(``stencil_tpu/multigrid.py:317-365``, ``stencil_tpu/krylov.py:66-102``),
and of the collectives that GSPMD inserts for them, written out:

- a :class:`Layout` says which mesh axis shards which grid dim (axis ``a``
  of a 1D or 2D mesh shards dim ``dim + a``, or the level is replicated
  along it) and where each rank's block starts and ends. The fine level
  is cut into balanced blocks (:func:`balanced_bounds`: the first ``n %
  s`` one point wider, none empty; GSPMD's padded ceil split is a layout
  detail, not semantics). Each coarser level's blocks are derived from its
  parent's: fine boundary ``b`` becomes coarse boundary ``b // 2``
  (:meth:`Layout.derived`), so that a restriction needs a one-deep fine
  halo and a prolongation a one-deep coarse halo, and no reshard;
- a :class:`ShardedField` holds one tensor per distinct (block, device):
  ranks that hold the same block on the same card share one copy (on one
  H100 a replicated level is one tensor). Its blocks are interior-shaped
  (``halo=0``) or carry one ghost layer per face (``halo=1``);
- :meth:`ShardedField.exchange` refreshes the ghosts between ranks through
  ``Mesh.ppermute`` (so every strip is audited), one mesh axis after the
  other over the full padded extent, so that corner ghosts ride along
  (the transfers need them); the ghosts at mesh edges keep what they hold:
  zero walls on the correction levels, the problem's Dirichlet values
  where the field was cut from a padded grid (:func:`scatter`);
- :func:`restrict` and :func:`prolong` apply the one-device transfer to
  each block's window across rank boundaries; :func:`reshard` is the
  all-gather into a level replicated along some axes; :func:`dot` sums
  per-rank partial sums in rank order on rank 0's device (the
  all-reduce). Both record themselves in the audit
  (``parallel/comm_audit.py``).

Every per-block operation is the one-device operation on the block and
its ghosts, point by point the same arithmetic: a multigrid cycle on a
sharded field is bitwise the one-device cycle. A dot product sums in
another order than one ``sum`` over the whole grid, so a Krylov solve on
a mesh agrees with the one-device solve to the rounding of its dots.

The helpers at the end (:func:`dot`, :func:`pad1`, :func:`per_block`,
:func:`zeros_like`, :func:`add_interior`, the ``basis_*`` functions) take
either a tensor (the one-device path, unchanged) or a field, so that each
solver's loop is written once.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stencil_tpu_torch.parallel import comm_audit
from stencil_tpu_torch.parallel.mesh import Mesh


def balanced_bounds(n: int, parts: int) -> Tuple[int, ...]:
    """The ``parts + 1`` boundaries of ``n`` points cut into ``parts``
    balanced blocks, the first ``n % parts`` one point wider; none
    empty."""
    if n < parts:
        raise ValueError(
            f"a grid dim of {n} points cannot be cut into {parts} "
            "non-empty blocks (one per rank along its mesh axis)")
    q, rem = divmod(n, parts)
    return tuple(k * q + min(k, rem) for k in range(parts + 1))


class Layout:
    """Where a field of interior ``shape`` lives on ``mesh``: ``dims[a]``
    the grid dim mesh axis ``a`` shards (None: replicated along ``a``),
    ``bounds[a]`` its ``mesh.shape[a] + 1`` block boundaries."""

    def __init__(self, mesh: Mesh, shape: Sequence[int],
                 dims: Sequence[Optional[int]],
                 bounds: Sequence[Optional[Sequence[int]]]):
        self.mesh = mesh
        self.shape = tuple(int(n) for n in shape)
        self.dims = tuple(dims)
        self.bounds = tuple(None if b is None else tuple(b) for b in bounds)
        self.sharded = tuple(a for a, d in enumerate(self.dims)
                             if d is not None)
        self._axis_of_dim = {self.dims[a]: a for a in self.sharded}
        keys: List[Tuple[tuple, torch.device]] = []
        index: Dict[Tuple[tuple, torch.device], int] = {}
        rank_key = []
        for rank in range(mesh.size):
            coords = mesh.coords(rank)
            key = (tuple(coords[a] for a in self.sharded),
                   mesh.devices[rank])
            if key not in index:
                index[key] = len(keys)
                keys.append(key)
            rank_key.append(index[key])
        self.keys = tuple(keys)
        self._index = index
        self.rank_key = tuple(rank_key)
        # each block's first key, in rank order: the order of the dot sums
        parts: Dict[tuple, int] = {}
        for i, (part, _) in enumerate(keys):
            parts.setdefault(part, i)
        self.part_keys = tuple(parts.values())
        self._part_first = parts

    def same(self, other: "Layout") -> bool:
        return (self.mesh is other.mesh and self.shape == other.shape
                and self.dims == other.dims and self.bounds == other.bounds)

    @property
    def spec(self) -> Tuple[Optional[str], ...]:
        """Per grid dim the mesh axis sharding it, or None (JAX's
        ``PartitionSpec``)."""
        return tuple(self.mesh.axis_names[self._axis_of_dim[d]]
                     if d in self._axis_of_dim else None
                     for d in range(len(self.shape)))

    def axis_of_dim(self, d: int) -> Optional[int]:
        return self._axis_of_dim.get(d)

    def part_range(self, part: tuple, a: int) -> Tuple[int, int]:
        """The block of ``part`` along sharded mesh axis ``a``: [lo, hi)."""
        k = part[self.sharded.index(a)]
        return self.bounds[a][k], self.bounds[a][k + 1]

    def slices(self, i: int, halo: int = 0) -> tuple:
        """Key ``i``'s block of the global array (``halo=1``: of the
        globally padded array, its ghosts included)."""
        part = self.keys[i][0]
        out = []
        for d, n in enumerate(self.shape):
            a = self.axis_of_dim(d)
            lo, hi = (0, n) if a is None else self.part_range(part, a)
            out.append(slice(lo, hi + 2 * halo))
        return tuple(out)

    def key(self, part: tuple, device: torch.device) -> int:
        """The key holding ``part`` on ``device``, or else the block's
        first key (another card's copy)."""
        return self._index.get((part, device), self._part_first[part])

    def derived(self, shape: Sequence[int]) -> "Layout":
        """The next coarser level's layout (interior ``shape``, each fine
        width ``2 n + 1``): every sharded axis keeps its axis, boundary
        ``b`` becomes ``b // 2``."""
        return Layout(self.mesh, shape, self.dims,
                      [None if b is None else [x // 2 for x in b]
                       for b in self.bounds])

    def drop(self, axes) -> "Layout":
        """This layout replicated along mesh ``axes``."""
        return Layout(self.mesh, self.shape,
                      [None if a in axes else d
                       for a, d in enumerate(self.dims)],
                      [None if a in axes else b
                       for a, b in enumerate(self.bounds)])

    def check_nonempty(self, what: str) -> None:
        for a in self.sharded:
            b = self.bounds[a]
            if any(hi <= lo for lo, hi in zip(b, b[1:])):
                raise ValueError(
                    f"{what} {self.shape} cut along dim {self.dims[a]} at "
                    f"{list(b)} leaves a rank of mesh axis "
                    f"{self.mesh.axis_names[a]!r} empty; raise "
                    "replicate_below to at least the axis size")


def fine_layout(mesh: Mesh, shape: Sequence[int], dim: int) -> Layout:
    """Mesh axis ``a`` shards grid dim ``dim + a`` in balanced blocks."""
    naxes = len(mesh.shape)
    return Layout(mesh, shape, [dim + a for a in range(naxes)],
                  [balanced_bounds(shape[dim + a], mesh.shape[a])
                   for a in range(naxes)])


def level_layouts(mesh: Mesh, shapes, dim: int,
                  sharded) -> Tuple[Layout, ...]:
    """The per-level layouts of a coarsening hierarchy: ``sharded[l][a]``
    says whether mesh axis ``a`` shards level ``l`` (a prefix of the
    levels per axis); level 0 balanced, each sharded coarser level derived
    from its parent."""
    out = [fine_layout(mesh, shapes[0], dim)]
    for shp, flags in zip(shapes[1:], sharded[1:]):
        nxt = out[-1].derived(shp)
        nxt = nxt.drop([a for a, on in enumerate(flags) if not on])
        nxt.check_nonempty("level")
        out.append(nxt)
    return tuple(out)


def _to(t, device):
    if isinstance(t, torch.Tensor) and t.device != device:
        return t.to(device)
    return t


class ShardedField:
    """One tensor per key of ``layout`` (see :class:`Layout`), each the
    key's block, interior-shaped (``halo=0``) or with one ghost layer per
    face (``halo=1``). Arithmetic with scalars, 0-dim tensors and fields
    of the same layout applies per block."""

    __slots__ = ("layout", "blocks", "halo")

    def __init__(self, layout: Layout, blocks, halo: int = 0):
        self.layout = layout
        self.blocks = list(blocks)
        self.halo = halo

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """Rank 0's device, where the dot products land."""
        return self.blocks[0].device

    def _arg(self, x, i: int):
        if isinstance(x, ShardedField):
            if x.layout is not self.layout and not x.layout.same(
                    self.layout):
                raise ValueError("fields of different layouts")
            return x.blocks[i]
        return _to(x, self.blocks[i].device)

    def map(self, fn, *args, halo: int = 0) -> "ShardedField":
        """``fn(block, *args)`` per key, a field argument taken by its
        block; a new field of the results."""
        return ShardedField(self.layout, [
            fn(b, *(self._arg(x, i) for x in args))
            for i, b in enumerate(self.blocks)], halo)

    def each(self, fn, *args) -> None:
        """``fn(block, *args)`` per key, for its effect on the block."""
        for i, b in enumerate(self.blocks):
            fn(b, *(self._arg(x, i) for x in args))

    def __add__(self, o):
        return self.map(torch.add, o)

    def __radd__(self, o):
        return self.map(lambda b, x: x + b, o)

    def __sub__(self, o):
        return self.map(torch.sub, o)

    def __rsub__(self, o):
        return self.map(lambda b, x: x - b, o)

    def __mul__(self, o):
        return self.map(lambda b, x: b * x, o)

    def __rmul__(self, o):
        return self.map(lambda b, x: x * b, o)

    def __truediv__(self, o):
        return self.map(lambda b, x: b / x, o)

    def __neg__(self):
        return self.map(torch.neg)

    def to(self, dtype) -> "ShardedField":
        return self.map(lambda b: b.to(dtype), halo=self.halo)

    def interior(self) -> "ShardedField":
        """The blocks of a ``halo=1`` field without their ghosts (views)."""
        return self.map(lambda b: b[tuple(slice(1, s - 1)
                                          for s in b.shape)])

    def exchange(self) -> "ShardedField":
        """Refresh, in place, the ghosts of a ``halo=1`` field between
        neighbouring ranks: per sharded mesh axis in order, two
        ``ppermute``s of one plane each, over the padded extent of the
        other dims (corners ride along). Ghosts at mesh edges are left as
        they are."""
        lay = self.layout
        mesh = lay.mesh
        first = [lay.rank_key.index(i) for i in range(len(lay.keys))]
        for a in lay.sharded:
            d = lay.dims[a]
            name = mesh.axis_names[a]
            n = mesh.shape[a]
            blocks = [self.blocks[k] for k in lay.rank_key]
            los = [b.narrow(d, 1, 1) for b in blocks]
            his = [b.narrow(d, b.shape[d] - 2, 1) for b in blocks]
            # my first plane -> the previous rank's high ghost; my last
            # plane -> the next rank's low ghost
            to_hi = mesh.ppermute(los, name, [(i, i - 1) for i in range(1, n)])
            to_lo = mesh.ppermute(his, name, [(i, i + 1) for i in range(n - 1)])
            for k, b in enumerate(self.blocks):
                rank = first[k]
                if to_hi[rank] is not None:
                    b.narrow(d, b.shape[d] - 1, 1).copy_(to_hi[rank])
                if to_lo[rank] is not None:
                    b.narrow(d, 0, 1).copy_(to_lo[rank])
        return self

    def padded(self) -> "ShardedField":
        """A ``halo=1`` copy with zero walls and the ghosts between ranks
        exchanged (the zero-wall operators' padding)."""
        nd = len(self.layout.shape)
        return self.map(lambda b: F.pad(b, (1, 1) * nd), halo=1).exchange()


def zeros(layout: Layout, dtype, halo: int = 0) -> ShardedField:
    """A field of zeros (``halo=1``: zero ghosts too)."""
    blocks = []
    for i, (_, dev) in enumerate(layout.keys):
        shape = tuple(s.stop - s.start for s in layout.slices(i, halo))
        blocks.append(torch.zeros(shape, dtype=dtype, device=dev))
    return ShardedField(layout, blocks, halo)


def scatter(layout: Layout, t: torch.Tensor, halo: int = 0,
            lead: int = 0) -> ShardedField:
    """Cut the global tensor ``t`` into the blocks of ``layout``, each a
    copy on its key's device. ``halo=1``: ``t`` is the globally padded
    grid, and each block takes its ghosts from it (the Dirichlet values
    at mesh edges, the neighbours' points between ranks). ``lead`` leading
    dims are kept whole (a stack of weight fields)."""
    return ShardedField(layout, [
        t[(slice(None),) * lead + layout.slices(i, halo)].to(dev, copy=True)
        for i, (_, dev) in enumerate(layout.keys)], halo)


def gather(field: ShardedField, device) -> torch.Tensor:
    """The global interior tensor of ``field`` on ``device``."""
    lay = field.layout
    src = field.interior() if field.halo else field
    out = torch.empty(lay.shape, dtype=field.dtype, device=device)
    for i in lay.part_keys:
        out[lay.slices(i)] = _to(src.blocks[i], out.device)
    return out


def distribute(t, layout: Optional[Layout], halo: int = 0, lead: int = 0):
    """``t`` cut into ``layout``'s blocks, or ``t`` itself without a layout
    (the one-device path) or when it is None."""
    if layout is None or t is None:
        return t
    return scatter(layout, t, halo, lead)


def reshard(field: ShardedField, target: Layout) -> ShardedField:
    """``field`` on ``target``, a layout that shards a subset of its axes
    with the same blocks: one all-gather per dropped axis, each key's copy
    concatenated from the blocks along that axis."""
    cur = field
    for a in [a for a in field.layout.sharded if a not in target.sharded]:
        lay = cur.layout.drop([a])
        d = cur.layout.dims[a]
        pos = cur.layout.sharded.index(a)
        blocks = []
        for part, dev in lay.keys:
            pieces = []
            for c in range(lay.mesh.shape[a]):
                full = list(part)
                full.insert(pos, c)
                src = cur.blocks[cur.layout.key(tuple(full), dev)]
                pieces.append(_to(src, dev))
            blocks.append(torch.cat(pieces, d))
        comm_audit.record_collective("all-gather",
                                     (lay.mesh.axis_names[a],), blocks[0])
        cur = ShardedField(lay, blocks)
    if not cur.layout.same(target):
        raise ValueError(f"cannot reshard {field.layout.spec} onto "
                         f"{target.spec}")
    return ShardedField(target, cur.blocks)


def restrict(r: ShardedField, coarse: Layout, restrict_fn) -> ShardedField:
    """The one-device restriction ``restrict_fn`` (coarse ``i`` at fine
    ``2 i + 1``, reading fine ``2 i .. 2 i + 2``) of the interior field
    ``r``, onto ``coarse``: each block restricts its window of the fine
    level, one point beyond its own where the coarse block starts or ends
    at an odd fine index (the one-deep halo), then the all-gather where
    ``coarse`` is replicated."""
    lay = r.layout
    rp = r.padded()
    blocks = []
    for i, (part, _) in enumerate(lay.keys):
        win = []
        for d, n in enumerate(lay.shape):
            a = lay.axis_of_dim(d)
            if a is None:
                win.append(slice(1, 1 + n))
                continue
            lo, hi = lay.part_range(part, a)
            clo, chi = lo // 2, hi // 2
            start = 2 * clo - lo + 1  # fine 2*clo in the padded block
            win.append(slice(start, start + 2 * (chi - clo) + 1))
        blocks.append(restrict_fn(rp.blocks[i][tuple(win)]))
    return reshard(ShardedField(lay.derived(coarse.shape), blocks), coarse)


def prolong(ec_pad: ShardedField, fine: Layout, prolong_fn) -> ShardedField:
    """The one-device prolongation ``prolong_fn`` (of an interior array,
    zero walls) of the ``halo=1`` coarse field ``ec_pad``, onto ``fine``:
    each fine block prolongs its coarse window, one coarse point beyond
    its own on each side (the exchanged ghosts, or its cut of a replicated
    level), and keeps the fine points that window determines exactly."""
    clay = ec_pad.layout
    ec_pad.exchange()
    blocks = []
    for part, dev in fine.keys:
        cpart = tuple(part[fine.sharded.index(a)] for a in clay.sharded)
        src = _to(ec_pad.blocks[clay.key(cpart, dev)], dev)
        win, out = [], []
        for d, n in enumerate(fine.shape):
            a = fine.axis_of_dim(d)
            if a is None:
                win.append(slice(None))
                out.append(slice(2, 2 + n))
                continue
            lo, hi = fine.part_range(part, a)
            clo, chi = lo // 2, hi // 2
            # coarse [clo - 1, chi + 1): the whole padded block where the
            # coarse level shards this axis, else its cut
            win.append(slice(None) if a in clay.sharded
                       else slice(clo, chi + 2))
            # local fine 0 is global fine 2 (clo - 1)
            start = lo - 2 * clo + 2
            out.append(slice(start, start + hi - lo))
        blocks.append(prolong_fn(src[tuple(win)])[tuple(out)])
    return ShardedField(fine, blocks)


# -- one loop for both paths: a tensor or a field --

def dot(a, b):
    """``sum(a * b)``: for fields, each block's partial sum added in rank
    order on rank 0's device (the all-reduce)."""
    if not isinstance(a, ShardedField):
        return (a * b).sum()
    lay = a.layout
    dev = a.device
    total = None
    for i in lay.part_keys:
        s = _to((a.blocks[i] * b.blocks[i]).sum(), dev)
        total = s if total is None else total + s
    comm_audit.record_collective("all-reduce",
                                 [lay.mesh.axis_names[x] for x in lay.sharded],
                                 total)
    return total


def pad1(x):
    """``x`` with one zero ghost layer per face (a field: and its ghosts
    between ranks exchanged)."""
    if isinstance(x, ShardedField):
        return x.padded()
    return F.pad(x, (1, 1) * x.ndim)


def per_block(fn, *args):
    """``fn(*args)``, per block where the first argument is a field."""
    if isinstance(args[0], ShardedField):
        return args[0].map(fn, *args[1:])
    return fn(*args)


def zeros_like(x):
    if isinstance(x, ShardedField):
        return zeros(x.layout, x.dtype, x.halo)
    return torch.zeros_like(x)


def interior(padded):
    if isinstance(padded, ShardedField):
        return padded.interior()
    return padded[tuple(slice(1, s - 1) for s in padded.shape)]


def add_interior(padded, e):
    """``padded``'s interior += ``e``, in place."""
    if isinstance(padded, ShardedField):
        padded.each(add_interior, e)
        return padded
    padded[tuple(slice(1, s - 1) for s in padded.shape)].add_(e)
    return padded


def seat(padded0: torch.Tensor, x) -> torch.Tensor:
    """A copy of the global padded grid ``padded0`` with ``x`` (a tensor or
    field of its interior) added to its interior."""
    if isinstance(x, ShardedField):
        x = gather(x, padded0.device)
    padded = padded0.clone()
    return add_interior(padded, x)


def basis(rows: int, like):
    """A stack of ``rows`` zero vectors shaped like ``like`` (GMRES's
    Arnoldi basis): a ``(rows, numel)`` tensor, or per block one."""
    if isinstance(like, ShardedField):
        return ShardedField(like.layout, [
            torch.zeros((rows, b.numel()), dtype=b.dtype, device=b.device)
            for b in like.blocks])
    return torch.zeros((rows, like.numel()), dtype=like.dtype,
                       device=like.device)


def basis_put(V, j: int, v) -> None:
    if isinstance(V, ShardedField):
        for Vb, vb in zip(V.blocks, v.blocks):
            Vb[j] = vb.reshape(-1)
        return
    V[j] = v.reshape(-1)


def basis_row(V, j: int, like):
    """Row ``j`` of the basis, shaped like ``like``."""
    if isinstance(V, ShardedField):
        return ShardedField(like.layout, [
            Vb[j].reshape(b.shape) for Vb, b in zip(V.blocks, like.blocks)])
    return V[j].reshape(like.shape)


def basis_dots(V, k: int, w):
    """The ``k`` dot products of the first ``k`` rows with ``w`` (one
    all-reduce of a ``k``-vector for fields)."""
    if not isinstance(V, ShardedField):
        return torch.mv(V[:k], w.reshape(-1))
    lay = w.layout
    dev = w.device
    total = None
    for i in lay.part_keys:
        s = _to(torch.mv(V.blocks[i][:k], w.blocks[i].reshape(-1)), dev)
        total = s if total is None else total + s
    comm_audit.record_collective("all-reduce",
                                 [lay.mesh.axis_names[x] for x in lay.sharded],
                                 total)
    return total


def basis_combine(V, k: int, coeffs, like):
    """``sum_i coeffs[i] * row_i`` over the first ``k`` rows, shaped like
    ``like``."""
    if isinstance(V, ShardedField):
        return ShardedField(like.layout, [
            torch.mv(Vb[:k].t(), _to(coeffs, Vb.device)).reshape(b.shape)
            for Vb, b in zip(V.blocks, like.blocks)])
    return torch.mv(V[:k].t(), coeffs).reshape(like.shape)
