"""Method registry: name -> iterate implementation.

Counterpart of ``stencil_tpu/registry.py`` (``Runner``, ``make_xla``,
``_dynamic_kernel_constraints``, ``_make_pallas``, ``_make_pallas_tiled``,
``REGISTRY``, ``get_runner``, ``_make_sharded``, ``make_sharded_pallas``,
``make_rma``, ``make_streamed``). Nine methods are ported:

  ``eager``     the eager torch shifted-slice sweep (``ops/eager.py``), the
                counterpart of ``xla``
  ``tiled``     the hand-written 3D CUDA kernel, k sweeps per launch
                (``ops/tiled.py``), the counterpart of ``pallas_tiled``
  ``slab``      the hand-written 2D CUDA kernel, k sweeps per launch
                (``ops/slab.py``), the counterpart of 2D ``pallas``
  ``varcoeff``  heterogeneous FTCS diffusion (``models/diffusion.py``): the
                3D kernel's coefficient mode at ``-k``, or the eager field
                sweep; ``-c`` checks it against the float64 field golden
  ``sharded``, ``sharded_noverlap``
                the eager sweep per rank of a mesh, radius-deep halos
                exchanged every sweep (``parallel/halo.py``), with or
                without the interior-first split
  ``sharded_pallas``
                the kernels per rank, a k*r-deep exchange per launch, the
                tiled kernel's interior/edge split around it
                (``parallel/sharded_kernel.py``)
  ``rma``       every rank's blocks resident on one card for a whole
                iterate, the strips pushed inside one cooperative launch
                (``parallel/rma.py``, ``csrc/rma_iterate.cu``)
  ``streamed``  a host-resident grid (larger than the card's memory)
                through the tiled kernel one d0 chunk at a time, k sweeps
                per chunk launch (``streaming.py``)

The JAX package's names resolve too, so its command lines run unchanged:
``xla`` is ``eager``; ``pallas`` runs at k=1 and ``pallas_temporal`` at
``-k`` (default 8), on ``slab`` for 2D grids and ``tiled`` for 3D grids;
``pallas_tiled`` is ``tiled`` at ``-k`` (default 1) and, as in the JAX
package, refuses 2D grids.

The sharded methods and ``rma`` run on a single-controller mesh
(``parallel/mesh.py``): ``--mesh`` gives its shape, by default one rank per
visible CUDA device (one on the CPU), and several ranks may share one card
(``rma``'s must). ``--no-overlap`` turns the interior-first split off.

Periodic and Neumann walls (``--periodic``/``--neumann``) run on every
ported method: on the kernels with JAX's gates, raised when the runner is
made (a dynamic lane dim needs k=1, a Neumann leading dim at k>1 a
mirror-symmetric spec; ``--embed`` and ``--slide`` are refused), each
launch with the dynamic faces live (``plan_info["pins"]``); on ``rma``
with JAX's gates for that method (no dynamic lane dim at any k).

Each entry is a factory ``(config, spec, grid) -> Runner`` where a Runner
has ``iterate(grid, n) -> HaloGrid``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from stencil_tpu_torch.core.grid import HaloGrid, dtype_name
from stencil_tpu_torch.core.spec import StencilSpec
from stencil_tpu_torch.ops import eager
from stencil_tpu_torch.ops.slab import SlabStencil
from stencil_tpu_torch.ops.tiled import TiledStencil, dynamic_pins


@dataclasses.dataclass
class Runner:
    name: str
    iterate: Callable[[HaloGrid, int], HaloGrid]
    description: str = ""
    # timing runs use iteration counts that are multiples of this, so no
    # remainder launch enters a timed region
    granularity: int = 1
    # the kernel plan that ran, recorded into the CLI's JSON
    plan_info: dict = dataclasses.field(default_factory=dict)
    # a method's own float64 golden for -c, ``(x0_f64, iters, bc) ->
    # interior_f64``, where the spec golden cannot represent its update
    # (per-point tap fields: 'varcoeff'); NumPy, capped like the NumPy
    # spec golden
    golden_fn: object = None


def make_eager(config, spec: StencilSpec, grid: HaloGrid) -> Runner:
    return Runner(
        name="eager",
        iterate=lambda g, n: eager.iterate(g, spec, n),
        description="eager torch shifted-slice sweep",
        plan_info={"kernel": "eager"},
    )


def _dynamic_kernel_constraints(grid: HaloGrid, spec: StencilSpec, k: int,
                                kernel: str) -> None:
    """JAX's gates for periodic/Neumann walls on a kernel, with its
    messages (``stencil_tpu/registry.py:78-122``): a Neumann leading dim at
    k>1 needs the spec mirror-symmetric in that dim; a dynamic lane (last)
    dim needs k=1. JAX's tap-mode part (a ghost-reading tap mode, defaulted
    to 'slice') has no counterpart: the port has one tap evaluator, which
    reads the ghosts, and ``--tap-mode`` is recorded as ignored."""
    ndim = len(grid.interior_shape)
    neu = grid.bc.neumann_mask(ndim)
    if k > 1:
        for d in range(ndim - 1):
            if neu[d] and not spec.symmetric_in(d):
                raise ValueError(
                    f"a Neumann dim {d} on the {kernel} kernel at "
                    f"temporal depth k={k} needs the stencil "
                    f"mirror-symmetric in dim {d} (pass -k 1 for "
                    "asymmetric taps)"
                )
    if grid.bc.dynamic_mask(ndim)[-1] and k != 1:
        raise ValueError(
            f"a periodic/Neumann lane (last) dim on the {kernel} kernel "
            "needs sweeps_per_call=1 (pass -k 1); dynamic leading dims "
            "run at any temporal depth"
        )


def schedule_info(plan) -> dict:
    """A kernel plan's schedule for ``plan_info`` (3D tiled or 2D slab):
    "march" with its d0 chunk, or "window"."""
    info = {"schedule": plan.schedule}
    if plan.schedule == "march":
        info["chunk"] = plan.tiles[0]
    return info


def _make_kernel(kind: str, stencil_cls, config, spec: StencilSpec,
                 grid: HaloGrid, k: int) -> Runner:
    """A runner on a hand-written kernel (``kind`` "tiled" or "slab");
    ``plan_info`` records the plan, whether its tile came from ``-b``
    (``source``), the launches' pins, and the TPU tuning flags that were
    set and ignored."""
    if grid.bc.any_dynamic:
        _dynamic_kernel_constraints(
            grid, spec, k, "tiled 3D" if kind == "tiled" else "2D slab")
        if kind == "tiled" and config is not None \
                and (config.embed or config.slide):
            raise ValueError(
                "periodic/Neumann BCs: --embed pins Dirichlet thick "
                "ghosts and --slide is unsupported; drop the flag"
            )
    method = stencil_cls(
        spec, grid.interior_shape, dtype=dtype_name(grid.dtype),
        sweeps_per_call=k,
        t0_fixed=config.block if config is not None else None,
        device=grid.device,
    )
    plan = method.plan
    plan_info = {"kernel": kind, "k": k, "tiles": list(plan.tiles),
                 **schedule_info(plan), "smem_bytes": plan.smem_bytes,
                 "source": "flag" if config is not None and config.block
                 else "chooser",
                 "pins": list(dynamic_pins(grid.bc, spec.ndim))}
    ignored = config.ignored_tpu_flags() if config is not None else {}
    if ignored:
        plan_info["ignored"] = ignored
    return Runner(
        name=f"{kind}(k={k},{'x'.join(map(str, plan.tiles))})",
        iterate=method.iterate,
        description=(f"hand-written {spec.ndim}D CUDA kernel, shared-memory "
                     "windows"
                     + ("" if k == 1 else f", {k} sweeps per launch")),
        granularity=k,
        plan_info=plan_info,
    )


def _temporal(config, default: int) -> int:
    return config.temporal if config is not None and config.temporal > 1 \
        else default


def make_tiled(config, spec, grid) -> Runner:
    return _make_kernel("tiled", TiledStencil, config, spec, grid,
                        _temporal(config, 1))


def make_slab(config, spec, grid) -> Runner:
    return _make_kernel("slab", SlabStencil, config, spec, grid,
                        _temporal(config, 1))


def _make_pallas(config, spec, grid, k: int) -> Runner:
    # as in the JAX registry: 2D grids run the slab kernel, 3D the tiled
    if spec.ndim == 2:
        return _make_kernel("slab", SlabStencil, config, spec, grid, k)
    return _make_kernel("tiled", TiledStencil, config, spec, grid, k)


def make_pallas(config, spec, grid) -> Runner:
    return _make_pallas(config, spec, grid, 1)


def make_pallas_temporal(config, spec, grid) -> Runner:
    return _make_pallas(config, spec, grid, _temporal(config, 8))


def make_varcoeff(config, spec: StencilSpec, grid: HaloGrid) -> Runner:
    """Variable-coefficient FTCS diffusion marching, the model family behind
    ``--solve hetero``, as an iterate method: the deterministic
    two-material a(x) of ratio ``--contrast`` (the field ``--solve hetero``
    uses), through the 3D kernel's coefficient mode where
    ``HeterogeneousDiffusion.uses_kernel``, else the eager field sweep. The
    spec must be the radius-1 star the scheme discretizes (jacobi5/7). ``-c``
    checks against the float64 field golden (``golden_fn``)."""
    from stencil_tpu_torch.models.diffusion import (
        HeterogeneousDiffusion, two_material,
    )
    from stencil_tpu_torch.ops import golden

    if spec.name not in ("jacobi5", "jacobi7"):
        raise ValueError(
            "varcoeff discretizes the radius-1 star; run it with "
            "--spec jacobi5 (2D) or jacobi7 (3D)")
    contrast = float(getattr(config, "contrast", 100.0) or 100.0)
    if contrast < 1.0:
        raise ValueError(f"--contrast must be >= 1 (got {contrast})")
    a = two_material(tuple(config.size), lo=1.0 / contrast, hi=1.0, seed=0)
    het = HeterogeneousDiffusion(shape=tuple(config.size), a=a, bc=grid.bc,
                                 dtype=config.dtype, device=grid.device)
    runner = het.runner(method="auto", sweeps_per_call=max(1, config.temporal),
                        t0_fixed=config.block)
    offsets, fields = het.tap_fields()

    def golden_fn(x0, iters, bc):
        return golden.golden_iterate_fields(x0, offsets, fields, iters, bc=bc)

    runner.plan_info["contrast"] = contrast
    runner.golden_fn = golden_fn
    return runner


def _mesh_sizes(config, grid: HaloGrid):
    """``--mesh``, or one rank per visible device of the grid's kind."""
    from stencil_tpu_torch.parallel.mesh import default_mesh_shape

    if config is not None and config.mesh:
        return tuple(config.mesh)
    return default_mesh_shape(grid.device)


def _make_sharded(config, spec: StencilSpec, grid: HaloGrid,
                  overlap: bool) -> Runner:
    """``sharded``/``sharded_noverlap``: grid dim d sharded over mesh axis
    d where that axis has more than one rank (``registry.py:293-316``)."""
    from stencil_tpu_torch.parallel.halo import ShardedStencil
    from stencil_tpu_torch.parallel.mesh import make_mesh

    mesh_sizes = _mesh_sizes(config, grid)
    names = iter(("x", "y", "z"))
    axis_names = tuple(
        next(names) if d < len(mesh_sizes) and mesh_sizes[d] > 1 else None
        for d in range(spec.ndim))
    mesh = make_mesh([s for s in mesh_sizes if s > 1],
                     [n for n in axis_names if n is not None], grid.device)
    method = ShardedStencil(spec, axis_names, overlap=overlap)
    return Runner(
        name="sharded" if overlap else "sharded_noverlap",
        iterate=lambda g, n: method.iterate(g, n, mesh),
        description=(
            "eager sweep per rank + halo exchange over a single-controller "
            "mesh" + (" (interior-first overlap)" if overlap else "")
            + "; counterpart of stencil_tpu/parallel/halo.py:ShardedStencil"),
        plan_info={"kernel": "eager", "mesh": list(mesh_sizes),
                   "overlap": overlap},
    )


def make_sharded(config, spec, grid) -> Runner:
    # --no-overlap switches the interior-first split off, as the
    # sharded_noverlap name does
    return _make_sharded(config, spec, grid,
                         not (config is not None and config.no_overlap))


def make_sharded_noverlap(config, spec, grid) -> Runner:
    return _make_sharded(config, spec, grid, False)


def make_sharded_pallas(config, spec: StencilSpec, grid: HaloGrid) -> Runner:
    """The kernels per rank + a k*r-deep halo exchange (BASELINE config 5):
    ``--mesh a`` shards d0, ``--mesh a b`` d0 and d1 of a 3D grid; JAX's
    gates raised when the runner is made (``registry.py:319-391``).
    ``plan_info`` records the mesh, the local plan, the interior and edge
    tile columns of the split and the bytes one rank receives per outer
    step."""
    from stencil_tpu_torch.ops.tiled import partition_tiles
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.sharded_kernel import (
        ShardedKernelStencil,
    )

    mesh_sizes = _mesh_sizes(config, grid)
    if len(mesh_sizes) > 2:
        raise ValueError("mesh must be 1D or 2D over the leading grid dims")
    axes = ("x", "y")[:len(mesh_sizes)]
    k = _temporal(config, 1)
    if grid.bc.any_dynamic:
        nd = len(grid.interior_shape)
        dyn, neu = grid.bc.dynamic_mask(nd), grid.bc.neumann_mask(nd)
        if dyn[-1]:
            raise ValueError(
                "a periodic/Neumann lane (last) dim is unsupported by "
                "'sharded_pallas'; use the 'sharded' or 'xla' method")
        if k > 1:
            for d in range(nd - 1):
                if neu[d] and not spec.symmetric_in(d):
                    raise ValueError(
                        f"a Neumann dim {d} at temporal depth k>1 needs "
                        f"the stencil mirror-symmetric in dim {d} "
                        "(use -k 1)")
    overlap = not (config is not None and config.no_overlap)
    method = ShardedKernelStencil(
        spec, grid.interior_shape, axis_names=axes,
        dtype=dtype_name(grid.dtype), sweeps_per_call=k,
        t0_fixed=config.block if config is not None else None,
        overlap=overlap)
    plan = method.local_plan(mesh_sizes)  # divisibility and fit, eagerly
    mesh = make_mesh(mesh_sizes, axes, grid.device)
    interior, edge = partition_tiles(plan) if spec.ndim == 3 else ((), ())
    plan_info = {"kernel": "tiled" if spec.ndim == 3 else "slab",
                 "mesh": list(mesh_sizes), "k": k,
                 "local_shape": list(plan.interior_shape),
                 "tiles": list(plan.tiles), **schedule_info(plan),
                 "smem_bytes": plan.smem_bytes, "overlap": overlap,
                 "split": bool(method.splits(mesh_sizes) and interior
                               and edge),
                 "interior_columns": len(interior),
                 "edge_columns": len(edge),
                 "exchange_bytes_per_step": method.exchange_bytes(plan)}
    ignored = config.ignored_tpu_flags() if config is not None else {}
    if ignored:
        plan_info["ignored"] = ignored
    return Runner(
        name=f"sharded_pallas(mesh={'x'.join(map(str, mesh_sizes))},k={k})",
        iterate=lambda g, it: method.iterate(g, it, mesh),
        description=(
            "hand-written kernel per rank + in-place halo exchange over a "
            "single-controller mesh (leading-dim sharding); counterpart of "
            "stencil_tpu/parallel/pallas_sharded.py:ShardedPallasStencil"),
        granularity=k,
        plan_info=plan_info,
    )


def make_rma(config, spec: StencilSpec, grid: HaloGrid) -> Runner:
    """Every rank's blocks resident for a whole iterate, in one
    cooperative launch whose tiles run each step's k sweeps in shared
    memory and write the exchange themselves, pacing each other by flags
    (``csrc/rma_iterate.cu``): ``--mesh a`` shards d0, ``--mesh a b`` d0
    and d1, every rank on one card; ``-k`` sweeps per exchange, in the
    grid's dtype (float32 or bfloat16). Periodic and Neumann walls take
    JAX's gates and messages, raised when the runner is made
    (``registry.py:415-445``: a dynamic lane dim, a Neumann dim at k>1
    with a spec not mirror-symmetric in it, a dynamic unsharded dim
    shallower than k*r), then the card's L2 budget. ``plan_info`` records
    the mesh, the local block, its buffers, the bytes the budget counts
    (``resident_bytes``) and those the kernel touches (``live_bytes``, the
    two slots), those a mesh-interior rank pushes per outer step, the
    tile, the tile count, the flags all tiles wait on per step and one
    block's shared memory."""
    from stencil_tpu_torch.parallel.mesh import make_mesh
    from stencil_tpu_torch.parallel.rma import (
        RmaStencil, push_bytes_per_step, rma_tiles,
    )

    mesh_sizes = _mesh_sizes(config, grid)
    if len(mesh_sizes) > 2:
        raise ValueError("mesh must be 1D or 2D over the leading grid dims")
    axes = ("x", "y")[:len(mesh_sizes)]
    k = _temporal(config, 1)
    if grid.bc.any_dynamic:
        ndim = len(grid.interior_shape)
        per = grid.bc.periodic_mask(ndim)
        neu = grid.bc.neumann_mask(ndim)
        if per[ndim - 1] or neu[ndim - 1]:
            raise ValueError(
                "a periodic/Neumann LANE (last) dim is unsupported by "
                "'rma' (use 'xla', or 'pallas_tiled' at -k 1)")
        if k > 1:
            asym = [d for d in range(ndim - 1)
                    if neu[d] and not spec.symmetric_in(d)]
            if asym:
                raise ValueError(
                    f"Neumann dim(s) {asym} at -k {k} need the stencil "
                    "mirror-symmetric in those dims (use -k 1 for "
                    "asymmetric taps)")
        kr = k * spec.radius
        shallow = [d for d in range(len(mesh_sizes), ndim - 1)
                   if (per[d] or neu[d])
                   and grid.interior_shape[d] < kr]
        if shallow:
            raise ValueError(
                f"dynamic unsharded dim(s) {shallow} are shallower than "
                f"the temporal ghost depth k*r = {kr}")
    method = RmaStencil(spec, grid.interior_shape,
                        dtype=dtype_name(grid.dtype), sweeps_per_call=k)
    mesh = make_mesh(mesh_sizes, axes, grid.device)
    # divisibility, depth and budget, eagerly
    plan = method.plan_for(mesh, grid.bc)
    plan_info = {"kernel": "rma_iterate", "mesh": list(mesh_sizes), "k": k,
                 "local_shape": list(plan.local_shape),
                 "block_shape": list(plan.block_shape),
                 "buffers": plan.num_buffers,
                 "resident_bytes": plan.resident_bytes,
                 "live_bytes": plan.live_bytes,
                 "push_bytes_per_step": push_bytes_per_step(plan)}
    tiles = rma_tiles(plan)
    plan_info.update(tile=list(plan.tile), tiles=tiles.ntiles,
                     waits_per_step=tiles.waits_per_step,
                     shared_bytes=tiles.shared_bytes)
    ignored = config.ignored_tpu_flags() if config is not None else {}
    if ignored:
        plan_info["ignored"] = ignored
    return Runner(
        name=f"rma(mesh={'x'.join(map(str, mesh_sizes))},k={k})",
        iterate=lambda g, it: method.iterate(g, it, mesh),
        description=(
            "every rank's blocks resident on one card, the halos written "
            "in-kernel by the tiles that compute them, one cooperative "
            "launch per run; counterpart of "
            "stencil_tpu/parallel/rma.py:RmaStencil"),
        granularity=k,
        plan_info=plan_info,
    )


def make_streamed(config, spec: StencilSpec, grid: HaloGrid) -> Runner:
    """Out-of-core iterate of a host-resident grid, one d0 chunk at a time
    through the tiled kernel with k*r-deep ghosts from the previous outer
    iterate (``streaming.py``, ``registry.py:464-500``): ``--chunks``
    forces the chunk count, by default sized from the device's memory. It
    runs on ``--device`` wherever the grid lies."""
    from stencil_tpu_torch.streaming import StreamedStencil

    k = _temporal(config, 1)
    if grid.bc.any_dynamic:
        _dynamic_kernel_constraints(grid, spec, k, "streamed (tiled 3D)")
    method = StreamedStencil(
        spec, grid.interior_shape, dtype=dtype_name(grid.dtype),
        sweeps_per_call=k,
        chunks=config.chunks if config is not None else None,
        device=config.device if config is not None else grid.device)
    plan = method.plan
    plan_info = {"kernel": "streamed", "chunks": method.num_chunks,
                 "chunk_planes": [b - a for a, b in method.bounds],
                 "tiles": list(plan.tiles), **schedule_info(plan),
                 "smem_bytes": plan.smem_bytes, "k": k}
    ignored = config.ignored_tpu_flags() if config is not None else {}
    if ignored:
        plan_info["ignored"] = ignored
    return Runner(
        name=f"streamed(C={method.num_chunks},k={k})",
        iterate=method.iterate,
        description=(
            "out-of-core host-resident grid streamed through the tiled "
            "kernel one d0 chunk at a time (k*r-deep ghosts from the host, "
            "pinned copies on their own streams); counterpart of "
            "stencil_tpu/streaming.py:StreamedStencil"),
        granularity=k,
        plan_info=plan_info,
    )


REGISTRY: Dict[str, Callable] = {
    "eager": make_eager,
    "tiled": make_tiled,
    "slab": make_slab,
    "xla": make_eager,
    "pallas": make_pallas,
    "pallas_temporal": make_pallas_temporal,
    "pallas_tiled": make_tiled,
    "sharded": make_sharded,
    "sharded_noverlap": make_sharded_noverlap,
    "sharded_pallas": make_sharded_pallas,
    "rma": make_rma,
    "streamed": make_streamed,
    "varcoeff": make_varcoeff,
}


def get_runner(name: str, config, spec: StencilSpec,
               grid: HaloGrid) -> Runner:
    try:
        factory = REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown method {name!r}; available: {sorted(REGISTRY)}"
        ) from None
    return factory(config, spec, grid)
