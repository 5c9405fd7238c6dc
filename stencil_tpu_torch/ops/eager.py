"""Eager torch stencil sweep: shifted slices summed tap by tap.

Counterpart of ``stencil_tpu/ops/xla.py`` (``apply_spec``, ``sweep``,
``iterate``, ``iterate_dynamic``; ``sweep_source`` and
``iterate_source_dynamic`` are ``iterate`` with ``scaled_source``;
``apply_fields`` and ``iterate_fields_dynamic``, the variable-coefficient
sweep, are :func:`apply_fields` and :func:`iterate_fields`); the ``eager``
method runs it, and the sweep kernels' plain version
(``ops/sweep_kernel.py``) is built from it.

The per-point summation order is the JAX one, and the CUDA kernel's: taps
in ``StencilSpec.weight_groups`` order, each group summed first and
multiplied once by its weight; a uniform-weight spec is one group whose
weight is applied once at the end. A source term is one more add, after
the taps. Each step is a separate add or multiply, so nothing can fuse
into an FMA. Each multiply takes its scalar rounded once to the tensor's
dtype (:func:`round_to`), as JAX's ``jnp.asarray(w, dtype)`` does; in
bfloat16 each add and multiply is then computed in float32 and rounded to
bfloat16, which is what JAX's ``xla`` sweep computes on the CPU.

Where the JAX loop is functional, this one ping-pongs two padded tensors
and writes each sweep into the other's interior: no allocation per sweep.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from stencil_tpu_torch.core.grid import HaloGrid, refresh_dynamic, torch_dtype
from stencil_tpu_torch.core.spec import StencilSpec


@functools.lru_cache(maxsize=256)
def round_to(value: float, dtype) -> float:
    """``value`` rounded once to ``dtype`` (a torch dtype or its name), as a
    Python float: the scalar every multiply of the eager sweep and of the
    kernels' plain version uses, and the value the kernels take as float32
    (exact there for float32 and bfloat16). The conversion goes through
    float32, as ``jnp.asarray(w, dtype)`` converts a Python float; a
    float64 tensor takes ``value`` as it is."""
    dt = torch_dtype(dtype)
    if dt == torch.float64:
        return float(value)
    return float(torch.tensor(float(np.float32(value))).to(dt).item())


def _interior_index(shape, halo: int):
    return tuple(slice(halo, s - halo) for s in shape)


def apply_spec(padded: torch.Tensor, spec: StencilSpec,
               halo: Optional[int] = None,
               out: Optional[torch.Tensor] = None,
               scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One sweep over a padded tensor; returns the new interior.

    ``halo`` is the pad depth of ``padded`` (default: the spec radius).
    The result is written into ``out`` (interior-shaped, may be a view)
    when given. ``scratch`` (interior-shaped) holds the second and later
    weight groups of a non-uniform spec; it is allocated when missing."""
    r = spec.radius if halo is None else halo
    ndim = padded.ndim
    shape = tuple(s - 2 * r for s in padded.shape)
    if out is None:
        out = torch.empty(shape, dtype=padded.dtype, device=padded.device)

    def tap(off):
        return padded[tuple(slice(r + off[d], r + off[d] + shape[d])
                            for d in range(ndim))]

    uw = spec.uniform_weight
    if uw is not None:
        uw = round_to(uw, padded.dtype)
    for g, (w, offs) in enumerate(spec.weight_groups()):
        if g == 0:
            gacc = out
        else:
            if scratch is None:
                scratch = torch.empty_like(out)
            gacc = scratch
        gacc.copy_(tap(offs[0]))
        for off in offs[1:]:
            gacc.add_(tap(off))
        if uw is None:
            gacc.mul_(round_to(w, padded.dtype))
        if g > 0:
            out.add_(gacc)
    if uw is not None:
        out.mul_(uw)
    return out


def sweep(grid: HaloGrid, spec: StencilSpec) -> HaloGrid:
    """One full sweep into a new grid: new interior, BC ring preserved
    (dynamic ghosts refreshed from the new interior)."""
    return iterate(grid, spec, 1)


def iterate(grid: HaloGrid, spec: StencilSpec, iterations: int,
            scaled_source: Optional[torch.Tensor] = None) -> HaloGrid:
    """``iterations`` Jacobi sweeps; ``grid`` is left unchanged. With
    ``scaled_source`` (interior-shaped, already scaled), every sweep is the
    affine update ``u' = S(u) + scaled_source``, the update behind Poisson
    relaxation (``models/poisson.py``).

    Two padded tensors alternate; Dirichlet ghosts are copied once and
    never written, dynamic ghosts are refreshed after every sweep."""
    cur = grid.data.clone()
    nxt = cur.clone()
    idx = _interior_index(cur.shape, grid.halo)
    if scaled_source is not None \
            and tuple(scaled_source.shape) != grid.interior_shape:
        raise ValueError(f"source shape {tuple(scaled_source.shape)} != "
                         f"interior {grid.interior_shape}")
    scratch = None
    if len(spec.weight_groups()) > 1:
        scratch = torch.empty_like(cur[idx])
    for _ in range(iterations):
        apply_spec(cur, spec, grid.halo, out=nxt[idx], scratch=scratch)
        if scaled_source is not None:
            nxt[idx].add_(scaled_source)
        if grid.bc.any_dynamic:
            refresh_dynamic(nxt, grid.halo, grid.bc)
        cur, nxt = nxt, cur
    return HaloGrid(data=cur, halo=grid.halo, bc=grid.bc)



def apply_fields(padded: torch.Tensor, offsets, fields: torch.Tensor,
                 halo: int) -> torch.Tensor:
    """One variable-coefficient sweep: ``out[p] = sum_t fields[t][p] *
    padded[p + offsets[t]]``, per-point tap weights (``fields`` stacks one
    interior-shaped weight array per offset), the terms summed in offset
    order. Returns a new interior-shaped tensor."""
    r = halo
    shape = tuple(s - 2 * r for s in padded.shape)
    acc = None
    for i, off in enumerate(offsets):
        term = fields[i] * padded[tuple(
            slice(r + off[d], r + off[d] + shape[d])
            for d in range(padded.ndim))]
        acc = term if acc is None else acc.add_(term)
    return acc


def iterate_fields(grid: HaloGrid, offsets, fields: torch.Tensor,
                   iterations: int, halo: int = 1) -> HaloGrid:
    """``iterations`` variable-coefficient sweeps (:func:`apply_fields`);
    ``grid`` is left unchanged. Two padded tensors alternate, dynamic
    ghosts refreshed after every sweep."""
    if grid.halo != halo:
        raise ValueError(f"grid halo {grid.halo} != {halo}")
    cur = grid.data.clone()
    nxt = cur.clone()
    idx = _interior_index(cur.shape, halo)
    for _ in range(iterations):
        nxt[idx] = apply_fields(cur, offsets, fields, halo)
        if grid.bc.any_dynamic:
            refresh_dynamic(nxt, halo, grid.bc)
        cur, nxt = nxt, cur
    return HaloGrid(data=cur, halo=halo, bc=grid.bc)
