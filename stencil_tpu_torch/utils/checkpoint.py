"""Checkpoint and resume of long iterate runs.

Counterpart of ``stencil_tpu/utils/checkpoint.py`` (``CheckpointState``,
``save``, ``load``, ``latest``, ``CheckpointedRun``) in its format: one
``.npz`` with the interior and a JSON metadata entry (``FORMAT_VERSION``
1: iteration, stencil name, halo, the BC values and dynamic masks, dtype),
so a checkpoint written by either package resumes in the other. A
bfloat16 interior is stored as float32, which holds it exactly (numpy has
no bfloat16); the metadata keeps ``"bfloat16"``, and a resume casts back.

A save writes a temporary file in the target directory, fsyncs it, renames
it into place and fsyncs the directory, so neither a crash nor a power
loss leaves a torn checkpoint. ``CheckpointedRun`` wraps any registry
runner with saves every ``every`` iterations, keeps the newest ``keep``
files, and resumes from the newest one, refusing one of another shape,
stencil or boundary conditions. A resumed grid lies where the incoming
grid lay: on the card, or in host memory for the out-of-core ``streamed``
method, which never puts the whole grid on the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from stencil_tpu_torch.core.grid import (
    DirichletBC, HaloGrid, dtype_name, torch_dtype,
)

FORMAT_VERSION = 1


@dataclasses.dataclass
class CheckpointState:
    interior: np.ndarray
    iteration: int
    spec_name: str
    bc: DirichletBC
    halo: int
    dtype: str = "float32"

    def to_grid(self, dtype=None, device="cuda") -> HaloGrid:
        """The grid on ``device`` (``"cpu"``: host memory, the streamed
        method's residency), in ``dtype`` (default: the saved one), its
        halo filled from the BC."""
        dt = torch_dtype(self.dtype if dtype is None else dtype)
        interior = torch.from_numpy(np.ascontiguousarray(self.interior))
        return HaloGrid.from_interior(interior.to(dt), halo=self.halo,
                                      bc=self.bc, device=device)


def _interior_np(grid: HaloGrid) -> np.ndarray:
    u = grid.interior().detach()
    if u.dtype == torch.bfloat16:
        u = u.float()
    return u.cpu().numpy()


def save(path, grid: HaloGrid, iteration: int, spec_name: str = "") -> Path:
    """Write a checkpoint atomically and durably (temporary file, fsync,
    rename, directory fsync)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {
        "version": FORMAT_VERSION,
        "iteration": int(iteration),
        "spec_name": spec_name,
        "halo": int(grid.halo),
        "bc": [list(v) for v in grid.bc.values],
        "bc_periodic": [bool(p) for p in grid.bc.periodic],
        "bc_neumann": [bool(p) for p in grid.bc.neumann],
        "dtype": dtype_name(grid.dtype),
    }
    interior = _interior_np(grid)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, interior=interior,
                     meta=np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8))
            # without the fsync a rename can land with empty or partial
            # contents after a host crash
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dirfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dirfd)  # persist the rename itself
        finally:
            os.close(dirfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load(path) -> CheckpointState:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {meta.get('version')}")
        per = meta.get("bc_periodic", ())
        neu = meta.get("bc_neumann", ())
        return CheckpointState(
            interior=z["interior"],
            iteration=meta["iteration"],
            spec_name=meta["spec_name"],
            bc=DirichletBC(
                values=tuple(tuple(v) for v in meta["bc"]),
                # absent in older checkpoints: all-Dirichlet, normalized
                # to () so it compares equal to the default BCs
                periodic=tuple(bool(p) for p in per) if any(per) else (),
                neumann=tuple(bool(p) for p in neu) if any(neu) else (),
            ),
            halo=meta["halo"],
            dtype=meta.get("dtype", "float32"),
        )


def latest(directory) -> Optional[Path]:
    """The newest checkpoint in ``directory`` (by the step number in its
    name), or None."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    cands = sorted(directory.glob("step_*.npz"))
    return cands[-1] if cands else None


def _step_path(directory: Path, step: int) -> Path:
    return directory / f"step_{step:010d}.npz"


@dataclasses.dataclass
class CheckpointedRun:
    """A runner with periodic checkpoints and resume.

    ``run(grid, iterations)`` resumes from the newest checkpoint in
    ``directory`` (if any), then alternates ``every`` iterations of the
    runner with a save, keeping the newest ``keep`` files."""

    runner: object                 # registry.Runner
    directory: object
    every: int = 100
    keep: int = 2
    spec_name: str = ""

    def run(self, grid: HaloGrid, iterations: int,
            progress=None) -> Tuple[HaloGrid, int]:
        directory = Path(self.directory)
        start = 0
        ckpt = latest(directory)
        if ckpt is not None:
            state = load(ckpt)
            if state.interior.shape != grid.interior_shape:
                raise ValueError(
                    f"checkpoint shape {state.interior.shape} does not "
                    f"match grid {grid.interior_shape}")
            if (self.spec_name and state.spec_name
                    and state.spec_name != self.spec_name):
                raise ValueError(
                    f"checkpoint at {ckpt} is from stencil "
                    f"{state.spec_name!r}, not {self.spec_name!r}; refusing "
                    "to resume a different problem (use a fresh directory)")
            if state.bc != grid.bc:
                raise ValueError(
                    f"checkpoint at {ckpt} has boundary conditions "
                    f"{state.bc.values} (periodic={state.bc.periodic}, "
                    f"neumann={state.bc.neumann}), "
                    f"grid has {grid.bc.values} "
                    f"(periodic={grid.bc.periodic}, "
                    f"neumann={grid.bc.neumann}); "
                    "refusing to resume (use a fresh directory)")
            # the incoming grid's residency and dtype
            grid = state.to_grid(dtype=grid.dtype, device=grid.device)
            start = state.iteration
            if progress:
                progress(f"resumed from {ckpt} at iteration {start}")
        done = start
        while done < iterations:
            chunk = min(self.every, iterations - done)
            grid = self.runner.iterate(grid, chunk)
            done += chunk
            save(_step_path(directory, done), grid, done, self.spec_name)
            if progress:
                progress(f"checkpoint at iteration {done}")
            existing = sorted(directory.glob("step_*.npz"))
            for old in existing[:-self.keep]:
                old.unlink(missing_ok=True)
        return grid, done
