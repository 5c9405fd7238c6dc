"""Convergence-driven iteration: run a relaxation until the update
residual drops below a tolerance, instead of a fixed iteration count.

Counterpart of ``stencil_tpu/solver.py`` (``SolveResult``, ``solve``).
The residual is max |x_{n+1} - x_n| over the interior between chunks of
``check_every`` sweeps, computed on the device; only that one scalar
crosses to the host per chunk (one synchronisation). Chunks are rounded up
to the runner's granularity, so no remainder launch runs mid-solve, and a
solve can overshoot by at most one chunk, which for the contraction
mappings these stencils implement only tightens the result.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from stencil_tpu_torch.core.grid import HaloGrid


@dataclasses.dataclass
class SolveResult:
    grid: HaloGrid
    iterations: int
    residual: float
    converged: bool

    def summary(self) -> str:
        tag = "converged" if self.converged else "NOT converged"
        return (f"{tag} after {self.iterations} sweeps, "
                f"residual {self.residual:.3e}")


def solve(
    runner,
    grid: HaloGrid,
    tolerance: float = 1e-6,
    max_iterations: int = 100_000,
    check_every: int = 50,
    progress: Optional[Callable[[str], None]] = None,
) -> SolveResult:
    """Iterate ``runner`` until the per-chunk residual < ``tolerance``.

    ``runner`` is any registry Runner (``iterate(grid, n) -> HaloGrid``).
    The residual compares interiors before and after a chunk, so it bounds
    the per-sweep update from above."""
    g = max(1, getattr(runner, "granularity", 1))
    chunk = max(check_every, g)
    chunk = -(-chunk // g) * g  # round up to runner granularity
    done = 0
    residual = float("inf")
    while done < max_iterations:
        n = min(chunk, max_iterations - done)
        n = max(g, -(-n // g) * g) if done + n < max_iterations else n
        prev = grid.interior()
        grid = runner.iterate(grid, n)
        done += n
        residual = float((grid.interior() - prev).abs().max())
        if progress:
            progress(f"sweep {done}: residual {residual:.3e}")
        if residual < tolerance:
            return SolveResult(grid, done, residual, True)
    return SolveResult(grid, done, residual, False)
