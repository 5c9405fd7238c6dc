"""The plain reference of the 2D cells: the 9-point box relaxation.

Plain PyTorch in float64, written from the equation alone. It imports
nothing of the program and takes only what the harness made from the seed
(an interior and wall values); the drivers compare the program's output
with it by ``reference.max_rel_error``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Walls = Sequence[Tuple[float, float]]

# the eight neighbours (a, b) of the box, (0, 0) left out
BOX9 = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1)
             if (a, b) != (0, 0))


def padded(interior: torch.Tensor, walls: Walls) -> torch.Tensor:
    """``interior`` in float64 inside a ghost ring one cell deep that holds
    the Dirichlet wall values ``walls[d] = (lo, hi)``. d0's faces are
    filled first and d1's after, over the full extent of the other dim, so
    d1's values stand in the four corners: the program's rule, "Dirichlet
    faces are filled in increasing dimension order, so the highest
    Dirichlet dim wins in corners" (``stencil_tpu_torch/core/grid.py``,
    its module docstring)."""
    n0, n1 = interior.shape
    a = torch.empty((n0 + 2, n1 + 2), dtype=torch.float64,
                    device=interior.device)
    (lo0, hi0), (lo1, hi1) = walls
    a[0, :] = float(lo0)
    a[-1, :] = float(hi0)
    a[:, 0] = float(lo1)
    a[:, -1] = float(hi1)
    a[1:-1, 1:-1] = interior.to(torch.float64)
    return a


def box9_steps(interior: torch.Tensor, walls: Walls, steps: int,
               weight: float) -> torch.Tensor:
    """``steps`` sweeps of ``u'(i, j) = weight * sum of u(i + a, j + b)``
    over ``(a, b)`` in ``{-1, 0, 1}^2`` without ``(0, 0)``, on a 2D
    interior whose ghost ring holds the Dirichlet walls (:func:`padded`:
    d1 wins in the corners), in float64 on ``interior``'s device. Returns
    the new interior (float64)."""
    if interior.ndim != 2 or len(walls) != 2:
        raise ValueError("box9_steps runs a 2D grid with two wall pairs")
    a = padded(interior, walls)
    b = a.clone()
    n0, n1 = interior.shape
    for _ in range(steps):
        q = b[1:-1, 1:-1]
        q.zero_()
        for da, db in BOX9:
            q.add_(a[1 + da:1 + da + n0, 1 + db:1 + db + n1])
        q.mul_(weight)
        a, b = b, a
    return a[1:-1, 1:-1]
