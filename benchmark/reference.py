"""The plain reference: what the benchmark holds the program's answers to.

Plain PyTorch in float64, written from the equations alone. It imports
nothing of the program and takes only what the harness made from the seed
(an interior, wall values, a right-hand side) or the program's output it is
asked to judge.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

Walls = Sequence[Tuple[float, float]]


def _face(t: torch.Tensor, d: int, index) -> torch.Tensor:
    return t[tuple(index if i == d else slice(None) for i in range(t.ndim))]


def jacobi_steps(interior: torch.Tensor, walls: Walls, steps: int,
                 weight: float) -> torch.Tensor:
    """``steps`` sweeps of the 3D 6-neighbour Jacobi average
    ``u'(x) = weight * sum of u at the six face neighbours of x`` on a box
    whose ghost ring holds the Dirichlet wall values ``walls[d] = (lo,
    hi)``, in float64 on ``interior``'s device. Returns the new interior
    (float64)."""
    n = tuple(interior.shape)
    if len(n) != 3 or len(walls) != 3:
        raise ValueError("jacobi_steps runs a 3D box with three wall pairs")
    a = torch.empty(tuple(s + 2 for s in n), dtype=torch.float64,
                    device=interior.device)
    for d, (lo, hi) in enumerate(walls):
        _face(a, d, 0).fill_(float(lo))
        _face(a, d, -1).fill_(float(hi))
    inner = (slice(1, -1),) * 3
    a[inner] = interior.to(torch.float64)
    b = a.clone()
    for _ in range(steps):
        q = b[inner]
        q.copy_(a[:-2, 1:-1, 1:-1])
        q.add_(a[2:, 1:-1, 1:-1])
        q.add_(a[1:-1, :-2, 1:-1])
        q.add_(a[1:-1, 2:, 1:-1])
        q.add_(a[1:-1, 1:-1, :-2])
        q.add_(a[1:-1, 1:-1, 2:])
        q.mul_(weight)
        a, b = b, a
    return a[inner]


def max_rel_error(got: torch.Tensor, want: torch.Tensor,
                  block: int = 32) -> float:
    """``max |got - want| / max |want|``, in float64, ``block`` planes of
    dim 0 at a time."""
    if tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")
    err, scale = 0.0, 0.0
    for a in range(0, got.shape[0], block):
        g = got[a:a + block].to(torch.float64)
        w = want[a:a + block].to(torch.float64)
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return err / scale if scale > 0 else err


def poisson_residual_rel(u: torch.Tensor, f: torch.Tensor, h: float,
                         block: int = 32) -> float:
    """``||f - L u||_2 / ||f||_2`` in float64, ``L`` the 7-point Laplacian
    ``(sum of the six face neighbours - 6 u) / h^2`` with zero Dirichlet
    walls, ``block`` planes of dim 0 at a time."""
    if u.ndim != 3 or tuple(u.shape) != tuple(f.shape):
        raise ValueError(f"u {tuple(u.shape)} and f {tuple(f.shape)}: "
                         "two 3D interiors of one shape")
    n0 = u.shape[0]
    inv_h2 = 1.0 / (float(h) * float(h))
    num, den = 0.0, 0.0
    for a in range(0, n0, block):
        b = min(n0, a + block)
        lo, hi = max(a - 1, 0), min(b + 1, n0)
        p = torch.zeros((hi - lo + 2, u.shape[1] + 2, u.shape[2] + 2),
                        dtype=torch.float64, device=u.device)
        p[1:-1, 1:-1, 1:-1] = u[lo:hi].to(torch.float64)
        o, m = a - lo + 1, b - a
        c = p[o:o + m, 1:-1, 1:-1]
        nb = (p[o - 1:o - 1 + m, 1:-1, 1:-1] + p[o + 1:o + 1 + m, 1:-1, 1:-1]
              + p[o:o + m, :-2, 1:-1] + p[o:o + m, 2:, 1:-1]
              + p[o:o + m, 1:-1, :-2] + p[o:o + m, 1:-1, 2:])
        fb = f[a:b].to(torch.float64)
        r = fb - (nb - 6.0 * c) * inv_h2
        num += float((r * r).sum())
        den += float((fb * fb).sum())
    return (num / den) ** 0.5 if den > 0 else num ** 0.5
