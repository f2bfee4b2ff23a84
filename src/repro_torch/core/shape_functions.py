"""B-spline particle shape functions (CIC / TSC / QSP) with fixed-support taps.

Counterpart of `repro.core.shape_functions`; the conventions are the same:
positions are in grid units, a particle at ``x`` lives in cell
``floor(x)`` with fractional offset ``d = x - floor(x)``, unstaggered nodes
sit at integer coordinates and staggered ones at ``i + 1/2``.

Every arithmetic step is written out (``t * t * t``, never ``t ** 3``) so
that each operation rounds exactly once, as the reference's does.
"""

from __future__ import annotations

import torch

# (order, staggered) -> (n_taps, base_offset)
SUPPORT: dict[tuple[int, bool], tuple[int, int]] = {
    (1, False): (2, 0),
    (2, False): (4, -1),   # widened: true support 3, base depends on d
    (3, False): (4, -1),
    (1, True): (3, -1),    # widened: true support 2
    (2, True): (3, -1),
    (3, True): (5, -2),    # widened: true support 4
}

ORDERS = (1, 2, 3)

# FLOPs of the canonical *scalar* deposition algorithm per particle (one
# current component = (o+1)^3 fma*2 + 1D factor math), used for the paper's
# "effective computational work" metric (419 FLOPs/particle for QSP, 3 comps).
CANONICAL_FLOPS_PER_PARTICLE = {1: 61, 2: 190, 3: 419}


def bspline(order: int, u: torch.Tensor) -> torch.Tensor:
    """Centered B-spline of given order evaluated at (signed) distance u."""
    a = torch.abs(u)
    zero = torch.zeros_like(a)
    if order == 1:
        return torch.clamp_min(1.0 - a, 0.0)
    if order == 2:
        inner = 0.75 - a * a
        t = 1.5 - a
        outer = 0.5 * (t * t)
        return torch.where(a < 0.5, inner, torch.where(a < 1.5, outer, zero))
    if order == 3:
        inner = 2.0 / 3.0 - a * a + 0.5 * a * a * a
        t = 2.0 - a
        outer = t * t * t / 6.0
        return torch.where(a < 1.0, inner, torch.where(a < 2.0, outer, zero))
    raise ValueError(f"unsupported shape order {order}")


def shape_weights_window(d: torch.Tensor, order: int, staggered: bool, *, n_taps: int, base: int) -> torch.Tensor:
    """1-D shape factors over an explicit tap window: ``(..., n_taps)``.

    Taps outside the true B-spline support evaluate to exactly 0, so a
    window wider than ``SUPPORT[(order, staggered)]`` yields the same
    weights, zero-padded."""
    shift = 0.5 if staggered else 0.0
    taps = [bspline(order, d - float(base + shift + j)) for j in range(n_taps)]
    return torch.stack(taps, dim=-1)


def shape_weights(d: torch.Tensor, order: int, staggered: bool) -> torch.Tensor:
    """1-D shape factors for fractional in-cell position ``d`` on the
    ``SUPPORT[(order, staggered)]`` window: ``(..., T)``."""
    n_taps, base = SUPPORT[(order, staggered)]
    return shape_weights_window(d, order, staggered, n_taps=n_taps, base=base)


def support(order: int, staggered: bool) -> tuple[int, int]:
    """(n_taps, base_offset) for the fixed tap window."""
    return SUPPORT[(order, staggered)]


def unified_support(order: int) -> tuple[int, int]:
    """(n_taps, base_offset) of the smallest window covering both the
    staggered and unstaggered supports of ``order``: order 1 -> (3, -1),
    order 2 -> (4, -1), order 3 -> (5, -2)."""
    base = min(SUPPORT[(order, s)][1] for s in (False, True))
    hi = max(SUPPORT[(order, s)][0] + SUPPORT[(order, s)][1] for s in (False, True))
    return hi - base, base


def packed_axis_weights(d: torch.Tensor, order: int) -> dict[tuple[int, bool], torch.Tensor]:
    """The six 1-D weight sets ``(axis, staggered) -> (..., T)`` on the
    order's unified window, from ``d: (..., 3)``."""
    t, base = unified_support(order)
    return {
        (axis, staggered): shape_weights_window(d[..., axis], order, staggered, n_taps=t, base=base)
        for axis in (0, 1, 2)
        for staggered in (False, True)
    }


def max_guard(order: int) -> int:
    """Guard-cell width that keeps every tap of every stagger in range:
    1, 2, 2 for orders 1, 2, 3."""
    lo = min(SUPPORT[(order, s)][1] for s in (False, True))
    hi = max(SUPPORT[(order, s)][0] + SUPPORT[(order, s)][1] for s in (False, True))
    return max(-lo, hi - 1)
