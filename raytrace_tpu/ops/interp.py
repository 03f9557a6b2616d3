"""Vectorized interpolation / search primitives for the device compute path.

Batched equivalents of the reference's scalar search & interpolation
helpers (src/common/RayTraceImageHelper.h:101-220 and
src/AtomicModel/interp.{h,hpp,cpp}):

* :func:`find_index`        -- batched ``findindex`` (bisection -> compare-sum)
* :func:`find_first_single` -- batched ``findfirstsingle``
* :func:`bilinear`          -- float32 bilinear blend
* :func:`pchip_coefficients` / :func:`pchip_eval` -- monotone cubic hermite
  with the gradients precomputed per interval (the tables are static per
  call, so the gradient-limiting logic runs once on the host instead of
  per evaluation like the reference's ``interp_pchip``)

The searches are reformulated as a broadcast compare + sum-reduce instead of
per-lane bisection: for a sorted grid, ``count(X < Y)`` IS the first index
with ``X[idx] >= Y``: a dense reduction with no gathers and no
data-dependent control flow.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "find_index", "find_first_single", "bilinear",
    "pchip_coefficients", "pchip_eval", "interp_linear",
]


def find_first_single(grid, y):
    """First index i with grid[i] >= y; returns len(grid) if none.

    ``grid``: (n,) sorted; ``y``: (...,) query points. Matches
    ``findfirstsingle`` (RayTraceImageHelper.h:101-117) exactly, including
    the edge behaviors: y < grid[0] -> 0, y > grid[-1] -> n, and otherwise
    the bisection result in [1, n-1] (which returns 1, not 0, for
    y == grid[0] exactly).
    """
    y = jnp.asarray(y)
    n = grid.shape[0]
    count = jnp.sum(grid[None, :] < y[..., None], axis=-1).astype(jnp.int32)
    mid = jnp.clip(count, 1, n - 1)
    return jnp.where(y < grid[0], 0, jnp.where(y > grid[n - 1], n, mid))


def find_index(grid, y):
    """Interpolation-interval index in [1, n-1] (``findindex``,
    RayTraceImageHelper.h:131-143)."""
    n = grid.shape[0]
    return jnp.clip(find_first_single(grid, y), 1, n - 1)


def bilinear(dx, dy, f1, f2, f3, f4):
    """float32 bilinear blend (RayTraceImageHelper.h:153-158)."""
    one = jnp.float32(1.0)
    dx2 = one - dx
    dy2 = one - dy
    return (dx * f2 + dx2 * f1) * dy2 + (dx * f4 + dx2 * f3) * dy


def interp_linear(xi, yi, x):
    """Batched linear interpolation with edge clamping of the interval
    (``interp::interp_linear``, src/AtomicModel/interp.cpp:9-22)."""
    i = jnp.clip(find_first_single(xi, x), 1, xi.shape[0] - 1)
    x0 = xi[i - 1]
    x1 = xi[i]
    dx = (x - x0) / (x1 - x0)
    return (1.0 - dx) * yi[i - 1] + dx * yi[i]


def pchip_coefficients(xi: np.ndarray, yi: np.ndarray):
    """Precompute limited hermite gradients (g1, g2) for every interval.

    Vectorized host-side equivalent of the per-call gradient computation in
    ``interp_pchip`` (RayTraceImageHelper.h:181-214). Interval i spans
    [xi[i-1], xi[i]] for i in 1..n-1; returned arrays are indexed by i-1 and
    normalized to the interval (the hermite form consumes them directly).
    """
    xi = np.asarray(xi, dtype=np.float64)
    yi = np.asarray(yi, dtype=np.float64)
    n = len(xi)
    if n < 2:
        raise ValueError("pchip needs at least 2 points")
    f1 = yi[:-1]  # value at interval start, i-1
    f2 = yi[1:]   # value at interval end, i
    g1 = np.zeros(n - 1)
    g2 = np.zeros(n - 1)

    # --- g1 (gradient at interval start) -----------------------------------
    # interval index i (1-based as in the reference) maps to slot i-1
    # i <= 1: g1 = f2 - f1
    g1[0] = f2[0] - f1[0]
    if n > 2:
        i = np.arange(2, n)  # intervals with a left neighbor
        fm = yi[i - 2]
        fa = yi[i - 1]
        fb = yi[i]
        monotone = ((fa < fb) & (fa > fm)) | ((fa > fb) & (fa < fm))
        dx1 = xi[i - 1] - xi[i - 2]
        dx2 = xi[i] - xi[i - 1]
        a1 = (dx2 - dx1) / dx1
        a2 = dx1 / (dx1 + dx2)
        g = a1 * (fa - fm) + a2 * (fb - fm)
        fx1 = np.abs(fa - fm) / dx1
        fx2 = np.abs(fb - fa) / dx2
        g_max = 2 * dx2 * np.minimum(fx1, fx2)
        g_lim = np.sign(np.where(g >= 0, 1.0, -1.0)) * np.minimum(np.abs(g), g_max)
        g1[i - 1] = np.where(monotone, g_lim, 0.0)

    # --- g2 (gradient at interval end) --------------------------------------
    # i >= n-1: g2 = f2 - f1
    g2[n - 2] = f2[n - 2] - f1[n - 2]
    if n > 2:
        i = np.arange(1, n - 1)  # intervals with a right neighbor
        fa = yi[i - 1]
        fb = yi[i]
        fp = yi[i + 1]
        monotone = ((fb < fa) & (fb > fp)) | ((fb > fa) & (fb < fp))
        dx1 = xi[i] - xi[i - 1]
        dx2 = xi[i + 1] - xi[i]
        a1 = -dx2 / (dx1 + dx2)
        a2 = (dx2 - dx1) / dx2
        g = a1 * (fa - fp) + a2 * (fb - fp)
        fx1 = np.abs(fb - fa) / dx1
        fx2 = np.abs(fp - fb) / dx2
        g_max = 2 * dx1 * np.minimum(fx1, fx2)
        g_lim = np.sign(np.where(g >= 0, 1.0, -1.0)) * np.minimum(np.abs(g), g_max)
        g2[i - 1] = np.where(monotone, g_lim, 0.0)
    return g1, g2


def pchip_eval(xi, yi, g1, g2, x):
    """Batched hermite evaluation matching ``interp_pchip``
    (RayTraceImageHelper.h:168-220), including the linear extrapolation at
    both ends and the N<=2 linear fallback."""
    n = xi.shape[0]
    x = jnp.asarray(x)
    i = jnp.clip(find_first_single(xi, x), 1, n - 1)
    # Hermite on the interior
    f1 = yi[i - 1]
    f2 = yi[i]
    dx = (x - xi[i - 1]) / (xi[i] - xi[i - 1])
    gg1 = g1[i - 1]
    gg2 = g2[i - 1]
    dx2 = dx * dx
    hermite = f1 + dx2 * (2 * dx - 3) * (f1 - f2) + dx * gg1 \
        - dx2 * (gg1 + (1 - dx) * (gg1 + gg2))
    # Linear extrapolation below / above
    lo = (1.0 - (x - xi[0]) / (xi[1] - xi[0])) * yi[0] \
        + (x - xi[0]) / (xi[1] - xi[0]) * yi[1]
    hi_dx = (x - xi[n - 2]) / (xi[n - 1] - xi[n - 2])
    hi = (1.0 - hi_dx) * yi[n - 2] + hi_dx * yi[n - 1]
    if n <= 2:
        return lo
    return jnp.where(x <= xi[0], lo, jnp.where(x >= xi[n - 1], hi, hermite))
