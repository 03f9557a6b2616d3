"""Seed-beam intensity evaluation (rebuild of ``calc_seed_inline``,
src/common/RayTraceImageHelper.h:230-247).

The seed profile is separable: ``I(x,y,a,b,v) = f0 fx(x) fy(y) fa(a) fb(b) fv(v)``
with each factor pchip-interpolated on its own grid. The monotone-hermite
gradients are precomputed per interval on the host
(:func:`raytrace_tpu.ops.interp.pchip_coefficients`), so the device
evaluation is a gather + cubic polynomial.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytrace_tpu.models.problem import DeviceSeed
from raytrace_tpu.ops.interp import pchip_eval

__all__ = ["calc_seed_batch", "calc_seed_factor", "EntrySeedTables",
           "make_entry_seed_tables", "calc_seed_entry"]


def calc_seed_factor(seed: DeviceSeed, x, y, a, b):
    """Scalar seed weight ``f`` at phase-space points (without the frequency
    profile): the product of the four pchip factors, clamped to >= 0 and
    zeroed outside the table's box (RayTraceImageHelper.h:234-244)."""
    pts = (x, y, a, b)
    inside = jnp.ones(jnp.shape(x), dtype=bool)
    f = seed.f0
    for axis in range(4):
        p = jnp.asarray(pts[axis], jnp.float64)
        inside = inside & (p >= seed.lo[axis]) & (p <= seed.hi[axis])
        f = f * pchip_eval(seed.xs[axis], seed.fs[axis],
                           seed.g1s[axis], seed.g2s[axis], p)
    f = jnp.maximum(f, 0.0)
    return jnp.where(inside, f, 0.0)


def calc_seed_batch(seed: DeviceSeed, x, y, a, b, K: int):
    """Full seed spectrum [B, K]: factor * frequency profile f[4]."""
    f = calc_seed_factor(seed, x, y, a, b)
    return f[:, None] * seed.fv[None, :K]


class EntrySeedTables(NamedTuple):
    """Per-axis seed factors pre-evaluated at the (static) ray-grid points.

    Forward (method 2) seeding evaluates the seed at the ray *entry*
    coordinates (RayTraceImageHelper.h:530-533), which are exactly the
    seed-beam grid points -- so the four pchip interpolations collapse to
    one evaluation per distinct grid value, done once per call. Out-of-box
    values are zeroed per axis (zeroing any factor zeroes the product,
    which matches the reference's inside-the-box check).
    """

    tx: jax.Array  # [src_nx] f64
    ty: jax.Array
    ta: jax.Array
    tb: jax.Array
    fv: jax.Array  # [K] f64
    f0: jax.Array  # scalar f64


def make_entry_seed_tables(seed: DeviceSeed, src_grids, K: int) -> EntrySeedTables:
    """Precompute per-axis factors at float32-cast grid points (the kernel
    receives the ray coords as float32 casts of the f64 grids)."""
    tabs = []
    for axis, grid in enumerate(src_grids):
        pts = jnp.asarray(grid).astype(jnp.float32).astype(jnp.float64)
        vals = pchip_eval(seed.xs[axis], seed.fs[axis], seed.g1s[axis],
                          seed.g2s[axis], pts)
        inside = (pts >= seed.lo[axis]) & (pts <= seed.hi[axis])
        tabs.append(jnp.where(inside, vals, 0.0))
    return EntrySeedTables(tx=tabs[0], ty=tabs[1], ta=tabs[2], tb=tabs[3],
                           fv=seed.fv[:K], f0=seed.f0)


def calc_seed_entry(tables: EntrySeedTables, i, j, k, m, K: int):
    """Seed spectrum [B, K] from precomputed per-axis factor tables."""
    f = tables.f0 * tables.tx[i] * tables.ty[j] * tables.ta[k] * tables.tb[m]
    f = jnp.maximum(f, 0.0)
    return f[:, None] * tables.fv[None, :K]
