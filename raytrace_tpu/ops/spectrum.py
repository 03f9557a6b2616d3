"""Spectral amplification: closed-form integration of dI/dz = j + g I.

Rebuild of the per-ray spectrum loops in ``RayTrace_calc_ray``
(src/common/RayTraceImageHelper.h:534-581):

* emissivity path (ASE): per (segment, sub-length) the lineshape row
  ``gv[cell]`` scales the path-integrated gain/emissivity and the intensity
  is updated with the closed form ``I = j/g (e^{g}-1) + I e^{g}`` with a
  2nd-order Taylor branch for |g| < 1e-3;
* gain-only fast path (seeded): the total log-gain is accumulated first and
  a single ``exp`` applied (RayTraceImageHelper.h:569-581).

Precision: the reference computes this in double. ``dtype=float64``
reproduces that. ``dtype=float32`` keeps the log-gain as an unevaluated two-float (hi, lo)
pair instead: ``exp`` amplifies *argument* rounding by a factor of |g|
(d exp/exp = dg), so a plain float32 exp of a float32 log-gain would be off
by ~|g|*6e-8 relative. Dekker-split products (each f32*f32 exactly as
hi+lo) + error-free two-sum accumulation + an (hi, lo)-aware range-reduced
exp keep the relative error at ~1e-7 independent of |g| with zero float64
arithmetic in the hot path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.ops.stepper import TraceResult

__all__ = ["amplify"]


_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# ln2 = LN2_HI + LN2_LO with LN2_HI carrying 12 trailing zero mantissa bits,
# so n * LN2_HI is exact for the |n| <= 2^11 range reduction produces here
# numpy (not jnp) constants: module import must not initialize the XLA
# backend, or jax.distributed.initialize() in multi-process workers fails
_LN2_HI = float(np.float32(0.693145751953125))
_LN2_LO = float(np.float32(1.42860677e-06))
_SPLIT_MASK = np.uint32(0xFFFFF000)  # keep 12 high mantissa bits

f32 = jnp.float32


def _two_sum(a, b):
    """Error-free f32 addition: a + b = s + err exactly (Knuth two-sum)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _split_prod(a, b):
    """Error-free f32 product via Dekker splitting: a*b = p + err exactly.

    Each factor is split into 12 high + 12 low mantissa bits, so the four
    partial products are exact in f32 (12x12 <= 24-bit mantissa).
    """
    ah = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(a, jnp.uint32) & _SPLIT_MASK, jnp.float32)
    al = a - ah
    bh = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(b, jnp.uint32) & _SPLIT_MASK, jnp.float32)
    bl = b - bh
    p = a * b
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# Horner coefficients as f32 reciprocal constants: this chain runs per
# (ray, k, segment, sub-length);
# f * float32(1/k) differs from f / k by <= 1 ulp per term, far below the
# polynomial's 5e-9 truncation (same trick the steppers use for their
# constant divides). Measured accuracy unchanged (test_exp_fast2_accuracy).
_RCP = {k: float(np.float32(1.0 / k)) for k in (2, 3, 4, 5, 6, 7)}


def _exp_fast2(hi, lo):
    """Unbiased ~1e-7-relative exp of the two-float value hi + lo, pure f32.

    A library float32 exp of the rounded hi alone carries the argument
    rounding, and any bias it has compounds across the per-sub-length
    amplification chain into the golden norm gate. This version range-reduces
    g = n ln2 + f with |f| <= ~ln2/2 using the split-ln2 constants (exact
    n*LN2_HI), evaluates e^f with an f32 Horner Taylor (degree 7, truncation
    5e-9), and scales by 2^n exactly via ldexp.
    """
    n = jnp.round(hi * f32(_LOG2E))
    f = ((hi - n * f32(_LN2_HI)) + lo) - n * f32(_LN2_LO)
    e = f32(1.0) + f * f32(_RCP[7])
    for k in (6, 5, 4, 3, 2):
        e = f32(1.0) + (f * f32(_RCP[k])) * e
    e = f32(1.0) + f * e
    return jnp.ldexp(e, n.astype(jnp.int32))


def _expm1_from_exp(exp_val, hi, lo):
    """expm1 given the already-computed exp of the same (hi, lo) pair:
    direct polynomial when |g| <= ln2/2 (no cancellation), exp-1 otherwise
    (where it is well-conditioned). Reusing ``exp_val`` saves a whole
    second exp polynomial per element on the ASE amplify path; for
    |hi| > ln2/2 the subtraction is bitwise what a fresh exp would give."""
    small = jnp.abs(hi) <= f32(0.5 * _LN2)
    f = jnp.where(small, hi + lo, f32(0.0))
    e = f32(1.0) + f * f32(_RCP[7])
    for k in (6, 5, 4, 3, 2):
        e = f32(1.0) + (f * f32(_RCP[k])) * e
    poly = f * e  # f(1 + f/2(1 + f/3(...)))
    return jnp.where(small, poly, exp_val - f32(1.0))


def _expm1_fast2(hi, lo):
    """Unbiased expm1 of the two-float value hi + lo (standalone form)."""
    small = jnp.abs(hi) <= f32(0.5 * _LN2)
    exp_val = _exp_fast2(jnp.where(small, f32(1.0), hi),
                         jnp.where(small, f32(0.0), lo))
    return _expm1_from_exp(exp_val, hi, lo)


def _exp_fast(g64):
    """f64-argument wrapper kept for external callers/tests: same algorithm
    with the range reduction done on the f64 value."""
    n = jnp.round(g64 * _LOG2E)
    f = (g64 - n * _LN2).astype(jnp.float32)
    e = jnp.float32(1.0) + f * f32(_RCP[7])
    for k in (6, 5, 4, 3, 2):
        e = jnp.float32(1.0) + (f * f32(_RCP[k])) * e
    e = jnp.float32(1.0) + f * e
    return jnp.ldexp(e, n.astype(jnp.int32))


def amplify(res: TraceResult, Iv0, gv, N: int, use_emis: bool,
            dtype=jnp.float64):
    """Apply the amplification ODE along each ray's recorded path.

    ``Iv0``: [B, K] initial (seed) intensity, already zeroed for escaped
    rays. ``gv``: [N-1, cells, K] float32 lineshape tables for segments
    1..N-1 (segment 0 is never read: the kernel always uses the
    high-energy-side segment, RayTraceImageHelper.h:430-441).
    Returns [B, K] of ``dtype``.
    """
    nseg = max(N - 1, 0)
    B, K = Iv0.shape
    dtype = jnp.dtype(dtype)
    f32_mode = dtype == jnp.float32
    Iv = Iv0.astype(dtype)
    if nseg == 0:
        return Iv

    if use_emis:
        for i in range(nseg):
            gv_seg = gv[i]  # [cells, K] f32
            for isub in range(res.gvl.shape[2]):
                gv_row = gv_seg[res.ivl[:, i, isub]]  # [B, K] f32
                el = res.evl[:, i, isub, None].astype(dtype) * gv_row.astype(dtype)
                if f32_mode:
                    # exact two-float product: exp() amplifies argument
                    # rounding, so the log-gain must be better than 1 ulp
                    gl, gl_lo = _split_prod(res.gvl[:, i, isub, None], gv_row)
                    small = jnp.abs(gl) < f32(1e-3)
                    glz = jnp.where(small, f32(0.0), gl)
                    glz_lo = jnp.where(small, f32(0.0), gl_lo)
                    exp_gl = _exp_fast2(glz, glz_lo)
                    em1 = _expm1_from_exp(exp_gl, glz, glz_lo)
                else:
                    gl = (res.gvl[:, i, isub, None].astype(jnp.float64)
                          * gv_row.astype(jnp.float64))
                    small = jnp.abs(gl) < 1e-3
                    exp_gl = jnp.exp(jnp.where(small, 0.0, gl))
                    em1 = exp_gl - 1.0
                gl_safe = jnp.where(small, dtype.type(1.0), gl)
                big = el / gl_safe * em1 + Iv * exp_gl
                taylor = el * (1.0 + 0.5 * gl * (1.0 + 0.3333333333 * gl)) \
                    + Iv * (1.0 + gl * (1.0 + 0.5 * gl))
                Iv = jnp.where(small, taylor, big)
        return Iv

    # gain-only fast path: accumulate the total log-gain, one exp
    # (RayTraceImageHelper.h:569-581)
    if f32_mode:
        # two-float accumulation: Dekker products + two-sum, all f32
        hi = jnp.zeros((B, K), dtype=jnp.float32)
        lo = jnp.zeros((B, K), dtype=jnp.float32)
        for i in range(nseg):
            gv_seg = gv[i]
            for isub in range(res.gvl.shape[2]):
                gv_row = gv_seg[res.ivl[:, i, isub]]
                p, pe = _split_prod(res.gvl[:, i, isub, None], gv_row)
                hi, e = _two_sum(hi, p)
                lo = lo + (e + pe)
        return Iv * _exp_fast2(hi, lo)
    gl_tot = jnp.zeros((B, K), dtype=jnp.float64)
    for i in range(nseg):
        gv_seg = gv[i]
        for isub in range(res.gvl.shape[2]):
            gv_row = gv_seg[res.ivl[:, i, isub]]
            gl_tot = gl_tot + (res.gvl[:, i, isub, None].astype(jnp.float64)
                               * gv_row.astype(jnp.float64))
    return Iv * jnp.exp(gl_tot)
