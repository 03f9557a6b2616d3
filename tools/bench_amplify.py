#!/usr/bin/env python
"""Microbenchmark: decompositions of the seeded gain-only amplify stage.

gl_tot[b, k] = sum_{s<6} gvl[b, s] * gv[ivl[b, s], k]   then  Iv = Iv0 * exp(gl)

Timing protocol: loop inside ONE jit (lax.scan over reps with perturbed
inputs, so every rep is distinct work) and divide by reps.
"""

import functools
import time

import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

B = 65536
K = 82
CELLS = 2756
S = 6
REPS = 20

rng = np.random.default_rng(0)
# coherent-ish indices (nearby rays hit nearby cells, like the real workload)
base = rng.integers(0, CELLS - 64, size=(B // 128, 1, S))
ivl_np = np.clip(base + rng.integers(0, 64, size=(B // 128, 128, S)), 0,
                 CELLS - 1).reshape(B, S).astype(np.int32)
gvl_np = rng.uniform(0.5, 2.0, size=(B, S)).astype(np.float32)
gv_np = rng.uniform(1e-4, 1.0, size=(S // 3, CELLS, K)).astype(np.float32)
iv0_np = rng.uniform(0.0, 1.0, size=(B, K)).astype(np.float32)

u_, s_, vt_ = [], [], []
for seg in range(2):
    u, sv, vt = np.linalg.svd(gv_np[seg].astype(np.float64), full_matrices=False)
    u_.append(u)
    s_.append(sv)
    vt_.append(vt)


def timeit(name, fn, *args):
    f = jax.jit(fn)
    out = f(jnp.int32(0), *args)
    jax.block_until_ready(out)
    dts = []
    for call in (1, 2, 3):
        t0 = time.perf_counter()
        out = f(jnp.int32(call), *args)  # distinct seed per call: no result cache
        jax.block_until_ready(out)
        dts.append((time.perf_counter() - t0) / REPS)
    dt = min(dts)
    print(f"{name:42s} {dt*1e3:8.3f} ms/rep  (3 calls: "
          + ", ".join(f"{d*1e3:.3f}" for d in dts) + ")")
    return dt


def scan_reps(body):
    """body(carry_perturb) -> [B, K]-ish result; summed to keep live."""
    def f(seed, gvl, ivl, gv, iv0):
        def step(carry, ci):
            ivl_r = (ivl + ci + seed) % CELLS
            r = body(gvl + (ci + seed).astype(jnp.float32) * jnp.float32(1e-9),
                     ivl_r, gv, iv0)
            return carry + jnp.sum(r).astype(jnp.float32), None
        tot, _ = jax.lax.scan(step, jnp.float32(0.0),
                              jnp.arange(REPS, dtype=jnp.int32))
        return tot
    return f


# ---- variant A: current production path (f64 accumulate + exp) -----------
def var_a(gvl, ivl, gv, iv0):
    gl = jnp.zeros((B, K), jnp.float64)
    for seg in range(2):
        for sub in range(3):
            s = seg * 3 + sub
            row = gv[seg][ivl[:, s]]
            gl = gl + gvl[:, s, None].astype(jnp.float64) * row.astype(jnp.float64)
    return iv0 * jnp.exp(gl).astype(jnp.float32)


# ---- variant B: f32 accumulate (precision-unsafe; isolates f64 cost) ------
def var_b(gvl, ivl, gv, iv0):
    gl = jnp.zeros((B, K), jnp.float32)
    for seg in range(2):
        for sub in range(3):
            s = seg * 3 + sub
            row = gv[seg][ivl[:, s]]
            gl = gl + gvl[:, s, None] * row
    return iv0 * jnp.exp(gl)


# ---- variant C: gathers only (isolates gather cost) ------------------------
def var_c(gvl, ivl, gv, iv0):
    acc = jnp.zeros((B, K), jnp.float32)
    for seg in range(2):
        for sub in range(3):
            s = seg * 3 + sub
            acc = acc + gv[seg][ivl[:, s]]
    return acc


# ---- variant D: two-float compensated f32 accumulate ----------------------
def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def var_d(gvl, ivl, gv, iv0):
    hi = jnp.zeros((B, K), jnp.float32)
    lo = jnp.zeros((B, K), jnp.float32)
    for seg in range(2):
        for sub in range(3):
            s = seg * 3 + sub
            row = gv[seg][ivl[:, s]]
            p = gvl[:, s, None] * row
            perr = jnp.float32(gvl[:, s, None]) * row - p  # fma residual? no
            hi, e = _two_sum(hi, p)
            lo = lo + e + perr
    gl = hi.astype(jnp.float64) + lo.astype(jnp.float64)
    return iv0 * jnp.exp(gl).astype(jnp.float32)


# ---- variant E: SVD rank-r gathers + matrix-product expand ---------------------------
def make_var_e(rank, f64_expand):
    U = jnp.asarray(np.stack([
        (u_[seg][:, :rank] * s_[seg][:rank]).astype(np.float32)
        for seg in range(2)]))
    V = jnp.asarray(np.stack([
        vt_[seg][:rank].astype(np.float32) for seg in range(2)]))

    def var_e(gvl, ivl, gv, iv0):
        out = None
        for seg in range(2):
            glr = jnp.zeros((B, rank), jnp.float32)
            for sub in range(3):
                s = seg * 3 + sub
                rowr = U[seg][ivl[:, s]]          # [B, rank]
                glr = glr + gvl[:, s, None] * rowr
            if f64_expand:
                part = jnp.dot(glr.astype(jnp.float64),
                               V[seg].astype(jnp.float64))
            else:
                part = jnp.dot(glr, V[seg],
                               preferred_element_type=jnp.float32,
                               precision=jax.lax.Precision.HIGHEST)
            out = part if out is None else out + part
        return iv0 * jnp.exp(out).astype(jnp.float32)
    return var_e


# ---- variant F: padded-row gather (width 128): is gather per-row or per-byte?
gv_pad_np = np.zeros((2, CELLS, 128), np.float32)
gv_pad_np[:, :, :K] = gv_np


def var_f(gvl, ivl, gv, iv0):
    acc = jnp.zeros((B, 128), jnp.float32)
    for seg in range(2):
        for sub in range(3):
            s = seg * 3 + sub
            acc = acc + gv_pad[seg][ivl[:, s]]
    return acc


def main():
    global gv_pad
    gvl = jnp.asarray(gvl_np)
    ivl = jnp.asarray(ivl_np)
    gv = jnp.asarray(gv_np)
    iv0 = jnp.asarray(iv0_np)
    gv_pad = jnp.asarray(gv_pad_np)

    print(f"backend: {jax.default_backend()}, B={B}, K={K}, reps={REPS}")
    timeit("A: production (f64 acc + exp)", scan_reps(var_a), gvl, ivl, gv, iv0)
    timeit("B: f32 acc + exp", scan_reps(var_b), gvl, ivl, gv, iv0)
    timeit("C: gathers only (f32 sum)", scan_reps(var_c), gvl, ivl, gv, iv0)
    timeit("D: two-float acc + exp", scan_reps(var_d), gvl, ivl, gv, iv0)
    for r in (8, 16, 32):
        timeit(f"E: svd rank {r} (f32 HIGHEST mm)",
               scan_reps(make_var_e(r, False)), gvl, ivl, gv, iv0)
    timeit("E64: svd rank 32 (f64 mm)",
           scan_reps(make_var_e(32, True)), gvl, ivl, gv, iv0)
    timeit("F: gathers only, 128-wide rows", scan_reps(var_f), gvl, ivl, gv, iv0)


if __name__ == "__main__":
    main()
