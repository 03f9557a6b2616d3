#!/usr/bin/env python
"""Cell-coherence census of the amplify stage's gather indices.

The amplify stage gathers one K-wide ``gv`` lineshape row per
(segment, sub-length) slot -- nseg*N_SUB row gathers per ray (the measured
XLA gather floor, ROADMAP.md scale16 breakdown). The closed-form update is
algebraically mergeable whenever two sub-lengths of a segment landed in the
SAME cell (identical gv row: the chain can reuse one fetched row,
src/common/RayTraceImageHelper.h:543-581), so the number of *distinct*
cells per (ray, segment) bounds the gathers actually needed:

* u = 1 (all three sub-lengths in one cell): 1 gather instead of 3
* u = 2: 2 gathers + one [B, K] select
* u = 3: the current 3 gathers

This tool measures, on the real snapshots, the distribution of u per
(ray, segment) AND the per-chunk maximum (what a shape-static
``lax.switch`` over {1,2,3} fetch plans would actually execute, since all
lanes of a chunk share one plan). Run BEFORE building the reduced-gather
amplify: if chunk-max u is 3 everywhere, the static
reduction is dead on arrival and only a per-lane select plan can help.

Usage: python tools/amplify_coherence.py [ase|seed|scale16|scale4seed] ...
CPU-only; ~1 min for ASE, ~15 min for scale16/seeded.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from raytrace_tpu.io.loader import load_input, scale_problem  # noqa: E402
from raytrace_tpu.ops import fast_stepper as fs  # noqa: E402
from raytrace_tpu.ops.pallas_kernel import BLOCK  # noqa: E402

from raytrace_tpu.testing import (ASE_SNAPSHOT as ASE,  # noqa: E402
                                  SEED_SNAPSHOT as SEED)
CHUNK = 65536  # the pallas auto-chunk: what a chunk-level switch sees


def ray_entries(problem):
    """Entry coordinates in the pipeline's natural ray order
    (models/ray_tracer._unflatten_rays, b-fastest)."""
    beam = problem.euv_beam
    src = problem.seed_beam if problem.seed is not None else beam
    nx, ny, na, nb = src.nx, src.ny, src.na, src.nb
    ijkm = np.arange(nx * ny * na * nb, dtype=np.int64)
    m = ijkm % nb
    k = (ijkm // nb) % na
    j = (ijkm // (na * nb)) % ny
    i = ijkm // (ny * na * nb)
    return (np.asarray(src.x)[i], np.asarray(src.y)[j],
            np.asarray(src.a)[k], np.asarray(src.b)[m])


def ivl_census(problem, method):
    """[n, nseg, N_SUB] gather cell ids over the whole workload (the same
    fast_stepper trace whose step sequences are lockstep-identical to the
    pallas kernel)."""
    beam = problem.euv_beam
    use_emis = method == 1
    ft = fs.pack_fast_tables(problem.gain, use_emis)
    X, Y, A, B_ = ray_entries(problem)
    n = len(X)
    nseg = problem.N - 1
    out = np.zeros((n, nseg, 3), np.int32)
    esc = np.zeros(n, bool)
    fn = None
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        pad = CHUNK - (hi - lo)
        rays = {
            "x": jnp.asarray(np.pad(X[lo:hi].astype(np.float32), (0, pad))),
            "y": jnp.asarray(np.pad(Y[lo:hi].astype(np.float32), (0, pad))),
            "a": jnp.asarray(np.pad(A[lo:hi].astype(np.float32), (0, pad))),
            "b": jnp.asarray(np.pad(B_[lo:hi].astype(np.float32), (0, pad))),
        }
        if fn is None:
            def fn(rays):
                res = fs.trace_batch_fast(rays, problem.N, float(beam.dz),
                                          ft, method, use_emis=use_emis)
                return res.ivl, res.escaped
            fn = jax.jit(fn)
        ivl, escaped = fn(rays)
        out[lo:hi] = np.asarray(ivl)[: hi - lo]
        esc[lo:hi] = np.asarray(escaped)[: hi - lo]
    return out, esc


def analyze(name, problem, method):
    t0 = time.time()
    ivl, esc = ivl_census(problem, method)
    n, nseg, _ = ivl.shape
    print(f"\n=== {name}: {n} rays, nseg={nseg}, census {time.time()-t0:.0f}s"
          f" ({esc.sum()} escaped) ===")
    # distinct cells per (ray, segment)
    c0, c1, c2 = ivl[:, :, 0], ivl[:, :, 1], ivl[:, :, 2]
    u = 1 + (c1 != c0).astype(np.int32) + ((c2 != c0) & (c2 != c1))
    for s in range(nseg):
        f = np.bincount(u[:, s], minlength=4)[1:4] / n
        print(f"  seg {s}: u=1 {f[0]*100:6.2f}%  u=2 {f[1]*100:6.2f}%  "
              f"u=3 {f[2]*100:6.2f}%")
    f = np.bincount(u.reshape(-1), minlength=4)[1:4] / (n * nseg)
    print(f"  all : u=1 {f[0]*100:6.2f}%  u=2 {f[1]*100:6.2f}%  "
          f"u=3 {f[2]*100:6.2f}%")
    mean_u = u.mean()
    print(f"  mean distinct cells/segment: {mean_u:.3f}  "
          f"(per-lane gather floor {mean_u/3*100:.1f}% of current "
          f"{nseg*3} rows/ray)")
    # what a chunk-level static plan sees: max u over each 65536-ray chunk
    pad = (-n) % CHUNK
    up = np.pad(u, ((0, pad), (0, 0)), constant_values=1)
    cmax = up.reshape(-1, CHUNK, nseg).max(axis=1)  # [n_chunks, nseg]
    print(f"  chunk-max u per (chunk, seg): "
          f"{np.bincount(cmax.reshape(-1), minlength=4)[1:4].tolist()} "
          f"(counts at u=1/2/3 over {cmax.size} chunk-segments)")
    # and per kernel block (a block-level plan inside the kernel would see)
    tpad = (-n) % BLOCK
    ut = np.pad(u, ((0, tpad), (0, 0)), constant_values=1)
    tmax = ut.reshape(-1, BLOCK, nseg).max(axis=1)
    tb = np.bincount(tmax.reshape(-1), minlength=4)[1:4]
    print(f"  block-max u per (block, seg):  {tb.tolist()} "
          f"(counts at u=1/2/3 over {tmax.size} block-segments)")


def main():
    which = sys.argv[1:] or ["ase"]
    for w in which:
        if w == "ase":
            p, _, _ = load_input(ASE)
            analyze("ASE_small", p, 1)
        elif w == "scale16":
            p, _, _ = load_input(ASE)
            scale_problem(p, 16.0)
            analyze("ASE scale16", p, 1)
        elif w == "seed":
            p, _, _ = load_input(SEED)
            analyze("seed_small", p, 2)
        elif w == "scale4seed":
            p, _, _ = load_input(SEED)
            scale_problem(p, 4.0)
            analyze("seed scale4", p, 2)
        else:
            raise SystemExit(f"unknown workload {w}")


if __name__ == "__main__":
    main()
