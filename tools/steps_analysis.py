#!/usr/bin/env python
"""Micro-step census + tile-utilization analysis of the trace stage.

The pallas stepper pays, per block of TILE rays and per segment, the MAX
micro-step count over the block's lanes (every lane rides the same
vector registers; finished lanes idle masked). This tool measures the true
per-ray micro-step counts (fast_stepper.DEBUG_COUNTERS, identical step
sequences to the pallas kernel by the lockstep tests) on the real
workloads and computes:

* the per-ray step distribution (how heavy is the tail?),
* the kernel cost model: rounds = sum over tiles of sum over segments of
  the tile max  (up to the constant per-round op cost),
* tile utilization = total true steps / (rounds * TILE),
* the same under hypothetical ray orders (perfect cost sort, cheap proxy
  sorts like |x| or |y|) -- quantifying the ceiling of any reordering
  lever BEFORE paying device-sort or implementation cost.

Usage:  python tools/steps_analysis.py [ase|seed|scale16] ...

CPU-only (forces the cpu platform); ~1 min for ASE, ~15 min seeded.
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

TILE = 128  # rays per pallas kernel block (ops/pallas_kernel.BLOCK)

from raytrace_tpu.testing import (ASE_SNAPSHOT as ASE,  # noqa: E402
                                  SEED_SNAPSHOT as SEED)


def ray_entries(problem):
    """Entry coordinates in the pipeline's ray order (b-fastest unflatten
    of consecutive flat indices, models/ray_tracer._unflatten_rays)."""
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


def census(problem, method, chunk):
    """Per-ray, per-segment micro-step counts over the whole workload."""
    beam = problem.euv_beam
    use_emis = method == 1
    ft = fs.pack_fast_tables(problem.gain, use_emis)
    X, Y, A, B_ = ray_entries(problem)
    n = len(X)
    nseg = problem.N - 1
    out = np.zeros((n, nseg), np.int32)
    fs.DEBUG_COUNTERS = True
    try:
        fn = None
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            pad = chunk - (hi - lo)
            rays = {
                "x": jnp.asarray(np.pad(X[lo:hi].astype(np.float32), (0, pad))),
                "y": jnp.asarray(np.pad(Y[lo:hi].astype(np.float32), (0, pad))),
                "a": jnp.asarray(np.pad(A[lo:hi].astype(np.float32), (0, pad))),
                "b": jnp.asarray(np.pad(B_[lo:hi].astype(np.float32), (0, pad))),
            }
            if fn is None:
                def fn(rays):
                    _, ctr = fs.trace_batch_fast(
                        rays, problem.N, float(beam.dz), ft, method,
                        use_emis=use_emis)
                    return jnp.stack(ctr["steps_cum"], axis=1)
                fn = jax.jit(fn)
            cum = np.asarray(fn(rays))[: hi - lo]
            out[lo:hi] = np.diff(cum, axis=1, prepend=0)
    finally:
        fs.DEBUG_COUNTERS = False
    return out


def tile_cost(steps_per_seg, order=None):
    """Kernel cost model: sum over tiles of per-segment tile maxima
    (rounds), and utilization against the true total work."""
    s = steps_per_seg if order is None else steps_per_seg[order]
    n = len(s)
    pad = (-n) % TILE
    if pad:
        s = np.pad(s, ((0, pad), (0, 0)))
    tiles = s.reshape(-1, TILE, s.shape[1])
    rounds = tiles.max(axis=1).sum()
    total = int(steps_per_seg.sum())
    return int(rounds), total / (int(rounds) * TILE)


def analyze(name, problem, method, chunk=65536):
    t0 = time.time()
    steps = census(problem, method, chunk)
    per_ray = steps.sum(axis=1)
    print(f"\n=== {name}: {len(per_ray)} rays, N={problem.N}, "
          f"census {time.time()-t0:.0f}s ===")
    q = np.percentile(per_ray, [50, 90, 99, 99.9, 100])
    print(f"per-ray steps: mean {per_ray.mean():.1f}  "
          f"p50/p90/p99/p99.9/max {q.astype(int)}")
    rows = []
    r0, u0 = tile_cost(steps)
    rows.append(("natural order", r0, u0, 1.0))
    # perfect (oracle) sort by total per-ray cost -- the reordering ceiling
    r, u = tile_cost(steps, np.argsort(per_ray, kind="stable"))
    rows.append(("perfect cost sort", r, u, r0 / r))
    # cheap proxies an implementation could compute host-side from entries
    X, Y, A, B_ = ray_entries(problem)
    for pname, key in [("sort |x|", np.abs(X)), ("sort x", X),
                       ("sort (x,y) lexic", None), ("sort |y|", np.abs(Y)),
                       ("sort |a|+|b|", np.abs(A) + np.abs(B_))]:
        if key is None:
            order = np.lexsort((Y, X))
        else:
            order = np.argsort(key, kind="stable")
        r, u = tile_cost(steps, order)
        rows.append((pname, r, u, r0 / r))
    # (y-cell, cost) sort: the kernel's fetch rowid is the y-cell index
    # (single-slab grids), so grouping by entry y-row preserves fetch
    # coherence perfectly while the within-row cost sort cuts divergence
    g1 = problem.gain[1]
    y1 = np.asarray(g1.y, np.float64)
    y_eff = np.abs(Y) if y1[0] >= 0 else Y
    k2 = np.clip(np.ceil((y_eff - y1[0]) / np.diff(y1).mean()).astype(int) - 1,
                 0, g1.Ny - 2)
    r, u = tile_cost(steps, np.lexsort((per_ray, k2)))
    rows.append(("sort (k2,cost)", r, u, r0 / r))
    # block-local cost sort: argsort per window of W tiles -- keeps rays
    # within W*TILE of their natural position, so tile spatial coherence
    # (the fetch loop's rowid span) survives while divergence still drops
    for W in (8, 64):
        win = W * TILE
        order = np.arange(len(per_ray))
        for lo in range(0, len(per_ray), win):
            hi = min(lo + win, len(per_ray))
            order[lo:hi] = lo + np.argsort(per_ray[lo:hi], kind="stable")
        r, u = tile_cost(steps, order)
        rows.append((f"local sort W={W}", r, u, r0 / r))
    # random shuffle (the measured-bad case, sanity anchor)
    rng = np.random.default_rng(7)
    r, u = tile_cost(steps, rng.permutation(len(per_ray)))
    rows.append(("random shuffle", r, u, r0 / r))
    print(f"{'order':>20s} {'tile-rounds':>12s} {'util':>6s} {'speedup':>8s}")
    for pname, r, u, sp in rows:
        print(f"{pname:>20s} {r:>12d} {u:>6.1%} {sp:>8.2f}x")
    return steps


def census_rec(problem, method, chunk):
    """Per-lane, per-segment, per-l0-round micro-step records (encoded
    steps+1 when the lane participated; see fast_stepper.DEBUG_RECORD).
    Yields (lo, hi, rec[B, nseg, RMAX]) per chunk to keep memory bounded."""
    beam = problem.euv_beam
    use_emis = method == 1
    ft = fs.pack_fast_tables(problem.gain, use_emis)
    X, Y, A, B_ = ray_entries(problem)
    n = len(X)
    fs.DEBUG_COUNTERS = True
    fs.DEBUG_RECORD = True
    try:
        fn = None
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            pad = chunk - (hi - lo)
            rays = {
                "x": jnp.asarray(np.pad(X[lo:hi].astype(np.float32), (0, pad))),
                "y": jnp.asarray(np.pad(Y[lo:hi].astype(np.float32), (0, pad))),
                "a": jnp.asarray(np.pad(A[lo:hi].astype(np.float32), (0, pad))),
                "b": jnp.asarray(np.pad(B_[lo:hi].astype(np.float32), (0, pad))),
            }
            if fn is None:
                def fn(rays):
                    _, ctr = fs.trace_batch_fast(
                        rays, problem.N, float(beam.dz), ft, method,
                        use_emis=use_emis)
                    return jnp.stack(ctr["rec"], axis=1)
                fn = jax.jit(fn)
            # NOTE: lanes >= hi-lo are zero-PADDED COORDINATES, not zero
            # records -- a (0,0,0,0) ray traces the whole grid; consumers
            # must drop rows beyond hi-lo (cellsync_analyze zeroes them)
            yield lo, hi, np.asarray(fn(rays))
    finally:
        fs.DEBUG_COUNTERS = False
        fs.DEBUG_RECORD = False


def cellsync_analyze(name, problem, method, chunk=65536,
                     unrolls=(1, 2, 3, 6)):
    """Compare three kernel round structures on the true step records:

    * CURRENT: per l0 round (one cell walk per lane), the inner while syncs
      the whole tile -- rounds = sum over l0 rounds of ceil(tile-max/U).
    * MERGED (per segment): one loop; each round = masked fetch phase for
      lanes needing a cell + U micro-steps on the lane's own cell. A lane's
      busy rounds = sum over its cells of ceil(steps/U) (0-step fetch-only
      rounds count 1); tile rounds = max over lanes (lanes independent).
    * MERGED-X (cross segment): lanes also roll into their next segment
      without waiting for the tile -- busy rounds sum across segments
      before the tile max.

    Reported per unroll U: micro-step SLOTS (rounds*U, the vector-ALU time
    proxy) and ROUNDS (the per-round overhead proxy: while-cond + carry
    yield + fetch phase). The fetch-phase count for CURRENT is the number
    of l0 rounds with any participating lane (one fetch loop each).
    """
    t0 = time.time()
    tot_steps = 0
    cur_slots = {u: 0 for u in unrolls}
    cur_rounds = {u: 0 for u in unrolls}
    cur_fetch = 0
    mrg_rounds = {u: 0 for u in unrolls}
    mrgx_rounds = {u: 0 for u in unrolls}
    for lo, hi, rec in census_rec(problem, method, chunk):
        # drop the chunk's padded lanes: their (0,0,0,0) entry coords are
        # traceable rays that walk the whole grid and would inflate the
        # tile maxima (the real kernel's padded lanes clamp to ray 0 and
        # are masked at deposit; zeroing matches census()'s convention)
        rec = rec.copy()
        rec[hi - lo:] = 0
        B, nseg, R = rec.shape
        part = rec > 0
        steps = np.maximum(rec - 1, 0)
        tot_steps += int(steps.sum())
        t = steps.reshape(-1, TILE, nseg, R)         # [tiles, lane, seg, r]
        tp = part.reshape(-1, TILE, nseg, R)
        mx = t.max(axis=1)                           # [tiles, seg, r]
        anyp = tp.any(axis=1)                        # [tiles, seg, r]
        cur_fetch += int(anyp.sum())
        for u in unrolls:
            r_u = -(-mx // u)                        # ceil(max/u) inner rounds
            cur_rounds[u] += int(r_u.sum())
            cur_slots[u] += int(r_u.sum()) * u
            # merged: per-lane busy rounds per (seg): ceil(steps/u), 0-step
            # participated rounds cost 1 fetch-only round
            busy = -(-t // u) + (tp & (t == 0))      # [tiles, lane, seg, r]
            busy_seg = busy.sum(axis=3)              # [tiles, lane, seg]
            mrg_rounds[u] += int(busy_seg.max(axis=1).sum())
            mrgx_rounds[u] += int(busy_seg.sum(axis=2).max(axis=1).sum())
    print(f"\n=== cellsync {name}: true steps {tot_steps}, "
          f"{time.time()-t0:.0f}s ===")
    print(f"CURRENT fetch phases (l0 rounds with work): {cur_fetch}")
    hdr = (f"{'U':>3s} {'cur slots':>12s} {'cur rounds':>11s} "
           f"{'mrg slots':>12s} {'mrg rounds':>11s} {'mrgx slots':>12s} "
           f"{'slot speedup':>13s} {'x-speedup':>10s}")
    print(hdr)
    for u in unrolls:
        ms = mrg_rounds[u] * u
        mxs = mrgx_rounds[u] * u
        print(f"{u:>3d} {cur_slots[u]:>12d} {cur_rounds[u]:>11d} "
              f"{ms:>12d} {mrg_rounds[u]:>11d} {mxs:>12d} "
              f"{cur_slots[u]/ms:>12.2f}x {cur_slots[u]/mxs:>9.2f}x")
    print(f"(util at U=1: current {tot_steps/max(cur_slots[1],1):.1%}, "
          f"merged {tot_steps/max(mrg_rounds[1],1):.1%}, "
          f"merged-x {tot_steps/max(mrgx_rounds[1],1):.1%})")


def main():
    args = set(sys.argv[1:])
    save = "--save" in args
    cellsync = "--cellsync" in args
    which = (args - {"--save", "--cellsync"}) or {"ase"}
    if cellsync:
        if "ase" in which:
            p, _, _ = load_input(ASE)
            cellsync_analyze("ASE_small (backward)", p, 1, chunk=57344)
        if "seed" in which:
            p, _, _ = load_input(SEED)
            cellsync_analyze("seed_small (forward)", p, 2)
        if "scale16" in which:
            p, _, _ = load_input(ASE)
            scale_problem(p, 16.0)
            cellsync_analyze("ASE scale16", p, 1)
        return

    def _save(tag, steps):
        if save:
            np.savez_compressed(f"/tmp/steps_{tag}.npz", steps=steps)
            print(f"saved /tmp/steps_{tag}.npz")

    if "ase" in which:
        p, _, _ = load_input(ASE)
        _save("ase", analyze("ASE_small (backward)", p, 1, chunk=57344))
    if "seed" in which:
        p, _, _ = load_input(SEED)
        _save("seed", analyze("seed_small (forward)", p, 2))
    if "scale16" in which:
        p, _, _ = load_input(ASE)
        scale_problem(p, 16.0)
        _save("scale16", analyze("ASE scale16", p, 1))


if __name__ == "__main__":
    main()
