#!/usr/bin/env python
"""A/B: trace-kernel cost under different ray orders.

tools/steps_analysis.py models the pallas kernel's per-block cost as
sum-over-segments of the block's max micro-step count and predicts how much
a cost-based ray reorder could save (perfect sort ceiling, block-local
sorts that preserve the fetch's spatial coherence). This script measures
it: the SAME rays, permuted host-side, through the pallas kernel (trace
stage only -- ordering is transparent to the deposits).

Protocol: a lax.scan over S distinct per-step ray perturbations inside ONE
jit, fresh epsilons per timing rep, orders interleaved rep-by-rep so drift
cancels, best-of per order compared.

Usage: python tools/bench_reorder.py [ase|seed] [S] [reps]
Needs /tmp/steps_<tag>.npz from `tools/steps_analysis.py <tag> --save`.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.io.loader import load_input
from raytrace_tpu.ops import pallas_kernel as pk
from tools.steps_analysis import ray_entries, ASE, SEED, TILE

f32 = jnp.float32


def orders(per_ray, k2=None):
    n = len(per_ray)
    out = {"natural": np.arange(n)}
    out["perfect"] = np.argsort(per_ray, kind="stable")
    if k2 is not None:
        # fetch-coherent divergence sort: group by entry y-row (the fetch
        # rowid on single-slab grids), cost-sorted within each row
        out["k2+cost"] = np.lexsort((per_ray, k2))
    for W in (8, 64):
        win = W * TILE
        o = np.arange(n)
        for lo in range(0, n, win):
            hi = min(lo + win, n)
            o[lo:hi] = lo + np.argsort(per_ray[lo:hi], kind="stable")
        out[f"local W={W}"] = o
    out["shuffle"] = np.random.default_rng(7).permutation(n)
    return out


def ordered(arr, order):
    return arr[order].astype(np.float32)


def make_scan_trace(pg, N, dz0, method):
    """S kernel executions over per-step-perturbed rays; scalar reduce."""

    @jax.jit
    def run(rx, ry, ra, rb, eps, tables):
        pg_s = pg._replace(tables=tables)

        def body(acc, e):
            # distinct work per step AND per call (eps is a fresh input
            # each rep): perturb entry x by ~1e-5 cm and the a angle by
            # ~1e-5 mrad -- step counts effectively unchanged
            res = pk.trace_rays({"x": rx + e, "y": ry, "a": ra + e, "b": rb},
                                N, dz0, pg_s, method)
            return acc + jnp.sum(res.gvl[:, 0, 0]), None

        acc, _ = jax.lax.scan(body, f32(0.0), eps)
        return acc

    return run


def main():
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    tiles = next((int(a.split("=")[1]) for a in sys.argv[1:]
                  if a.startswith("--tiles=")), None)
    which = argv[0] if argv else "ase"
    S = int(argv[1]) if len(argv) > 1 else 4
    reps = int(argv[2]) if len(argv) > 2 else 4
    path, method = (ASE, 1) if which == "ase" else (SEED, 2)
    problem, _, _ = load_input(path)
    steps = np.load(f"/tmp/steps_{which}.npz")["steps"]
    per_ray = steps.sum(axis=1)
    X, Y, A, B_ = ray_entries(problem)
    if tiles:  # smoke-test subsample (plumbing check, not a measurement)
        n = tiles * TILE
        per_ray, X, Y, A, B_ = per_ray[:n], X[:n], Y[:n], A[:n], B_[:n]
    use_emis = method == 1
    pg = pk.pack_gain_tables(problem.gain, use_emis)
    beam = problem.euv_beam
    g1 = problem.gain[1]
    y1 = np.asarray(g1.y, np.float64)
    y_eff = np.abs(Y) if y1[0] >= 0 else Y
    k2 = np.clip(np.ceil((y_eff - y1[0]) / np.diff(y1).mean()).astype(int)
                 - 1, 0, g1.Ny - 2)
    cases = {}
    for name, order in orders(per_ray, k2).items():
        cases[name] = tuple(ordered(v, order) for v in (X, Y, A, B_))
    scan_trace = make_scan_trace(pg, problem.N, float(beam.dz), method)

    rng = np.random.default_rng(0)
    times = {k: [] for k in cases}
    for rep in range(reps + 1):  # rep 0 = compile warmup
        for name, (rx, ry, ra, rb) in cases.items():
            eps = jnp.asarray(rng.normal(0, 1e-5, S).astype(np.float32))
            args = tuple(jnp.asarray(v) for v in (rx, ry, ra, rb))
            t0 = time.perf_counter()
            scan_trace(*args, eps, pg.tables).block_until_ready()
            dt = (time.perf_counter() - t0) / S
            if rep:
                times[name].append(dt)
            print(f"rep{rep} {name:>12s} {dt*1e3:8.2f} ms/pass", flush=True)
    print("\n== bests (ms/pass of the full workload trace) ==")
    base = min(times["natural"])
    for name, ts in times.items():
        print(f"{name:>12s} best {min(ts)*1e3:8.2f}  med "
              f"{sorted(ts)[len(ts)//2]*1e3:8.2f}  speedup "
              f"{base/min(ts):.2f}x")


if __name__ == "__main__":
    main()
