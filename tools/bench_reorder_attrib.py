#!/usr/bin/env python
"""Attribute the cost-feedback reorder's end-to-end cost.

A trace-only reorder gain (tools/bench_reorder.py) need not show end to
end. This tool splits the reorder pipeline's
cost into:

* ``plain``          -- the natural-order production pipeline (baseline)
* ``reorder_zero``   -- the reorder pipeline fed all-zero counts (natural
                        order, but pays the counts-variant kernel + the
                        identity argsort + counts scatter): the pure
                        MACHINERY OVERHEAD
* ``reorder_fb``     -- the reorder pipeline fed real previous-call counts
                        (the production steady state): overhead + win
* ``argsort_only``   -- just the per-chunk (row, cost) argsort stage

Protocol: scan-over-distinct-inputs differencing (see ROADMAP.md); the
counts operand stays resident and is perturbed per scan step ON DEVICE
(pc + step: order-preserving, same sort work, no 25 MB/step upload) and a
per-rep scalar input keeps every call distinct.

Usage: python tools/bench_reorder_attrib.py [input.dat] [scale] [S]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace_tpu.testing import ASE_SNAPSHOT  # noqa: E402

INPUT = sys.argv[1] if len(sys.argv) > 1 else ASE_SNAPSHOT
SCALE = float(sys.argv[2]) if len(sys.argv) > 2 else 16.0
S = int(sys.argv[3]) if len(sys.argv) > 3 else 4
assert S >= 2, "scan-differencing needs S >= 2 (per-call = (tS - t1)/(S-1))"


def main():
    import jax
    import jax.numpy as jnp

    from raytrace_tpu import load_input
    from raytrace_tpu.io.loader import scale_problem
    from raytrace_tpu.models import ray_tracer as rt

    problem, _, _ = load_input(INPUT)
    if SCALE != 1.0:
        scale_problem(problem, SCALE)

    os.environ["RAYTRACE_NO_SPLIT"] = "1"  # same pipeline shape for both
    prep_p = rt.prepare_pipeline(problem, "pallas")
    prep_r = rt.prepare_pipeline(problem, "pallas", reorder=True)
    assert prep_r.cfg["reorder"], "reorder pipeline did not build"
    cfg = prep_r.cfg
    n_chunks, chunk = cfg["n_chunks"], cfg["chunk"]
    pack, tt, gv, seed_dev, beam_dev = prep_r.operands
    pack_h, tt_h, gv_h = (np.asarray(pack), np.asarray(tt), np.asarray(gv))

    # real previous-call counts (the production feedback signal)
    pc0 = jnp.zeros((n_chunks, chunk), jnp.int32)
    outs = prep_r.pipeline(pack, tt, gv, seed_dev, beam_dev, pc0)
    counts = jax.block_until_ready(outs[4])

    def stack_t(S_, r):
        f = 1.0 + 1e-6 * r
        return np.stack([tt_h * np.float32(f + 1e-6 * s) for s in range(S_)])

    def stack_g(S_, r):
        f = 1.0 + 1e-6 * r
        return np.stack([gv_h * np.float32(f + 1e-6 * s) for s in range(S_)])

    def measure_interleaved(makers: dict, n_rounds=6):
        """Round-interleaved paired measurement: every round times every
        arm's S-step and 1-step scanners back-to-back, so contention and
        clock drift hit all arms alike; per-arm per-round estimates are compared within
        rounds. Sequential per-arm runs measured a physically impossible
        ordering (the counts-variant arm 17% FASTER than the plain kernel)
        purely from inter-arm drift -- do not trust unpaired arms."""
        runners = {}
        for name, mk in makers.items():
            rs, r1 = mk(S), mk(1)
            float(rs(*mk_args(S, 0)))   # compile
            float(r1(*mk_args(1, 0)))
            runners[name] = (rs, r1)
        rounds = {name: [] for name in makers}
        for r in range(n_rounds):
            for name, (rs, r1) in runners.items():
                a = mk_args(S, 100 * r + 1)
                t0 = time.perf_counter()
                float(rs(*a))
                ts = time.perf_counter() - t0
                a1 = mk_args(1, 100 * r + 2)
                t0 = time.perf_counter()
                float(r1(*a1))
                t1 = time.perf_counter() - t0
                rounds[name].append((ts - t1) / (S - 1))
        out = {}
        for name, vals in rounds.items():
            v = sorted(vals)
            out[name] = {"best": v[0], "median": v[len(v) // 2],
                         "rounds": [round(x, 4) for x in vals]}
            print(f"  {name}: best {v[0]*1e3:.1f} med "
                  f"{v[len(v)//2]*1e3:.1f} ms/call  {out[name]['rounds']}",
                  file=sys.stderr)
        return out

    def mk_args(S_, r):
        return (pack_h, stack_t(S_, r), stack_g(S_, r))

    def make_plain(S_):
        def scanner(pack_in, tts, gvs):
            def body(acc, xs):
                t, g = xs
                img, ang, _f, _c = prep_p.pipeline(pack_in, t, g,
                                                   seed_dev, beam_dev)
                return acc + img.sum() + ang.sum(), None
            out, _ = jax.lax.scan(body, jnp.float64(0.0), (tts, gvs))
            return out
        return jax.jit(scanner)

    def make_reorder(pc):
        def make(S_):
            def scanner(pack_in, tts, gvs):
                def body(acc, xs):
                    t, g, s = xs
                    # order-preserving per-step perturbation, on device
                    # (multiplicative: zeros STAY zero so the zero-counts
                    # arm keeps the natural-order gate engaged)
                    img, ang, _f, _c, cnt, _it = prep_r.pipeline(
                        pack_in, t, g, seed_dev, beam_dev,
                        pc * (s + jnp.int32(1)))
                    return acc + img.sum() + ang.sum() \
                        + cnt.sum().astype(jnp.float64) * 0.0, None
                out, _ = jax.lax.scan(
                    body, jnp.float64(0.0),
                    (tts, gvs, jnp.arange(S_, dtype=jnp.int32)))
                return out
            return jax.jit(scanner)
        return make

    def make_argsort(pc):
        chunk_indices = rt._make_chunk_indices(cfg)

        def make(S_):
            def scanner(pack_in, tts, gvs):
                ray_grids_u, _b, _d = rt.unpack_bundle(cfg, pack_in)

                def body(acc, xs):
                    _t, _g, s = xs

                    def cbody(a2, ci):
                        ijkm, _v, _it = chunk_indices(ci)
                        perm = rt.reorder_perm(cfg, pc[ci] * (s + 1), ijkm,
                                               ray_grids_u)
                        return a2 + perm.sum().astype(jnp.float64), None
                    a3, _ = jax.lax.scan(
                        cbody, acc, jnp.arange(n_chunks, dtype=jnp.int32))
                    return a3, None
                out, _ = jax.lax.scan(
                    body, jnp.float64(0.0),
                    (tts, gvs, jnp.arange(S_, dtype=jnp.int32)))
                return out
            return jax.jit(scanner)
        return make

    # ---- bisection variants: hand-rolled plain pipelines that differ
    # only in (a) nothing (harness-structure control), (b) the counting
    # kernel -- to locate the measured plain-vs-reorder_zero gap ----
    cfg_p = prep_p.cfg

    def make_plain_variant(counting):
        chunk_idx = rt._make_chunk_indices(cfg_p)
        tf = rt.make_pallas_trace_fn(cfg_p, counts=counting)

        def make(S_):
            def scanner(pack_in, tts, gvs):
                ray_grids_u, beam_u, dseed_u = rt.unpack_bundle(cfg_p,
                                                                pack_in)

                def body(carry, xs):
                    t, g = xs
                    img0 = jnp.zeros((cfg_p["img_rows"], cfg_p["K"]),
                                     jnp.float64)
                    ang0 = jnp.zeros((cfg_p["na_nb"],), jnp.float64)

                    def cbody(c2, ci):
                        ia, aa = c2
                        ijkm, valid, _it = chunk_idx(ci)
                        rays, _ = rt._chunk_rays(cfg_p, ijkm, ray_grids_u)
                        out = tf(rays, t)
                        res, cnt = out if counting else (out, None)
                        img_p, ang_p, code = rt.chunk_post(
                            cfg_p, ijkm, valid, ray_grids_u, res, g,
                            dseed_u, beam_u)
                        ys = (code, cnt) if counting else (code,)
                        return (ia + img_p, aa + ang_p), ys
                    (img, ang), _ys = jax.lax.scan(
                        cbody, (img0, ang0),
                        jnp.arange(cfg_p["n_chunks"], dtype=jnp.int32))
                    return carry + img.sum() + ang.sum(), None
                out, _ = jax.lax.scan(body, jnp.float64(0.0), (tts, gvs))
                return out
            return jax.jit(scanner)
        return make

    # cumulative-feature bisect between plain_counts and reorder_zero:
    # c1 = ijkm via an i32 iota perm gather; c2 = perm from reorder_perm on
    # zero costs (the real argsort, identity result); c3 = c2 + the counts
    # scatter-to-natural + the it ys output (== reorder_zero, hand-rolled)
    def make_bisect(level):
        chunk_idx = rt._make_chunk_indices(cfg_p)
        tf = rt.make_pallas_trace_fn(cfg_p, counts=True)

        def make(S_):
            def scanner(pack_in, tts, gvs):
                ray_grids_u, beam_u, dseed_u = rt.unpack_bundle(cfg_p,
                                                                pack_in)

                def body(carry, xs):
                    t, g = xs
                    img0 = jnp.zeros((cfg_p["img_rows"], cfg_p["K"]),
                                     jnp.float64)
                    ang0 = jnp.zeros((cfg_p["na_nb"],), jnp.float64)

                    def cbody(c2, ci):
                        ia, aa = c2
                        if level >= 2:
                            ijkm_nat, _vn, _itn = chunk_idx(ci)
                            perm = rt.reorder_perm(
                                cfg_p, jnp.zeros((cfg_p["chunk"],),
                                                 jnp.int32),
                                ijkm_nat, ray_grids_u)
                        else:
                            perm = jnp.arange(cfg_p["chunk"],
                                              dtype=jnp.int32)
                        ijkm, valid, it = chunk_idx(ci, perm)
                        rays, _ = rt._chunk_rays(cfg_p, ijkm, ray_grids_u)
                        res, cnt = tf(rays, t)
                        img_p, ang_p, code = rt.chunk_post(
                            cfg_p, ijkm, valid, ray_grids_u, res, g,
                            dseed_u, beam_u)
                        if level >= 3:
                            cnt_nat = jnp.zeros((perm.shape[0],),
                                                jnp.int32).at[perm].set(cnt)
                            ys = (code, cnt_nat, it.astype(jnp.int32))
                        else:
                            ys = (code, cnt)
                        return (ia + img_p, aa + ang_p), ys
                    (img, ang), _ys = jax.lax.scan(
                        cbody, (img0, ang0),
                        jnp.arange(cfg_p["n_chunks"], dtype=jnp.int32))
                    return carry + img.sum() + ang.sum(), None
                out, _ = jax.lax.scan(body, jnp.float64(0.0), (tts, gvs))
                return out
            return jax.jit(scanner)
        return make

    res = measure_interleaved({
        "plain": make_plain,
        "plain_counts": make_plain_variant(True),
        "c1_permgather": make_bisect(1),
        "c2_argsort": make_bisect(2),
        "c3_scatter_it": make_bisect(3),
        "argsort_only": make_argsort(counts),
        "reorder_zero": make_reorder(pc0),
        "reorder_fb": make_reorder(counts),
    })

    med = {k: v["median"] for k, v in res.items()}
    print(json.dumps({
        "input": os.path.basename(INPUT), "scale": SCALE,
        "n_chunks": int(n_chunks), "chunk": int(chunk),
        **{f"{k}_s": round(v["median"], 4) for k, v in res.items()},
        **{f"{k}_best_s": round(v["best"], 4) for k, v in res.items()},
        "rounds": {k: v["rounds"] for k, v in res.items()},
        "machinery_overhead_s": round(med["reorder_zero"] - med["plain"], 4),
        "net_win_s": round(med["plain"] - med["reorder_fb"], 4),
        "sort_win_given_machinery_s": round(
            med["reorder_zero"] - med["reorder_fb"], 4),
    }, indent=1))


if __name__ == "__main__":
    main()
