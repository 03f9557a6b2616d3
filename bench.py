#!/usr/bin/env python
"""Benchmark driver: prints ONE JSON line with the headline metric.

Runs on a GPU only: without one it prints an error and exits non-zero (no
CPU fallback). Its inputs are the shipped snapshots ``ASE_small.dat`` and
``seed_small.dat``, which are not in the repository; until the benchmark
cells are redefined on generated inputs, ``chip_smoke.py`` is the on-card
check (README).

Metric: ASE_small rays/second per card (399,000 rays per create_image call,
reference protocol: warmup + timed calls including host->device table
upload, src/CreateImage.cpp:118-190). ``vs_baseline`` is the speedup over
the reference CPU binary (1.793 s/call = 222,532 rays/s, serial; see
BASELINE.md).

Also reported:

* ``avg_seconds_per_call`` + ``stability_ok``: the reference's own headline
  statistic and reproducibility gates (stddev <= 10% of avg, max <= avg+15%,
  src/CreateImage.cpp:166-181), evaluated over the timed calls. The
  booleans are recorded as they fall, and the artifact is
  SELF-ATTRIBUTING: every row carries its
  per-call raw seconds plus a host-prep/dispatch/wait (or, for the seeded
  rows, host-prep/upload/wait) stage split per call, and the link probes
  (``rtt_probe_s``, per-row upload/readback probes) bound the link's share,
  so an outlier can be attributed to the link vs compute from the JSON
  alone.
* ``provenance``: git commit, device, chunk policy, JAX version -- runs are
  comparable from the artifacts alone.
* ``ase_stream_*``: serving-mode throughput via ``create_image_stream``
  (calls in flight: upload/compute/readback overlapped across calls,
  distinct tables per call). Separate from the headline because the
  reference protocol times synchronous calls.
* ``seed_small_*``: the seeded workload (7.8M rays).
* ``scale16_*``: the ASE_medium proxy (-scale=16 => 6.384M rays,
  Readme.txt:47-49 protocol via scale_problem). The embedded golden only
  applies at scale 1, so correctness at scale!=1 is a cross-backend gate:
  the lax backend's image is the golden and the timed pallas image must
  pass the same one-sided 5e-6 norm check (check_ans).
* ``seed_scale4_*``: the seed_medium proxy (seed_small at -scale=4,
  ~30.7M rays; Readme.txt:47-49), same cross-backend gate + stability
  booleans as scale16.
* ``hbm_*``: device memory telemetry (bytes_in_use / peak) after each
  workload, plus a -scale=64 probe (25.5M rays): the chunked-scan design
  claims a scale-flat device footprint (Readme.txt:46-49 problem sizing),
  and the peak after scale64 vs scale16 quantifies it on real hardware
  (the compile-time flatness assertion lives in
  tests/test_create_image.py::test_chunked_scan_memory_flat). When the
  platform exposes no memory_stats the key is still present with an
  explicit ``{"unavailable": <reason>}`` record -- telemetry absence is
  loud, never silent.

ARTIFACT SCHEMA (which stages are disjoint -- needed to reconstruct
per-call accounting from the JSON alone):

* sync rows (``*_calls``): ``total_s = prep_s + dispatch_s + wait_s``
  (+ ``upload_s`` on split_upload rows), measured at four consecutive
  perf_counter marks, so the stages are DISJOINT wall intervals by
  construction. ``prep_s`` = host-side table packing (numpy only).
  Default rows: ``dispatch_s`` = async pipeline dispatch incl. the upload
  ENQUEUE; ``wait_s`` = block-until-ready, i.e. upload + device compute +
  image readback TOGETHER (they pipeline and cannot be separated from the
  host clock; use the adjacent ``rtt_probe_s`` /
  ``readback_probe_s`` link probes to bound the link share).
  split_upload rows (seeded): the operands are device_put + blocked
  before the dispatch, so ``upload_s`` = pure host->device link,
  ``dispatch_s`` = dispatch enqueue, ``wait_s`` = compute + readback.
* stream rows (``*_stream_rounds``): per round, ``fill_s`` = first-call
  completion latency (pipeline fill: nothing to overlap), ``yield_s`` =
  inter-completion spacing of the remaining calls (steady-state
  throughput, the stream analogue of per-call seconds);
  ``round_wall_s = fill_s + sum(yield_s)``. The ``*_stream_steady_*``
  stats and stability gates are over the pooled ``yield_s`` samples;
  ``*_stream_best/median_seconds_per_call`` keep the historical
  round_wall/n_units semantics for cross-round comparability.
* stability gates: stddev <= 10% of avg AND max <= avg+15%
  (CreateImage.cpp:174-181), applied to sync per-call totals and to
  stream steady-state yields alike.

The FULL artifact is also written to ``bench_artifact_full.json`` next to
this file, and the LAST stdout line is a compact driver-parsable summary
(headline keys only) -- a tail-capturing driver always gets valid JSON.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from raytrace_tpu.testing import (ASE_SNAPSHOT as REFERENCE_INPUT,  # noqa: E402
                                  SEED_SNAPSHOT as SEED_INPUT)

BASELINE_RAYS_PER_SEC = 399000 / 1.793   # reference CPU binary (BASELINE.md)
SEED_BASELINE_RAYS_PER_SEC = 7803000 / 25.261


def _git_commit():
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            timeout=10).stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def _hbm(jax):
    """Device memory telemetry. ALWAYS returns a dict: either the stats or
    an explicit ``{"unavailable": <reason>}`` -- telemetry absence is loud,
    never silent."""
    try:
        dev = jax.local_devices()[0]
        ms = dev.memory_stats()
        if not ms:
            reason = (f"{dev.platform} runtime returned "
                      f"{'None' if ms is None else 'empty'} memory_stats()")
        else:
            out = {}
            for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
                if k in ms:
                    out[k] = int(ms[k])
            if out:
                return out
            reason = ("memory_stats() present but carries none of "
                      "bytes_in_use/peak_bytes_in_use/bytes_limit "
                      f"(keys: {sorted(ms)[:8]})")
    except Exception as e:
        reason = f"memory_stats() raised {type(e).__name__}: {e}"
    # fallback: account the live device arrays this process holds -- not a
    # runtime peak, but it still bounds steady-state residency
    try:
        live = sum(int(a.nbytes) for a in jax.live_arrays()
                   if getattr(a, "nbytes", None) is not None)
        return {"unavailable": reason,
                "live_arrays_bytes_fallback": live}
    except Exception:
        return {"unavailable": reason}


def _timed_calls(path, method, n, salt, scale=None, split_upload=False):
    """Time n synchronous create_image calls, each on a distinct-tables
    copy of the snapshot (the result-cache-proof protocol;
    testing.perturbed_problems). Host parse/scale happens outside the
    timed region; the per-call table pack + upload stays inside, matching
    the reference protocol (Readme.txt:43).

    Returns (totals, calls): per-call total seconds plus a per-call stage
    split for artifact self-attribution --

    * default: ``prep`` (host-side packing), ``dispatch`` (async pipeline
      dispatch incl. upload enqueue), ``wait`` (block on readback:
      upload + compute + readback);
    * ``split_upload`` (single-jit rows, e.g. seeded): the operands are
      device_put + blocked before the dispatch, so the split becomes
      ``prep`` / ``upload`` (pure host->device link) / ``wait``
      (compute + readback). Total semantics are unchanged -- the upload
      stays inside the timed region, it just cannot hide behind the
      dispatch enqueue.
    """
    import jax

    from raytrace_tpu.models.ray_tracer import (_finalize_call,
                                                prepare_pipeline)
    from raytrace_tpu.testing import perturbed_problems

    probs = perturbed_problems(path, n, salt=salt, scale=scale)
    totals, calls = [], []
    for p in probs:
        t0 = time.perf_counter()
        prep = prepare_pipeline(p, method)
        t1 = time.perf_counter()
        ops = prep.operands
        if split_upload:
            dev = jax.block_until_ready(jax.device_put(
                [o for o in ops if o is not None]))
            it = iter(dev)
            ops = tuple(next(it) if o is not None else None for o in ops)
        t2 = time.perf_counter()
        outs = prep.pipeline(*ops)
        t3 = time.perf_counter()
        _finalize_call(p, prep, outs, "Failed_RayTrace_rays.dat")
        t4 = time.perf_counter()
        totals.append(t4 - t0)
        c = {"total_s": round(t4 - t0, 4), "prep_s": round(t1 - t0, 4),
             "wait_s": round(t4 - t3, 4)}
        if split_upload:
            c["upload_s"] = round(t2 - t1, 4)
            c["dispatch_s"] = round(t3 - t2, 4)
        else:
            c["dispatch_s"] = round(t3 - t1, 4)
        calls.append(c)
    return totals, calls


def _row_stats(prefix, totals, calls, n_rays, stability_ok, TimingStats):
    stats = TimingStats.of(totals)
    best = min(totals)
    return {
        f"{prefix}rays_per_sec": round(n_rays / best, 1),
        f"{prefix}best_seconds_per_call": round(best, 4),
        f"{prefix}median_seconds_per_call": round(
            sorted(totals)[len(totals) // 2], 4),
        f"{prefix}avg_seconds_per_call": round(stats.avg, 4),
        f"{prefix}std_seconds_per_call": round(stats.std, 4),
        f"{prefix}stability_ok": bool(stability_ok(stats)),
        f"{prefix}calls": calls,
    }


def _link_probes(jax, rb_shape=None):
    """Fixed per-dispatch round trip + (optionally) a resident-array
    readback probe: the link-cost bounds that make red stability gates
    attributable from the artifact (ROADMAP.md ASE breakdown)."""
    import numpy as np

    out = {}
    try:
        tiny = jax.jit(lambda x: x + 1.0)
        np.asarray(tiny(np.float32(0.0)))
        ts = []
        for i in range(7):
            a = np.float32(i)
            t0 = time.perf_counter()
            np.asarray(tiny(a))
            ts.append(time.perf_counter() - t0)
        ts.sort()
        out["rtt_probe_s"] = round(ts[0], 4)
        out["rtt_probe_median_s"] = round(ts[len(ts) // 2], 4)
    except Exception:
        pass
    if rb_shape is not None:
        try:
            res = [jax.block_until_ready(jax.device_put(
                np.full(rb_shape, 1.0 + i, np.float64))) for i in range(5)]
            ts = []
            for b in res:
                t0 = time.perf_counter()
                np.asarray(b)
                ts.append(time.perf_counter() - t0)
            ts.sort()
            out["readback_probe_s"] = round(ts[0], 4)
            out["readback_probe_median_s"] = round(ts[len(ts) // 2], 4)
        except Exception:
            pass
    return out


def _stream_row(prefix, path, n_units, rounds, make_stream, n_rays,
                salt0, scale, jax, TimingStats, stability_ok):
    """A serving-mode row under the FULL measurement protocol: per-round fill + per-yield walls, steady-state Avg/StdDev +
    the reference stability gates over the pooled yields, and an adjacent
    link probe so a degraded round is attributable from the artifact."""
    from raytrace_tpu.testing import time_stream_detailed

    per_call, detail = time_stream_detailed(path, n_units, rounds,
                                            make_stream, salt0=salt0,
                                            scale=scale)
    yields = [y for d in detail for y in d["yield_s"]]
    row = {
        f"{prefix}rays_per_sec": round(n_rays / min(per_call), 1),
        f"{prefix}best_seconds_per_call": round(min(per_call), 4),
        f"{prefix}median_seconds_per_call": round(
            sorted(per_call)[len(per_call) // 2], 4),
        f"{prefix}rounds": detail,
    }
    if yields:
        ys = TimingStats.of(yields)
        row.update({
            f"{prefix}steady_best_s": round(min(yields), 4),
            f"{prefix}steady_median_s": round(
                sorted(yields)[len(yields) // 2], 4),
            f"{prefix}steady_avg_s": round(ys.avg, 4),
            f"{prefix}steady_std_s": round(ys.std, 4),
            f"{prefix}steady_stability_ok": bool(stability_ok(ys)),
            f"{prefix}steady_rays_per_sec": round(n_rays / min(yields), 1),
        })
    row.update({f"{prefix}{k}": v for k, v in _link_probes(jax).items()})
    return row


def main():
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(json.dumps({"error": "bench.py needs a GPU",
                          "platform": dev.platform}))
        sys.exit(2)
    print(f"device: {dev.platform} {dev.device_kind} x{len(devices)}")

    from raytrace_tpu import create_image, load_input
    from raytrace_tpu.io.loader import scale_problem
    from raytrace_tpu.utils.stats import TimingStats, check_ans, stability_ok

    method = "pallas"

    provenance = {
        "git_commit": _git_commit(),
        "jax_version": jax.__version__,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices)},
        "chunk_policy": "auto",
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }

    problem, image0, i_ang0 = load_input(REFERENCE_INPUT)
    n_rays = 399000

    # warmup (JIT compile); the golden gate runs on the pristine problem
    image, i_ang = create_image(problem, method)
    create_image(problem, method)
    ok = check_ans(image0, i_ang0, image, i_ang, verbose=False)

    # best of 9. Every call does the full protocol work -- host->device
    # table upload, compute, device->host image readback -- on a
    # distinct-tables copy; the minimum is the machine-capability number,
    # avg/median and the reference stability gates alongside.
    n_reps = 9
    times, ase_calls = _timed_calls(REFERENCE_INPUT, method, n_reps, salt=17)
    stats = TimingStats.of(times)
    best = min(times)
    median = sorted(times)[len(times) // 2]
    rays_per_sec = n_rays / best
    hbm_ase = _hbm(jax)
    probes = _link_probes(jax, rb_shape=(1500, 52))

    # serving-mode throughput: create_image_stream keeps calls in flight,
    # overlapping call k+1's table upload with call k's compute and call
    # k's readback with call k+1's compute. Measured separately from the
    # headline (the reference protocol times synchronous calls). Every
    # streamed call gets distinct gain tables so no result cache can serve
    # a measurement (and matching the production "tables change every
    # iteration" semantics, Readme.txt:43).
    stream_stats = {}
    try:
        from raytrace_tpu import create_image_stream
        from raytrace_tpu.testing import perturbed_problems

        for _ in create_image_stream(
                perturbed_problems(REFERENCE_INPUT, 2, salt=99), method):
            pass  # warmup
        # depth=4 for short ASE-class calls: more calls in flight hide
        # per-dispatch host cost; whether it pays on the GPU is not
        # measured yet
        stream_stats = _stream_row(
            "ase_stream_", REFERENCE_INPUT, 6, 3,
            lambda probs: create_image_stream(probs, method, depth=4),
            n_rays, 0, None, jax, TimingStats, stability_ok)
    except Exception as e:  # never let the extra metric kill the headline
        stream_stats = {"ase_stream_error": repr(e)}

    # auxiliary: the seeded workload (7.8M rays). Full reference protocol
    # like ASE: 9 timed calls, Avg/StdDev + the stability gates
    # (src/CreateImage.cpp:166-183). split_upload: the per-call stage split
    # separates the host->device upload from compute+readback, so a red
    # stability gate is attributable.
    seed_stats = {}
    if os.path.exists(SEED_INPUT):
        sp, simg0, sang0 = load_input(SEED_INPUT)
        simg, sang = create_image(sp, method)  # warmup + golden source
        st, seed_calls = _timed_calls(SEED_INPUT, method, 9, salt=23,
                                      split_upload=True)
        seed_stats = _row_stats("seed_small_", st, seed_calls, 7803000,
                                stability_ok, TimingStats)
        seed_stats["seed_small_vs_baseline"] = round(
            (7803000 / min(st)) / SEED_BASELINE_RAYS_PER_SEC, 3)
        seed_stats["seed_small_golden_check"] = bool(
            check_ans(simg0, sang0, simg, sang, verbose=False))
        # serving-mode throughput, seeded (same protocol as ase_stream_*)
        try:
            from raytrace_tpu import create_image_stream

            seed_stats.update(_stream_row(
                "seed_stream_", SEED_INPUT, 3, 2,
                lambda probs: create_image_stream(probs, method),
                7803000, 0, None, jax, TimingStats, stability_ok))
        except Exception as e:
            seed_stats["seed_stream_error"] = repr(e)
        seed_stats["hbm_after_seed"] = _hbm(jax)

    # ASE_medium proxy: -scale=16 (6.384M rays). Golden at scale!=1 is a
    # cross-backend check: lax result is the golden for the pallas image.
    scale16_stats = {}
    try:
        p16, _, _ = load_input(REFERENCE_INPUT)
        scale_problem(p16, 16.0)
        b16 = p16.euv_beam
        n16 = b16.nx * b16.ny * b16.na * b16.nb
        img16, ang16 = create_image(p16, method)  # warmup + sanity source
        t16, s16_calls = _timed_calls(REFERENCE_INPUT, method, 9, salt=31,
                                      scale=16.0)
        sanity = True
        if method != "lax":
            pl16, _, _ = load_input(REFERENCE_INPUT)
            scale_problem(pl16, 16.0)
            limg, lang = create_image(pl16, "lax")
            sanity = check_ans(limg, lang, img16, ang16, verbose=False)
        scale16_stats = _row_stats("scale16_", t16, s16_calls, n16,
                                   stability_ok, TimingStats)
        scale16_stats["scale16_n_rays"] = int(n16)
        scale16_stats["scale16_cross_backend_check"] = bool(sanity)
        scale16_stats["hbm_after_scale16"] = _hbm(jax)
        # serving-mode throughput at ASE_medium scale (same distinct-tables
        # protocol as the other stream rows), natural ray order
        try:
            from raytrace_tpu import create_image_stream

            scale16_stats.update(_stream_row(
                "scale16_stream_", REFERENCE_INPUT, 4, 2,
                lambda probs: create_image_stream(probs, method),
                n16, 0, 16.0, jax, TimingStats, stability_ok))
        except Exception as e:
            scale16_stats["scale16_stream_error"] = repr(e)
    except Exception as e:  # never let the proxy kill the headline number
        scale16_stats = {"scale16_error": repr(e)}

    # seed_medium proxy: seed_small at -scale=4 (~30.7M rays,
    # Readme.txt:47-49). Same cross-backend golden gate as scale16 and the
    # same stability booleans; 5 timed calls (each ~3 s) keep the row
    # bounded. The CPU-mesh sharded coverage of this scale lives in
    # tests/test_multichip.py::test_seed_scaled_sharded_matches_single.
    seed4_stats = {}
    try:
        if not os.path.exists(SEED_INPUT):
            raise FileNotFoundError(SEED_INPUT)
        p4, _, _ = load_input(SEED_INPUT)
        scale_problem(p4, 4.0)
        sb4 = p4.seed_beam
        n4 = sb4.nx * sb4.ny * sb4.na * sb4.nb
        img4, ang4 = create_image(p4, method)  # warmup + sanity source
        t4, s4_calls = _timed_calls(SEED_INPUT, method, 5, salt=41,
                                    scale=4.0, split_upload=True)
        sanity4 = True
        if method != "lax":
            pl4, _, _ = load_input(SEED_INPUT)
            scale_problem(pl4, 4.0)
            limg4, lang4 = create_image(pl4, "lax")
            sanity4 = check_ans(limg4, lang4, img4, ang4, verbose=False)
        seed4_stats = _row_stats("seed_scale4_", t4, s4_calls, n4,
                                 stability_ok, TimingStats)
        seed4_stats["seed_scale4_n_rays"] = int(n4)
        seed4_stats["seed_scale4_cross_backend_check"] = bool(sanity4)
    except Exception as e:
        seed4_stats = {"seed_scale4_error": repr(e)}

    # scale-64 envelope probe (25.5M rays): two timed calls + the HBM peak.
    # The chunked scan's footprint is set by the chunk, not the ray count,
    # so peak HBM here vs after scale16 quantifies the scale-flat claim
    # (Readme.txt:46-49) on real hardware.
    scale64_stats = {}
    try:
        t64, s64_calls = _timed_calls(REFERENCE_INPUT, method, 2, salt=53,
                                      scale=64.0)
        p64, _, _ = load_input(REFERENCE_INPUT)
        scale_problem(p64, 64.0)
        b64 = p64.euv_beam
        scale64_stats = {
            "scale64_n_rays": int(b64.nx * b64.ny * b64.na * b64.nb),
            "scale64_best_seconds_per_call": round(min(t64), 4),
            "scale64_calls": s64_calls,
        }
        scale64_stats["hbm_after_scale64"] = _hbm(jax)
    except Exception as e:
        scale64_stats = {"scale64_error": repr(e)}

    result = {
        "metric": "ase_small_rays_per_sec",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / BASELINE_RAYS_PER_SEC, 3),
        "best_seconds_per_call": round(best, 4),
        "median_seconds_per_call": round(median, 4),
        "avg_seconds_per_call": round(stats.avg, 4),
        "std_seconds_per_call": round(stats.std, 4),
        "stability_ok": bool(stability_ok(stats)),
        "golden_check": bool(ok),
        "method": method,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(devices),
        "schema": ("sync *_calls: disjoint wall intervals, total=prep"
                   "+dispatch+wait (+upload on split rows); default rows "
                   "wait=upload+compute+readback, split rows upload=pure "
                   "link and wait=compute+readback. stream *_rounds: "
                   "fill=first-call latency, yield_s=steady inter-"
                   "completion spacing, round_wall=fill+sum(yield_s); "
                   "steady stats+gates pool yield_s. Gates: std<=10%avg "
                   "and max<=avg+15% (CreateImage.cpp:174-181). Full "
                   "details in bench.py docstring."),
        "provenance": provenance,
        "ase_calls": ase_calls,
        "hbm_after_ase": hbm_ase,
        **probes,
        **stream_stats,
        **seed_stats,
        **scale16_stats,
        **seed4_stats,
        **scale64_stats,
    }
    # full artifact: one JSON line on stdout (human/driver logs) AND a file
    # on disk -- r04's artifact survived only as a truncated tail string
    full = json.dumps(result)
    print(full)
    try:
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "bench_artifact_full.json"), "w") as f:
            f.write(full + "\n")
    except Exception:
        pass  # read-only checkout: stdout still carries everything
    # LAST line: compact driver-parsable summary (headline keys only) so a
    # tail-capturing driver always parses valid JSON
    summary = {
        "metric": result["metric"], "value": result["value"],
        "unit": result["unit"], "vs_baseline": result["vs_baseline"],
        "best_seconds_per_call": result["best_seconds_per_call"],
        "stability_ok": result["stability_ok"],
        "golden_check": result["golden_check"],
        "method": method, "platform": result["platform"],
        "device_kind": dev.device_kind, "device_count": len(devices),
        "git_commit": provenance["git_commit"][:12],
    }
    for k in ("ase_stream_steady_best_s", "ase_stream_steady_stability_ok",
              "seed_small_best_seconds_per_call", "seed_small_stability_ok",
              "seed_small_golden_check", "seed_stream_steady_best_s",
              "scale16_best_seconds_per_call", "scale16_stability_ok",
              "scale16_cross_backend_check", "scale16_stream_steady_best_s",
              "seed_scale4_best_seconds_per_call",
              "seed_scale4_cross_backend_check",
              "scale64_best_seconds_per_call"):
        for src in (stream_stats, seed_stats, scale16_stats, seed4_stats,
                    scale64_stats):
            if k in src:
                summary[k] = src[k]
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
