#!/usr/bin/env python
"""Randomized end-to-end fuzz: synthetic problems vs the scalar oracle.

Generates random create_image work units across the capability envelope
(edge-sized axes, N in [1, N_MAX], seeded/full-plane/non-uniform/warped
grids) and checks every backend's image against a brute-force oracle
deposit. This is how the N=1 pallas crash and the nv=1 generator crash
were found (round 3); run it after touching the stepper, binning, or
backend-resolution code.

Usage:
    python tools/fuzz_oracle.py [n_random] [seed] [--sharded] [--stream] [--cpu]

Runs the curated edge cases plus ``n_random`` random configs (default 8).
With ``--sharded`` every case additionally runs through
``create_image_sharded`` on a virtual 8-device CPU mesh (the multi-chip
path the driver's dryrun exercises). With ``--stream`` every case also
goes through ``create_image_stream`` interleaved with a second in-flight
problem and must match per-call ``create_image`` bitwise. The sweep runs on
JAX's default platform; ``--cpu`` (implied by ``--sharded``) asks for the
CPU. Exit code = number of mismatches/crashes.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHARDED = "--sharded" in sys.argv
STREAM = "--stream" in sys.argv
ON_CPU = SHARDED or "--cpu" in sys.argv
if SHARDED:
    # the virtual-device flag must be in place before the backend initializes
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from raytrace_tpu import create_image  # noqa: E402
from raytrace_tpu.testing import (  # noqa: E402
    oracle_images, physical_gain, synthetic_problem)

#: image-norm tolerance vs the oracle: plain-python IEEE f32 vs XLA's
#: FMA-contracted f32 flips adaptive step-size decisions near their min()
#: thresholds (the documented trip-count jitter, ops/fast_stepper.py), and
#: the resulting truncation-level gvl differences accumulate over the
#: 3*(N-1) amplification sub-steps -- so the budget scales with path
#: length (measured: N=7 all-backends-identical case at 5.3e-3).
TOL = 5e-3


def tol_for(N: int, seeded: bool = False) -> float:
    """Oracle-gate tolerance budget.

    Seeded cases amplify the trajectory-chaos noise exponentially: the
    output is seed * exp(path-integrated gain), so exponent noise delta
    passes through at full relative size, and delta itself grows with the
    path length. Measured: a 20-ray seeded N=6 strong-gain case where all
    five backends agree to ~1e-7 sits at 1.6e-2 vs the oracle (per-ray
    exponent deltas up to 1.3e-2, no bin flips, no systematic sign -- pure
    f32 chaos). ASE cases accumulate emission additively and keep the
    linear budget. Real bugs (wrong seed/binning/scale) are order-unity
    and break the TIGHT cross-backend gates too, so the cap loses nothing.
    """
    lin = TOL * max(1.0, (N - 1) / 2.0)
    if seeded:
        return min(TOL * max(1.0, (N - 1) / 2.0) ** 2, 5e-2)
    return lin


#: pairwise cross-backend tolerance WITHIN a stepping family: lax and
#: pallas share the fast stepper's micro-step decisions (and the sharded
#: wrappers change only the deposit), so they agree to ~1e-7 even on the
#: N=7 jitter case. lax-exact follows the oracle's stepping instead, so
#: exact-vs-fast pairs carry the same trip-count-jitter budget as the
#: oracle check (measured: 1.46e-4 on a 16-ray seeded N=4 case).
TOL_XBACKEND = 1e-4


def _family(resolved: str) -> str:
    """Family of the backend that ACTUALLY ran (pass resolve_method output,
    not the requested name: an out-of-envelope 'lax' silently runs
    lax-exact and must be gated as an exact-family member)."""
    return "exact" if resolved == "lax-exact" else "fast"


def ang_close(want, have, tol):
    """Far-field acceptance: elementwise within tol, OR a conservative
    redistribution. I_ang is a coarse grid (na*nb cells), so the chaotic
    f32 stepping jitter that the image tolerance absorbs statistically can
    flip a single strong ray into an ADJACENT angular bin, moving its
    whole weight between two cells (measured: exit angles deviating by up
    to 0.09*da between plain-IEEE scalars and XLA's FMA-contracted
    stepping flipped two rays, 1.3e-1 elementwise on a 3x3 grid while the
    45-cell image stayed at 1.7e-3). Redistribution conserves the total
    exactly and barely moves the norm, and a genuinely wrong deposit
    (scale factor, 2*dv weighting, mirroring, transposed layout) breaks
    the sum, the norm, or the shape correlation -- so the fallback gates
    on all three."""
    d = np.linalg.norm(have - want)
    nw = np.linalg.norm(want)
    nh = np.linalg.norm(have)
    if nw == 0 or nh == 0:
        return nw == nh
    if d / nw < tol:
        return True
    sw, sh = np.sum(want), np.sum(have)
    cos = float(np.dot(want, have)) / (nw * nh)
    return (abs(sh - sw) / max(abs(sw), 1e-300) < tol
            and abs(nh - nw) / nw < 10 * tol
            and cos > 0.95)

CURATED = [
    dict(nx=1, ny=2, na=2, nb=2, nv=2),
    dict(nx=3, ny=1, na=2, nb=2, nv=2),
    dict(nx=3, ny=2, na=1, nb=1, nv=3),
    dict(nx=2, ny=2, na=2, nb=2, nv=1),
    dict(nx=4, ny=3, na=3, nb=2, nv=2, N=2),
    dict(nx=4, ny=3, na=3, nb=2, nv=2, N=1),
    dict(nx=4, ny=3, na=2, nb=2, nv=2, seeded=True, N=2),
    dict(nx=3, ny=2, na=2, nb=2, nv=2, seeded=True, full_plane=True),
    dict(nx=3, ny=2, na=2, nb=2, nv=3, non_uniform_gain=0.8),
    dict(nx=3, ny=2, na=2, nb=2, nv=2, seeded=True, non_uniform_gain=True),
    dict(nx=4, ny=2, na=2, nb=2, nv=2, full_plane=True, N=5),
    dict(nx=3, ny=3, na=2, nb=2, nv=2, seeded=True, refraction_free=True,
         seed_dim=5),
]


def random_config(rng):
    kw = dict(nx=int(rng.integers(1, 6)), ny=int(rng.integers(1, 5)),
              na=int(rng.integers(1, 5)), nb=int(rng.integers(1, 4)),
              nv=int(rng.integers(1, 6)), N=int(rng.integers(1, 8)))
    if rng.random() < 0.4:
        kw["seeded"] = True
        kw["seed_dim"] = int(rng.integers(5, 25))
    if rng.random() < 0.3:
        kw["full_plane"] = True
    r = rng.random()
    if r < 0.25:
        kw["non_uniform_gain"] = True
    elif r < 0.5:
        kw["non_uniform_gain"] = float(rng.uniform(0.2, 1.0))
    if rng.random() < 0.3:
        kw["refraction_free"] = True
    return kw


#: fixed second problem interleaved into every --stream check; its sync
#: result is computed once and must come back bitwise from the executor
_ALT_KW = dict(nx=3, ny=2, na=2, nb=2, nv=2)
_ALT_SYNC = []


_MESH = []


def _mesh():
    """One mesh for the whole sweep: sharding's pipeline cache keys on
    id(mesh), so a fresh mesh per case would guarantee a recompile even
    when shapes repeat."""
    if not _MESH:
        from raytrace_tpu.parallel.mesh import make_mesh
        _MESH.append(make_mesh(min(8, len(jax.devices()))))
    return _MESH[0]


def _check_stream(ci, kw, scale_g0, want_lax, want_pallas=None):
    """The serving-mode executor (create_image_stream) shares the sync
    pipeline code, so with identical inputs it must yield bitwise-equal
    images -- both for the case's own problem and for a second in-flight
    problem interleaved behind it (depth=2 overlap)."""
    from raytrace_tpu import create_image_stream
    p = synthetic_problem(rng=ci, **kw)
    if scale_g0:
        physical_gain(p)
    alt = synthetic_problem(rng=4242, **_ALT_KW)
    if not _ALT_SYNC:
        _ALT_SYNC.append(create_image(
            synthetic_problem(rng=4242, **_ALT_KW), "lax", chunk_size=1024))
    outs = list(create_image_stream([p, alt], "lax", chunk_size=1024))
    bad = 0
    if not np.array_equal(np.asarray(outs[0][0]).reshape(-1), want_lax):
        print(f"  STREAM [{ci}] case image != sync lax {kw}")
        bad += 1
    if not (np.array_equal(outs[1][0], _ALT_SYNC[0][0])
            and np.array_equal(outs[1][1], _ALT_SYNC[0][1])):
        print(f"  STREAM [{ci}] interleaved alt problem != its sync result")
        bad += 1
    if want_pallas is not None:
        # cost-feedback reorder arm: two same-shaped units; call 1 runs in
        # natural order (bitwise), call 2 in feedback order -- both must
        # match sync pallas to deposit-reassociation level (the only
        # difference a permutation can make: intensities are summed into
        # the same bins in a different order). Off the pallas envelope the
        # flag is inert and the gate degenerates to near-bitwise.
        def mkp():
            q = synthetic_problem(rng=ci, **kw)
            if scale_g0:
                physical_gain(q)
            return q

        arms = [("", dict(chunk_size=1024))]
        if SHARDED:
            # per-shard feedback on the virtual mesh must hold across the
            # same random envelope
            arms.append(("sharded ", dict(chunk_size=1024, mesh=_mesh())))
        for aname, akw in arms:
            routs = list(create_image_stream([mkp(), mkp()], "pallas",
                                             reorder=True, **akw))
            for k, (rimg, _rang) in enumerate(routs):
                got_r = np.asarray(rimg).reshape(-1)
                n0 = np.linalg.norm(want_pallas)
                d = np.linalg.norm(got_r - want_pallas) / max(n0, 1e-300)
                if not (d <= 1e-5
                        or (n0 == 0 and np.linalg.norm(got_r) == 0)):
                    print(f"  REORDER [{ci}] {aname}call {k} vs sync "
                          f"pallas {kw} rel={d:.2e}")
                    bad += 1
    return bad


#: (case_idx, which_output, self_sensitivity, widened_tol) per engagement
#: of the self-calibrating chaos gate -- summarized at the end of the run
#: so systematic engagement (a possible common-mode backend bug hiding
#: behind chaos) is visible, not buried in per-case log lines
CHAOS_GATE_ENGAGED = []


def run_case(ci, kw):
    method = 2 if kw.get("seeded") else 1
    bad = 0
    try:
        p = synthetic_problem(rng=ci, **kw)
        if p.N > 5:
            # keep long paths in f32 spectrum range (saturated regime)
            physical_gain(p)
        want_img, want_ang = oracle_images(p, method)
        if want_img is None:
            print(f"  [{ci}] {kw} -> failure-path config, skipped")
            return 0

        # self-calibrating chaos gate: the fixed tol_for budget models the
        # chaos growth on uniform grids, but warped non-uniform geometries
        # can exceed it (measured: seeded N=7 warped nv=1 at 5.3e-2 with
        # all five backends agreeing to ~1e-7 -- pure oracle-vs-XLA f32
        # trajectory divergence). Rather than inflating the static budget,
        # measure THIS case's chaos directly: perturb the entry grid by
        # 1e-6 relative (>= the f32 entry-rounding differences between
        # implementations) and rerun the oracle; if the oracle moves
        # itself by s, a backend mismatch <= 4s is explained by chaos.
        # Capped at 0.25 so order-unity bugs (wrong scale/mirror/layout)
        # still fail, and the tight cross-backend gates below are
        # unaffected. Computed lazily -- only cases that exceed tol_for
        # pay the second oracle run.
        _sens = {}

        def chaos_sens():
            if not _sens:
                pp = synthetic_problem(rng=ci, **kw)
                if pp.N > 5:
                    physical_gain(pp)
                srcb = pp.seed_beam if method == 2 else pp.euv_beam
                srcb.x = np.asarray(srcb.x) * (1.0 + 1e-6)
                s_img, s_ang = oracle_images(pp, method)
                if s_img is None:
                    _sens["v"] = (0.0, 0.0)
                else:
                    _sens["v"] = (
                        np.linalg.norm(s_img - want_img)
                        / max(np.linalg.norm(want_img), 1e-300),
                        np.linalg.norm(s_ang - want_ang)
                        / max(np.linalg.norm(want_ang), 1e-300))
            return _sens["v"]

        def chaos_tol(base, which):
            t = min(max(base, 4.0 * chaos_sens()[which]), 0.25)
            if t > base:
                # record engagement globally: a COMMON-MODE bug shared by
                # all batched backends could hide behind this widened gate
                # (the tight cross-backend gates would not see it since the
                # backends agree with each other), so systematic engagement
                # across the run must be visible in the final summary, not
                # just per-case log lines
                CHAOS_GATE_ENGAGED.append(
                    (ci, which, float(chaos_sens()[which]), float(t)))
                print(f"  [{ci}] chaos gate engaged "
                      f"(oracle self-sensitivity {chaos_sens()[which]:.2e})")
            return t
        backends = [("lax", False), ("lax-exact", False), ("pallas", False)]
        if SHARDED:
            backends += [("lax", True), ("pallas", True)]
        got = {}
        got_ang = {}
        fam = {}
        from raytrace_tpu.models.ray_tracer import resolve_method
        for backend, sharded in backends:
            p2 = synthetic_problem(rng=ci, **kw)
            if p2.N > 5:
                physical_gain(p2)
            if sharded:
                from raytrace_tpu.parallel.sharding import create_image_sharded
                img, ang = create_image_sharded(p2, _mesh(), backend,
                                                chunk_size=1024)
            else:
                img, ang = create_image(p2, backend, chunk_size=1024)
            tag = f"{backend}+sharded" if sharded else backend
            got[tag] = np.asarray(img).reshape(-1)
            got_ang[tag] = np.asarray(ang).reshape(-1)
            fam[tag] = _family(resolve_method(p2, backend))
            # both halves of the output are gated: the near-field spectrum
            # image AND the far-field angular image (the latter with the
            # redistribution-tolerant gate, see ang_close)
            n0 = np.linalg.norm(want_img)
            d = np.linalg.norm(got[tag] - want_img) / max(n0, 1e-300)
            base = tol_for(p.N, method == 2)
            if not (d < base
                    or (n0 == 0 and np.linalg.norm(got[tag]) == 0)
                    or d < chaos_tol(base, 0)):
                print(f"  MISMATCH [{ci}] {tag} image {kw} rel={d:.2e}")
                bad += 1
            if not (ang_close(want_ang, got_ang[tag], base)
                    or ang_close(want_ang, got_ang[tag],
                                 chaos_tol(base, 1))):
                d = (np.linalg.norm(got_ang[tag] - want_ang)
                     / max(np.linalg.norm(want_ang), 1e-300))
                print(f"  MISMATCH [{ci}] {tag} I_ang {kw} rel={d:.2e}")
                bad += 1
        # pairwise cross-backend consistency (tight: shared arithmetic).
        # Same-family pairs share the stepping decisions so bin flips are
        # identical and I_ang stays tight; cross-family I_ang gets the
        # redistribution-tolerant gate like the oracle check.
        tags = sorted(got)
        for i, ta in enumerate(tags):
            for tb in tags[i + 1:]:
                same_fam = fam[ta] == fam[tb]
                tol = TOL_XBACKEND if same_fam else tol_for(p.N, method == 2)
                na = np.linalg.norm(got[ta])
                d = np.linalg.norm(got[ta] - got[tb]) / max(na, 1e-300)
                if not (d < tol or (na == 0
                                    and np.linalg.norm(got[tb]) == 0)):
                    print(f"  XBACKEND [{ci}] {ta} vs {tb} image {kw} "
                          f"rel={d:.2e}")
                    bad += 1
                ang_ok = (ang_close(got_ang[ta], got_ang[tb], tol)
                          if not same_fam else
                          np.linalg.norm(got_ang[ta] - got_ang[tb])
                          <= tol * max(np.linalg.norm(got_ang[ta]), 1e-300)
                          or (np.linalg.norm(got_ang[ta]) == 0
                              and np.linalg.norm(got_ang[tb]) == 0))
                if not ang_ok:
                    d = (np.linalg.norm(got_ang[ta] - got_ang[tb])
                         / max(np.linalg.norm(got_ang[ta]), 1e-300))
                    print(f"  XBACKEND [{ci}] {ta} vs {tb} I_ang {kw} "
                          f"rel={d:.2e}")
                    bad += 1
        if STREAM:
            bad += _check_stream(ci, kw, p.N > 5, got["lax"],
                                 got.get("pallas"))
    except Exception as e:
        print(f"  CRASH [{ci}] {kw} -> {type(e).__name__}: {str(e)[:160]}")
        bad += 1
    return bad


def _rss_gb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1e6
    except OSError:
        pass
    return 0.0


def _map_count() -> int:
    """Memory mappings held by this process. Every compiled XLA executable
    pins several mmaps (JIT code + data sections); a long sweep of
    unique-shape cases exhausts vm.max_map_count (65530 on this host) LONG
    before RSS reaches the release threshold -- observed as LLVM 'Cannot
    allocate memory' then SIGSEGV at ~case 25 of a 30-case --sharded
    --stream run with RSS well under 8 GB."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def _release_memory():
    """Every fuzz case has unique shapes, so the pipeline caches and jax's
    jit caches grow one set of compiled CPU executables per case and
    (random cases) rarely hit again; a long sweep
    exhausted host memory (LLVM 'Cannot allocate memory', then a segfault
    in libgcc unwind). Dropping them between cases costs only re-trace
    time (the on-disk compile cache still serves repeat shapes)."""
    import gc

    from raytrace_tpu.models import ray_tracer
    ray_tracer._PIPELINE_CACHE.clear()
    try:
        from raytrace_tpu.parallel import sharding
        sharding._SHARDED_CACHE.clear()
    except Exception:
        pass
    jax.clear_caches()
    gc.collect()


def main():
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_random = int(pos[0]) if len(pos) > 0 else 8
    seed = int(pos[1]) if len(pos) > 1 else 0
    rng = np.random.default_rng(seed)
    cases = list(CURATED) + [random_config(rng) for _ in range(n_random)]
    bad = 0
    for ci, kw in enumerate(cases):
        bad += run_case(ci, kw)
        if _rss_gb() > 8.0 or _map_count() > 30000:
            _release_memory()
            _ALT_SYNC.clear()  # its pipeline was just dropped too
    if CHAOS_GATE_ENGAGED:
        frac = len({c for c, *_ in CHAOS_GATE_ENGAGED}) / len(cases)
        print(f"chaos gate engaged {len(CHAOS_GATE_ENGAGED)} time(s) across "
              f"{len({c for c, *_ in CHAOS_GATE_ENGAGED})} case(s) "
              f"({100 * frac:.0f}% of run): "
              + ", ".join(f"[{c}] out{w} sens={s:.1e} tol={t:.1e}"
                          for c, w, s, t in CHAOS_GATE_ENGAGED))
        if frac > 0.25:
            print("WARNING: chaos gate engaged on >25% of cases -- the "
                  "widened tolerance could be masking a common-mode backend "
                  "bug; inspect the engaged cases' cross-backend agreement")
    print(f"fuzz done: {len(cases)} cases, {bad} problems, "
          f"chaos_gate_engagements={len(CHAOS_GATE_ENGAGED)}")
    return bad


if __name__ == "__main__":
    raise SystemExit(main())
