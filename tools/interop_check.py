#!/usr/bin/env python
"""Bidirectional interop check against the reference C++ binary.

Direction 1 (their files -> us): tests/test_golden.py + the bench harness
validate this framework against the goldens embedded in the shipped
snapshots.

Direction 2 (our files -> them): this script computes images for synthetic
problems, embeds them as goldens in `.dat` files written by our serializer,
and runs the reference `CreateImage` binary on them -- the reference then
re-computes and applies its own 5e-6 norm gate against OUR goldens.

Usage:
    python tools/interop_check.py /path/to/reference/CreateImage [workdir] [--cpu]

``--cpu`` forces the JAX side onto the CPU backend (the reference side is
always CPU); use it on a host without a GPU.

Last verified result (2026-08-20, round 5): PASS for all seven synthetics
-- ASE, seeded, the full-plane (abs_y mirror off) variants of both, the
many-segment (N=12) ASE + seeded cases, and the strongly non-uniform
(power-warped) gain-grid case.

Building the reference binary (CPU-only) from the read-only checkout:

    echo '#define COMPILER_FEATURES_H' > CompilerFeatures.h
    g++ -O3 -std=c++11 -DDISABLE_WRITE_FAILED_RAYS -include functional \\
        -I. -I$REF/src -I$REF/src/common \\
        $REF/src/CreateImage.cpp $REF/src/CreateImageHelpers.cpp \\
        $REF/src/RayTraceImage.cpp $REF/src/RayTraceImageCPU.cpp \\
        $REF/src/RayTraceStructures.cpp $REF/src/AtomicModel/interp.cpp \\
        $REF/src/utilities/RayUtilities.cpp -o CreateImage -lpthread
"""

import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if not args:
        print(__doc__)
        return 1
    if "--cpu" in sys.argv:
        import jax
        jax.config.update("jax_platforms", "cpu")
    binary = args[0]
    workdir = Path(args[1]) if len(args) > 1 else Path(tempfile.mkdtemp())
    workdir.mkdir(parents=True, exist_ok=True)

    from raytrace_tpu import create_image
    from raytrace_tpu.io.loader import save_input
    from raytrace_tpu.testing import synthetic_problem

    files = []
    for name, kwargs in (("interop_ase.dat", dict(nx=16, ny=8, na=8, nb=6, nv=10)),
                         ("interop_seed.dat", dict(nx=10, ny=6, na=6, nb=5,
                                                   nv=8, seeded=True)),
                         # full-plane grids: the reference's abs_y mirror is
                         # OFF (y[0] < 0), exercising its non-mirrored paths
                         # against ours
                         ("interop_ase_fullplane.dat",
                          dict(nx=12, ny=8, na=6, nb=5, nv=8,
                               full_plane=True)),
                         # refraction_free: exit-coordinate binning on the
                         # full plane amplifies f32 trajectory jitter
                         # between this device's arithmetic and the
                         # reference's CPU (a measured ~1-in-10 random
                         # instance trips the 5e-6 norm gate on an
                         # accelerator);
                         # lockstep trajectories keep the comparison about
                         # semantics, not FMA contraction
                         ("interop_seed_fullplane.dat",
                          dict(nx=10, ny=6, na=6, nb=5, nv=8, seeded=True,
                               full_plane=True, refraction_free=True)),
                         # many-segment cases (N > 3, up to N_MAX=20 in the
                         # reference): the fori segment loop + escapes at
                         # long path lengths, judged by the reference's own
                         # recompute-and-gate. refraction_free keeps escape
                         # timing deterministic across implementations
                         # (see tests/test_create_image.py N=20 notes)
                         ("interop_ase_n12.dat",
                          dict(nx=8, ny=5, na=5, nb=4, nv=8, N=12,
                               refraction_free=True)),
                         ("interop_seed_n12.dat",
                          dict(nx=8, ny=5, na=5, nb=4, nv=8, N=12,
                               seeded=True, refraction_free=True)),
                         # strongly non-uniform (power-warped) gain grids:
                         # the reference's findindex bisection vs our
                         # arbitrary-grid backends
                         ("interop_ase_nonuniform.dat",
                          dict(nx=10, ny=6, na=6, nb=5, nv=8,
                               non_uniform_gain=0.5))):
        # fixed rng: reproducible cases (rng=None would draw fresh entropy
        # per run, making pass/fail depend on the random instance)
        p = synthetic_problem(rng=1234, **kwargs)
        if kwargs.get("N", 3) > 3:
            # saturated-regime gain so the f32 spectrum stays in range over
            # the long path
            from raytrace_tpu.testing import physical_gain
            physical_gain(p)
        img, ang = create_image(p, "lax")
        p.image = img
        p.I_ang = ang
        path = workdir / name
        save_input(path, p)
        files.append(path)
        print(f"wrote {path} (golden embedded from this framework)")

    failures = 0
    for path in files:
        out = subprocess.run([binary, "-methods=cpu", "-iterations=2",
                              str(path)], capture_output=True, text=True)
        # judge the GOLDEN gate specifically: the reference's "All tests
        # passed" also folds in its timing-stability gates, which trip on
        # a loaded shared host for a 6 ms run (stddev > 10%) and have
        # nothing to do with interop correctness. check_ans prints
        # "Answers do not match" to stderr on a golden failure
        # (src/CreateImageHelpers.cpp:94-98).
        golden_ok = "Answers do not match" not in (out.stdout + out.stderr)
        # the run must have COMPLETED, not just started: the reference
        # prints exactly one of these verdict lines at the very end
        # (src/CreateImage.cpp:246-248), and a signal death gives a
        # negative returncode -- without this, a binary that crashes after
        # "Running cpu" but before check_ans would count as golden-ok
        completed = (out.returncode is not None and out.returncode >= 0
                     and ("All tests passed" in out.stdout
                          or "Some tests failed" in out.stdout))
        ran = "Running cpu" in out.stdout and completed
        passed = golden_ok and ran
        timing_only = passed and "All tests passed" not in out.stdout
        note = " (timing-stability noise ignored)" if timing_only else ""
        print(f"{path.name}: {'PASS' if passed else 'FAIL'}{note}")
        if not passed:
            print(out.stdout[-800:], out.stderr[-400:])
            failures += 1
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
