#!/usr/bin/env python
"""Generate the committed golden fixtures for the default test suite.

The reference's only real test is its golden-image gate: recompute the
problem and compare norms one-sidedly at 5e-6 against the golden embedded in
the input file (src/CreateImageHelpers.cpp:66-100). The shipped snapshots
(ASE_small/seed_small) are too big to trace on CPU in a default pytest run,
so this script manufactures *reference-anchored* miniature fixtures:

1. build deterministic synthetic problems (one ASE, one seeded);
2. compute their goldens with this framework (lax backend, CPU);
3. embed the goldens and write ``tests/fixtures/golden_{ase,seed}.dat``
   with the byte-exact serializer;
4. **validate each fixture with the reference C++ binary** -- the reference
   recomputes the problem with its own CPU kernel and applies its own 5e-6
   gate against our embedded golden. Only validated fixtures are kept.

Because step 4 passes, a later `check_ans` of any backend against these
fixtures is transitively a comparison against the reference's computed
answer at the reference's own tolerance.

Usage:
    python tools/make_golden_fixtures.py /path/to/reference/CreateImage

Building the reference binary (CPU-only) from the read-only checkout: see
tools/interop_check.py's docstring.
"""

import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FIXTURES = Path(__file__).resolve().parent.parent / "tests" / "fixtures"

#: fixture specs: big enough that every code path (multi-chunk scan, y-mirror
#: binning, seeded entry evaluation) runs, small enough for CPU pytest
SPECS = {
    "golden_ase.dat": dict(nx=16, ny=8, na=8, nb=6, nv=10),
    "golden_seed.dat": dict(nx=10, ny=6, na=6, nb=5, nv=8, seeded=True),
}


def main():
    if len(sys.argv) < 2:
        print(__doc__)
        return 1
    binary = sys.argv[1]
    FIXTURES.mkdir(parents=True, exist_ok=True)

    # goldens are computed on CPU (deterministic, matches the pytest config)
    import jax
    jax.config.update("jax_platforms", "cpu")

    from raytrace_tpu import create_image
    from raytrace_tpu.io.loader import save_input
    from raytrace_tpu.testing import synthetic_problem

    failures = 0
    for name, kwargs in SPECS.items():
        p = synthetic_problem(**kwargs)
        img, ang = create_image(p, "lax")
        p.image = img
        p.I_ang = ang
        path = FIXTURES / name
        save_input(path, p)
        out = subprocess.run([binary, "-methods=cpu", "-iterations=2",
                              str(path)], capture_output=True, text=True)
        passed = "All tests passed" in out.stdout
        print(f"{name}: reference-binary validation "
              f"{'PASS' if passed else 'FAIL'}")
        if not passed:
            print(out.stdout[-800:])
            path.unlink()
            failures += 1
    return failures


if __name__ == "__main__":
    raise SystemExit(main())
