#!/usr/bin/env python
"""A/B: sharded sync ASE on mesh[1] -- split (gv-upload overlap) vs
one-dispatch, vs the single-chip pipeline.

A one-dispatch sharded call cannot overlap the gv lineshape upload with
the trace. make_sharded_split_pipeline implements the two-dispatch overlap
inside the sharded path; this tool interleaves the three variants
rep-by-rep (drift cancels) on distinct-tables copies.

Usage: python tools/bench_sharded_split.py [input.dat] [reps]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace_tpu.testing import ASE_SNAPSHOT  # noqa: E402

INPUT = sys.argv[1] if len(sys.argv) > 1 else ASE_SNAPSHOT
REPS = int(sys.argv[2]) if len(sys.argv) > 2 else 9


def main():
    import jax

    from raytrace_tpu import create_image
    from raytrace_tpu.parallel.mesh import make_mesh
    from raytrace_tpu.parallel.sharding import (create_image_sharded,
                                                prepare_sharded)
    from raytrace_tpu.testing import perturbed_problems

    mesh = make_mesh(min(1, len(jax.devices())) or 1)
    print(f"mesh: {mesh.size} device(s), backend {jax.default_backend()}",
          file=sys.stderr)

    # compile all three variants on warmup copies
    warm = perturbed_problems(INPUT, 3, salt=201)
    assert prepare_sharded(warm[0], mesh, "pallas").cfg["split"]
    create_image_sharded(warm[0], mesh, "pallas")
    os.environ["RAYTRACE_NO_SPLIT"] = "1"
    assert not prepare_sharded(warm[1], mesh, "pallas").cfg["split"]
    create_image_sharded(warm[1], mesh, "pallas")
    del os.environ["RAYTRACE_NO_SPLIT"]
    create_image(warm[2], "pallas")

    rows = {"sharded_split": [], "sharded_one_dispatch": [], "single_chip": []}
    for r in range(REPS):
        probs = perturbed_problems(INPUT, 3, salt=301 + r)
        t0 = time.perf_counter()
        create_image_sharded(probs[0], mesh, "pallas")
        rows["sharded_split"].append(time.perf_counter() - t0)
        os.environ["RAYTRACE_NO_SPLIT"] = "1"
        t0 = time.perf_counter()
        create_image_sharded(probs[1], mesh, "pallas")
        rows["sharded_one_dispatch"].append(time.perf_counter() - t0)
        del os.environ["RAYTRACE_NO_SPLIT"]
        t0 = time.perf_counter()
        create_image(probs[2], "pallas")
        rows["single_chip"].append(time.perf_counter() - t0)

    out = {}
    for k, ts in rows.items():
        ts.sort()
        out[f"{k}_best_s"] = round(ts[0], 4)
        out[f"{k}_median_s"] = round(ts[len(ts) // 2], 4)
    # correctness: the split sharded image must equal single-chip's to the
    # golden-gate level (deposit order identical; transfers only moved)
    pa = perturbed_problems(INPUT, 2, salt=999)
    img_s, ang_s = create_image_sharded(pa[0], mesh, "pallas")
    img_1, ang_1 = create_image(pa[1], "pallas")
    # pa[0]/pa[1] have different perturbation factors; compare shape-level
    from raytrace_tpu.io.loader import load_input
    p_c1, _, _ = load_input(INPUT)
    p_c2, _, _ = load_input(INPUT)
    img_a, ang_a = create_image_sharded(p_c1, mesh, "pallas")
    img_b, ang_b = create_image(p_c2, "pallas")
    rel = float(np.linalg.norm(img_a - img_b)
                / max(np.linalg.norm(img_b), 1e-300))
    out["split_vs_single_rel"] = rel
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
