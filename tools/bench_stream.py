#!/usr/bin/env python
"""A/B bench: sequential create_image vs create_image_stream arms.

Protocol: every call gets DISTINCT gain tables (a tiny per-call g0 scale),
as production iterations do, and the arms are interleaved per round so
drift cancels. Reported per-call seconds = wall time of the
whole arm / number of calls.

Usage:
    python tools/bench_stream.py [input.dat] [n_calls] [rounds]
        [--scale=S] [--depth=D] [--reorder] [--no-seq]

``--reorder`` adds a third arm: the cost-feedback-reordered stream
(create_image_stream(reorder=True)) -- the e2e A/B the census model's
caveat demands before any default flips (ROADMAP.md). ``--no-seq`` drops
the sequential arm (for long workloads where only stream-vs-stream
matters).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from raytrace_tpu import create_image, create_image_stream  # noqa: E402
from raytrace_tpu.testing import ASE_SNAPSHOT, perturbed_problems  # noqa: E402


def main():
    known = ("--scale=", "--depth=", "--reorder", "--no-seq")
    for a in sys.argv[1:]:
        if a.startswith("--") and not any(
                a == k or a.startswith(k) for k in known):
            raise SystemExit(f"Unknown option: {a} (known: {known})")
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    path = pos[0] if pos else ASE_SNAPSHOT
    n = int(pos[1]) if len(pos) > 1 else 8
    rounds = int(pos[2]) if len(pos) > 2 else 3
    scale = next((float(a.split("=")[1]) for a in sys.argv[1:]
                  if a.startswith("--scale=")), None)
    depth = next((int(a.split("=")[1]) for a in sys.argv[1:]
                  if a.startswith("--depth=")), 2)
    with_reorder = "--reorder" in sys.argv
    with_seq = "--no-seq" not in sys.argv

    def mk(salt):
        return perturbed_problems(path, n, salt, scale=scale)

    def drain(it):
        for _ in it:
            pass

    arms = []
    if with_seq:
        arms.append(("sequential",
                     lambda probs: [create_image(p) for p in probs]))
    arms.append((f"stream d{depth}",
                 lambda probs: drain(create_image_stream(probs,
                                                         depth=depth))))
    if with_reorder:
        arms.append((f"stream d{depth} reorder",
                     lambda probs: drain(create_image_stream(
                         probs, depth=depth, reorder=True))))

    # warmup every arm (JIT compile)
    for _name, run in arms:
        run(perturbed_problems(path, 2, 999, scale=scale))

    times = {name: [] for name, _ in arms}
    for r in range(rounds):
        for ai, (name, run) in enumerate(arms):
            probs = mk(len(arms) * r + ai)
            t0 = time.perf_counter()
            run(probs)
            times[name].append((time.perf_counter() - t0) / n)
        print("round %d:  %s" % (r, "   ".join(
            f"{name} {times[name][-1]:.4f}" for name, _ in arms)),
            flush=True)

    for name, ts in times.items():
        print(f"{name:>22s}: best {min(ts):.4f}  "
              f"med {sorted(ts)[len(ts)//2]:.4f} s/call")


if __name__ == "__main__":
    main()
