#!/usr/bin/env python
"""Stage ablation of the real seeded create_image call (pallas backend).

Variants monkeypatch the amplify/binning stages inside the production
pipeline, so the measured deltas reflect the true fusion behavior:

  full      : production path
  noamp     : amplify replaced by Iv0 passthrough (kills the gv gathers+exp)
  nobin     : binning replaced by a cheap fixed-bin deposit (keeps amplify)
  trace     : both replaced (isolates trace + seed + scan glue)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed_calls(fn, n=5):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[0], ts[len(ts) // 2]


def main():
    import jax
    import jax.numpy as jnp

    from raytrace_tpu import create_image, load_input
    from raytrace_tpu.models import ray_tracer
    from raytrace_tpu.ops import binning, spectrum
    from raytrace_tpu.testing import SEED_SNAPSHOT

    which = sys.argv[1] if len(sys.argv) > 1 else "full"
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 65536

    problem, image0, iang0 = load_input(SEED_SNAPSHOT)

    if which in ("noamp", "trace"):
        real_amplify = spectrum.amplify

        def fake_amplify(res, Iv0, gv, N, use_emis, dtype=jnp.float64):
            # consume gvl so the trace isn't DCE'd, but no gathers/exp
            return Iv0.astype(dtype) * (1.0 + 1e-30 * jnp.sum(
                res.gvl, axis=(1, 2)))[:, None]

        spectrum.amplify = fake_amplify
    if which in ("nobin", "trace"):
        real_bin = binning.bin_images

        def fake_bin(Iv, res, rays, beam, method, scale, valid, deposit="scatter"):
            nx, ny = beam.x.shape[0], beam.y.shape[0]
            na, nb = beam.a.shape[0], beam.b.shape[0]
            img = jnp.zeros((nx * ny, Iv.shape[1]), jnp.float64)
            img = img.at[0].add(jnp.sum(Iv, axis=0).astype(jnp.float64))
            ang = jnp.zeros((na * nb,), jnp.float64)
            ang = ang.at[0].add(jnp.sum(Iv).astype(jnp.float64))
            return img, ang

        binning.bin_images = fake_bin

    create_image(problem, "pallas", chunk_size=chunk)  # compile
    best, med = timed_calls(
        lambda: create_image(problem, "pallas", chunk_size=chunk))
    print(f"{which:8s} chunk={chunk}: best {best:.4f}s median {med:.4f}s")


if __name__ == "__main__":
    main()
