#!/usr/bin/env python
"""Production-iteration demo: the full-app reduction contract end-to-end.

The miniapp benchmarks ``create_image`` in isolation; the production code
that feeds it (see the dormant accumulators, SURVEY.md D8) runs an
iteration loop per length step:

    per rank:  create_image on this rank's ray stride  (N_start/N_parallel)
    -> accumulate into an intensity_step_struct        (::add)
    -> MPI_Allreduce every buffer across ranks         (::sum_reduce,
       src/RayTraceStructures.cpp:1603-1646)
    -> validity scan                                   (::valid)
    -> copy into the stacked history + energy summary  (intensity_struct::
       copy_step, :1835-1867)

This tool drives exactly that loop with this framework's equivalents
(raytrace_tpu.structures.IntensityStep/Intensity +
parallel.collectives.host_sum_arrays), on a synthetic problem, for any
process count: single-process it exercises the no-MPI shims; under the
local process group (tools/run_distributed.py pattern) the reduction
genuinely spans ranks. The spectral->step wiring here is schematic (the
full app's atomic physics owns it); the *contract* -- shapes, reduction,
validity, history -- is the reference's.

Usage:
    python tools/production_loop.py            # single process
    python tools/production_loop.py <pid> <nproc> <port>   # one rank
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(n_steps: int = 2) -> int:
    import numpy as np

    from raytrace_tpu import create_image
    from raytrace_tpu.parallel import distributed
    from raytrace_tpu.structures import Intensity, IntensityStep
    from raytrace_tpu.testing import synthetic_problem
    from raytrace_tpu.utils.pio import pout

    rank, size = distributed.rank(), distributed.size()
    nx, ny, na, nb, nv = 6, 4, 4, 3, 5

    history = Intensity().initialize(n_steps, nx, ny, na, nb, nv, N_seed=1)
    ok = True
    for it in range(n_steps):
        # this rank's share of the rays (the stride contract, P4)
        p = synthetic_problem(nx=nx, ny=ny, na=na, nb=nb, nv=nv,
                              full_plane=True, rng=it)
        p.N_start, p.N_parallel = rank, size
        # f64 spectrum keeps the deposits in f64 so the only cross-rank
        # partition effect is summation order (~1e-13), same choice as the
        # collectives harness (tools/run_distributed.py)
        import jax.numpy as jnp

        image, i_ang = create_image(p, "lax", chunk_size=2048,
                                    spectrum_dtype=jnp.float64)
        img3 = image.reshape(nx * ny, nv)

        step = IntensityStep().initialize(nx, ny, na, nb, nv, N_seed=1)
        step.image[:] = img3.sum(axis=1)          # v-integrated near field
        step.E_v[:] = img3.sum(axis=0)            # space-integrated spectrum
        step.E_ang[:] = i_ang
        step.W[:] = 0.0
        step.image_seed[0][:] = step.image        # schematic seed channel
        step.E_v_seed[0][:] = step.E_v
        step.E_ang_seed[0][:] = step.E_ang

        # cross-rank reduction: every rank ends with the global sums
        step.sum_reduce()
        if not step.valid():
            pout.write(f"step {it}: INVALID intensities\n")
            ok = False
        history.copy_step(it, p.euv_beam, step)
        pout.write(f"step {it}: E_sum={history.E_sum[it]:.17e} "
                   f"(ranks={size})\n")
    pout.write("production loop done: %s\n" % ("OK" if ok else "FAILED"))
    return 0 if ok else 1


def main() -> int:
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # before backend init; lets comparisons against the worker ranks
        # (which always run on the CPU) be platform-for-platform
        import jax

        jax.config.update("jax_platforms", "cpu")
    if len(sys.argv) == 4:
        pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=1")
        import jax

        jax.config.update("jax_platforms", "cpu")
        from raytrace_tpu.parallel import distributed

        distributed.startup(coordinator_address=f"localhost:{port}",
                            num_processes=nproc, process_id=pid)
        rc = run()
        distributed.barrier()
        distributed.shutdown()
        return rc
    return run()


if __name__ == "__main__":
    raise SystemExit(main())
