#!/usr/bin/env python
"""Multi-process worker for the distributed collectives test harness.

The JAX analogue of running the reference under ``mpirun -np P``
(src/CreateImage.cpp:226-236 under MPI): every process computes a stride-
decomposed share of the rays (the N_start/N_parallel contract,
src/RayTraceImage.cpp:300-328), the image buffers meet in a cross-process
reduction (the MPI_Allreduce contract, src/RayTraceStructures.cpp:1603-1646),
and per-rank timings are all-gathered (src/MPI_helpers.h:34-38).

Usage (one invocation per process, see tests/test_distributed.py):
    python tools/run_distributed.py <process_id> <num_processes> <port>

Exit code 0 iff every check passes on this rank. Prints CHECK lines that the
pytest wrapper asserts on.
"""

import os
import sys
import time


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    # 2 virtual CPU devices per process: the global mesh is 2P devices, so
    # the image psum below genuinely spans processes AND local devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    from raytrace_tpu.parallel import distributed

    distributed.startup(coordinator_address=f"localhost:{port}",
                        num_processes=nproc, process_id=pid)
    assert distributed.rank() == pid and distributed.size() == nproc

    import numpy as np
    from jax.sharding import Mesh

    from raytrace_tpu import create_image
    from raytrace_tpu.parallel import collectives
    from raytrace_tpu.parallel.sharding import create_image_sharded
    from raytrace_tpu.testing import synthetic_problem

    ok = True

    def check(name, cond):
        nonlocal ok
        ok = ok and bool(cond)
        print(f"CHECK[{pid}] {name}: {'pass' if cond else 'FAIL'}", flush=True)

    # --- gather_all: per-rank timings, distinct values per rank ------------
    t0 = time.perf_counter()
    my_timing = np.array([100.0 + pid, 0.5 * (pid + 1)])
    gathered = collectives.gather_all(my_timing)
    check("gather_all_shape", gathered.shape == (nproc, 2))
    check("gather_all_values",
          np.allclose(gathered[:, 0], 100.0 + np.arange(nproc)))

    # --- sum_scalar: error-count reduction ---------------------------------
    total = collectives.sum_scalar(pid + 1)
    check("sum_scalar", total == nproc * (nproc + 1) // 2)

    # --- host_sum_arrays: distinct per-rank buffers -------------------------
    a = np.full((3, 2), float(pid + 1))
    b = np.arange(4, dtype=np.float64) * (pid + 1)
    sa, sb = collectives.host_sum_arrays([a, b])
    tot = nproc * (nproc + 1) / 2
    check("host_sum_arrays",
          np.allclose(sa, tot) and np.allclose(sb, np.arange(4) * tot))

    # --- MPI-style replicated-problem run: stride decomposition over ranks,
    # image reduce across processes (intensity_step_struct::sum_reduce) ----
    # f64 spectrum keeps the per-chunk scatter deposits in f64 so the only
    # partition effect is f64 summation order (~1e-13); the default f32
    # deposit would add ~2e-7 chunk-composition noise (binning.py)
    import jax.numpy as jnp

    p_full = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5)
    img_full, ang_full = create_image(p_full, "lax", chunk_size=1024,
                                      spectrum_dtype=jnp.float64)

    p_mine = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5)
    p_mine.N_start = pid
    p_mine.N_parallel = nproc
    img_p, ang_p = create_image(p_mine, "lax", chunk_size=1024,
                                spectrum_dtype=jnp.float64)
    img_sum, ang_sum = collectives.host_sum_arrays([img_p, ang_p])
    check("stride_partition_image",
          np.allclose(img_sum, img_full, rtol=1e-10, atol=1e-300))
    check("stride_partition_iang",
          np.allclose(ang_sum, ang_full, rtol=1e-10, atol=1e-300))

    # --- global-mesh sharded run: the in-jit image psum spans processes ----
    devs = jax.devices()  # global: nproc * 2 CPU devices
    mesh = Mesh(np.array(devs), ("rays",))
    p_sh = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5)
    img_sh, ang_sh = create_image_sharded(p_sh, mesh, "lax", chunk_size=512,
                                          spectrum_dtype=jnp.float64)
    check("global_mesh_psum_image",
          np.allclose(img_sh, img_full, rtol=1e-10, atol=1e-300))
    check("global_mesh_psum_iang",
          np.allclose(ang_sh, ang_full, rtol=1e-10, atol=1e-300))

    # gathered wall-times: the CreateImage MPI protocol (gatherAll of per-rank
    # seconds) -- values must differ per rank only by real clock noise, but
    # every rank must see ALL ranks' entries
    dt = time.perf_counter() - t0
    times = collectives.gather_all(np.array([dt]))
    check("gather_all_timings", times.shape == (nproc, 1)
          and np.all(times > 0))

    distributed.barrier()
    distributed.shutdown()
    print(f"RESULT[{pid}] {'ALL_PASS' if ok else 'SOME_FAIL'}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
