"""CreateImage benchmark CLI -- the rebuild of ``src/CreateImage.cpp``.

Usage (mirrors the reference flags, Readme.txt:42-59 / CreateImageHelpers.h:50-96):

    python -m raytrace_tpu.utils.cli [options] file1.dat [file2.dat ...]
      -methods=lax,lax-exact     backends to benchmark (default: all
                                 available methods -- lax-exact, lax,
                                 pallas when running on a GPU, plus the
                                 mesh-sharded multichip path when more
                                 than one device is present)
      -iterations=N              timed calls per method (default 5)
      -scale=S                   problem-size scale factor (default 1.0)
      -multichip                 also run the mesh-sharded path
      -spectrum=f64|f32          amplification precision (default f32:
                                 the two-float f32 path matches f64
                                 quality on the shipped goldens; f64
                                 forces the reference's double math)
      -stream=N                  also benchmark serving-mode throughput:
                                 N independent work units (distinct gain
                                 tables per call, like production
                                 iterations) through create_image_stream,
                                 which overlaps call k+1's table upload
                                 with call k's compute. Reported as an
                                 extra "<method>+stream" row (per-call
                                 seconds = pass wall time / N, pipeline
                                 fill included) plus a "...+stream.steady"
                                 row of inter-completion spacing with the
                                 pipeline full (the steady-state
                                 throughput statistic; bench.py "ARTIFACT
                                 SCHEMA"); no golden row (the tables are
                                 perturbed per call). No reference
                                 analogue -- its harness times
                                 synchronous calls.
      -reorder                   with -stream: sort each call's rays by
                                 the previous call's measured per-ray
                                 micro-step counts (the cost-feedback
                                 reorder; pallas backend only, results
                                 match sync to f32-reassociation level
                                 instead of bitwise)
      -nprocs=P                  replicated multi-process benchmark: spawn a
                                 local P-process group (the ``mpirun -np P``
                                 workstation analogue, Readme.txt:43). Each
                                 rank runs the whole problem; timings are
                                 all-gathered and errors summed across ranks
                                 exactly like the reference's MPI protocol.
                                 On a GPU host each rank gets one card
                                 (rank r takes card r, or the r-th entry of
                                 CUDA_VISIBLE_DEVICES), so P must not exceed
                                 the cards; with JAX_PLATFORMS=cpu in the
                                 environment the group runs on the CPU.

Per file x method: a warmup call (the JIT analogue of the reference's GPU
warmup fixture, CreateImage.cpp:118-132), ``iterations`` timed calls,
Avg/Min/Max/StdDev table, the golden check when scale == 1, and the
timing-stability gates. Exit code = number of errors.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np

from raytrace_tpu.io.loader import load_input
from raytrace_tpu.models.ray_tracer import create_image
from raytrace_tpu.parallel import collectives
from raytrace_tpu.utils.pio import pout
from raytrace_tpu.utils.stats import TimingStats, check_ans, stability_errors
from raytrace_tpu.utils.timer import profiler


def _gather_times(times):
    """Pool per-rank timing samples (the gatherAll of per-iteration seconds,
    src/CreateImage.cpp:147-153 + src/MPI_helpers.h:34-38); stats run over
    every rank's samples. Identity on single-process runs."""
    return collectives.gather_all(np.asarray(times, np.float64)).reshape(-1)

__all__ = ["main", "Options", "run_tests"]


class Options:
    """Command-line options (Options::read_cmd, CreateImageHelpers.h:56-95)."""

    def __init__(self, argv):
        self.methods: list[str] = []
        self.iterations = 5
        self.scale = 1.0
        self.multichip = False
        self.spectrum = "f32"
        self.nprocs = 1
        self.stream = 0
        self.reorder = False
        self.files: list[str] = []
        for arg in argv:
            if arg.startswith("-methods="):
                self.methods = [m for m in arg.split("=", 1)[1].split(",") if m]
            elif arg.startswith("-iterations="):
                self.iterations = int(arg.split("=", 1)[1])
            elif arg.startswith("-scale="):
                self.scale = float(arg.split("=", 1)[1])
            elif arg == "-multichip":
                self.multichip = True
            elif arg.startswith("-spectrum="):
                self.spectrum = arg.split("=", 1)[1]
            elif arg.startswith("-nprocs="):
                self.nprocs = int(arg.split("=", 1)[1])
            elif arg.startswith("-stream="):
                self.stream = int(arg.split("=", 1)[1])
            elif arg == "-reorder":
                self.reorder = True
            elif arg.startswith("-"):
                raise SystemExit(f"Unknown option: {arg}")
            else:
                self.files.append(arg)
        if self.reorder and self.stream <= 0:
            raise SystemExit("-reorder requires -stream=N (it reorders the "
                             "serving stream's rays)")


def run_tests(filename: str, options: Options) -> int:
    """Benchmark one input file (run_tests, CreateImage.cpp:84-190)."""
    import jax.numpy as jnp

    pout.write(f"\nRunning tests for {filename}\n\n")
    # "Default is all availible methods" (CreateImageHelpers.h:61): with no
    # -methods= flag, benchmark every backend this host can run at speed --
    # on a GPU that includes the pallas kernel, and with >1 device
    # the mesh-sharded path too (the reference's defaults likewise include
    # Cuda-MultiGPU when several GPUs exist, CreateImageHelpers.h:62).
    import jax
    from raytrace_tpu.models.ray_tracer import (available_methods,
                                                resolve_method)
    multichip = options.multichip
    if not options.methods:
        methods = available_methods()
        multichip = multichip or jax.device_count() > 1
    else:
        methods = options.methods
    sdtype = jnp.float64 if options.spectrum == "f64" else jnp.float32
    n_errors = 0

    problem, image0, i_ang0 = load_input(filename, options.scale)
    rows = []
    benchmarked: set[str] = set()
    for method in methods:
        # label rows with the backend that really runs: out-of-envelope
        # requests (e.g. pallas on a >128-point non-uniform grid) fall back
        # to lax-exact, and a row labeled with the requested name would
        # misreport which backend was timed
        actual = resolve_method(problem, method)
        label = method if actual == method else f"{method}->{actual}"
        if actual != method:
            pout.write(f"Running {method} (out of envelope, runs {actual})\n")
        else:
            pout.write(f"Running {method}\n")
        if not options.methods and actual in benchmarked:
            # default all-methods mode: don't burn iterations timing the
            # same fallback backend under a second name
            pout.write(f"  (same backend as an earlier row, skipped)\n")
            continue
        benchmarked.add(actual)
        # warmup (JIT compile) run, like the reference's GPU warmup; runs
        # the full-size problem so the compiled pipeline is exactly the
        # one the timed calls hit
        create_image(problem, method, spectrum_dtype=sdtype)

        times = []
        for _ in range(options.iterations):
            t0 = time.perf_counter()
            image, i_ang = create_image(problem, method, spectrum_dtype=sdtype)
            times.append(time.perf_counter() - t0)
        stats = TimingStats.of(_gather_times(times))
        rows.append((label, stats))

        if options.scale == 1.0 and image0 is not None:
            if not check_ans(image0, i_ang0, image, i_ang):
                n_errors += 1
        n_errors += stability_errors(stats)

        if options.stream > 0:
            from raytrace_tpu.models.ray_tracer import (create_image_stream,
                                                        prepare_pipeline)
            from raytrace_tpu.testing import time_stream_detailed

            def make_stream(units, _m=method):
                def gen():
                    nonlocal n_errors
                    for s_img, s_ang in create_image_stream(
                            units, _m, spectrum_dtype=sdtype,
                            reorder=options.reorder):
                        if not (np.isfinite(s_img).all()
                                and np.isfinite(s_ang).all()):
                            n_errors += 1
                        yield s_img, s_ang
                return gen()

            # two rounds -> a min and a spread
            per_call, detail = time_stream_detailed(
                filename, options.stream, 2, make_stream,
                scale=options.scale)
            # label by what actually EXECUTED: -reorder is silently inert
            # off the pallas envelope (prepare_pipeline's fallback policy),
            # and a row claiming a reorder measurement that never ran
            # could wrongly justify flipping the default
            ran_reorder = options.reorder and prepare_pipeline(
                problem, method, spectrum_dtype=sdtype,
                reorder=True).cfg["reorder"]
            tag = "+stream+reorder" if ran_reorder else "+stream"
            rows.append((f"{label}{tag}",
                         TimingStats.of(_gather_times(per_call))))
            # steady-state inter-completion spacing (pipeline-full
            # throughput; fill excluded -- see bench.py ARTIFACT SCHEMA):
            # the steady-state serving-mode statistic
            yields = [y for d in detail for y in d["yield_s"]]
            if yields:
                rows.append((f"{label}{tag}.steady",
                             TimingStats.of(_gather_times(yields))))

    if multichip:
        from raytrace_tpu.parallel.mesh import make_mesh
        from raytrace_tpu.parallel.sharding import create_image_sharded

        mesh = make_mesh()
        pout.write(f"Running multichip (mesh size {mesh.size})\n")
        create_image_sharded(problem, mesh, spectrum_dtype=sdtype)
        times = []
        for _ in range(options.iterations):
            t0 = time.perf_counter()
            image, i_ang = create_image_sharded(problem, mesh,
                                                spectrum_dtype=sdtype)
            times.append(time.perf_counter() - t0)
        stats = TimingStats.of(_gather_times(times))
        rows.append((f"multichip[{mesh.size}]", stats))
        if options.scale == 1.0 and image0 is not None:
            if not check_ans(image0, i_ang0, image, i_ang):
                n_errors += 1
        if options.stream > 0:
            from raytrace_tpu.models.ray_tracer import create_image_stream
            from raytrace_tpu.testing import time_stream_detailed

            def make_stream_mc(units):
                def gen():
                    nonlocal n_errors
                    for s_img, s_ang in create_image_stream(
                            units, mesh=mesh, spectrum_dtype=sdtype):
                        if not (np.isfinite(s_img).all()
                                and np.isfinite(s_ang).all()):
                            n_errors += 1
                        yield s_img, s_ang
                return gen()

            per_call, detail = time_stream_detailed(
                filename, options.stream, 2, make_stream_mc, salt0=10,
                scale=options.scale)
            rows.append((f"multichip[{mesh.size}]+stream",
                         TimingStats.of(_gather_times(per_call))))
            yields = [y for d in detail for y in d["yield_s"]]
            if yields:
                rows.append((f"multichip[{mesh.size}]+stream.steady",
                             TimingStats.of(_gather_times(yields))))

    w = max(14, max((len(r[0]) for r in rows), default=14))
    pout.write(f"\n{'METHOD':>{w}s} {'Avg':>8s} {'Min':>8s} {'Max':>8s} {'Std Dev':>9s}\n")
    for method, stats in rows:
        pout.write(f"{method:>{w}s} {stats.avg:8.3f} {stats.min:8.3f}"
                   f" {stats.max:8.3f} {stats.std:9.3f}\n")
    return n_errors


def worker_env(base, rank: int, nprocs: int, port: int) -> dict:
    """Environment of process-group worker ``rank``: the group's
    coordinates, and on a GPU host one card per rank -- card ``rank``, or
    the rank-th entry of an inherited CUDA_VISIBLE_DEVICES list -- so each
    JAX process reserves memory on its own card only. A group asked onto
    the CPU (JAX_PLATFORMS=cpu, as the tests run it) gets no card."""
    env = dict(base)
    env.update(RAYTRACE_COORD=f"localhost:{port}",
               RAYTRACE_NPROCS=str(nprocs), RAYTRACE_PROC_ID=str(rank))
    if env.get("JAX_PLATFORMS", "") != "cpu":
        visible = env.get("CUDA_VISIBLE_DEVICES")
        cards = (visible.split(",") if visible
                 else [str(i) for i in range(nprocs)])
        if rank >= len(cards):
            raise SystemExit(f"-nprocs={nprocs} needs {nprocs} cards; "
                             f"CUDA_VISIBLE_DEVICES lists {len(cards)}")
        env["CUDA_VISIBLE_DEVICES"] = cards[rank]
    return env


def _launch_process_group(argv, nprocs: int) -> int:
    """Spawn the local P-process group (the ``mpirun -np P`` analogue).

    Each worker re-runs this CLI with the same flags plus the process-group
    environment; rank gating in pio keeps output to rank 0. Exit code is the
    max of the workers' (each already carries the cross-rank error sum).

    Port selection is race-free: rank 0 (the coordinator) is spawned alone
    and the launcher waits until its port actually accepts connections
    before committing the other ranks; if another process grabbed the port
    between probe and bind (the TOCTOU window), rank 0 dies and the launch
    retries on a fresh port instead of hanging the group."""

    def _spawn(pid: int, port: int):
        env = worker_env(os.environ, pid, nprocs, port)
        return subprocess.Popen(
            [sys.executable, "-m", "raytrace_tpu.utils.cli", *argv], env=env)

    for _attempt in range(3):
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()
        p0 = _spawn(0, port)
        deadline = time.perf_counter() + 120.0
        coordinator_up = False
        while time.perf_counter() < deadline:
            if p0.poll() is not None:
                break
            try:
                socket.create_connection(("localhost", port),
                                         timeout=0.2).close()
                coordinator_up = True
                break
            except OSError:
                time.sleep(0.05)
        if not coordinator_up:
            if p0.poll() is None:
                p0.kill()
                p0.wait()
                raise RuntimeError(
                    "process-group coordinator never came up")
            # rank 0 died before the coordinator came up. Distinguish a
            # lost port race from a genuine failure (bad input file,
            # import error, ...): only a race loser leaves SOMEONE ELSE
            # listening on the port it tried to bind.
            try:
                socket.create_connection(("localhost", port),
                                         timeout=0.2).close()
                continue  # port stolen by another process -> fresh port
            except OSError:
                return p0.returncode  # real failure: propagate it
        procs = [p0] + [_spawn(pid, port) for pid in range(1, nprocs)]
        return max(p.wait() for p in procs)
    raise RuntimeError(
        "could not start the process-group coordinator (port races)")


def _maybe_join_process_group() -> None:
    """Worker-side startup: join the group announced in the environment
    (the MPI_Init the launcher's ranks perform, src/MPI_helpers.h:9-11)."""
    if "RAYTRACE_PROC_ID" not in os.environ:
        return
    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # the CPU group, by explicit request (the tests); before backend init
        jax.config.update("jax_platforms", "cpu")
    from raytrace_tpu.parallel import distributed

    distributed.startup(
        coordinator_address=os.environ["RAYTRACE_COORD"],
        num_processes=int(os.environ["RAYTRACE_NPROCS"]),
        process_id=int(os.environ["RAYTRACE_PROC_ID"]))
    # every rank names its devices, so a launch can be checked to hold one
    # card per process
    devs = jax.local_devices()
    print(f"rank {jax.process_index()}/{jax.process_count()}: "
          f"{devs[0].platform} x{len(devs)} {devs[0].device_kind} "
          f"CUDA_VISIBLE_DEVICES="
          f"{os.environ.get('CUDA_VISIBLE_DEVICES', '')}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    options = Options(argv)
    if not options.files:
        print(__doc__)
        return 1
    if options.nprocs > 1 and "RAYTRACE_PROC_ID" not in os.environ:
        return _launch_process_group(argv, options.nprocs)
    _maybe_join_process_group()
    n_errors = 0
    for filename in options.files:
        n_errors += run_tests(filename, options)
    # cross-rank error reduction (sumReduce, src/CreateImage.cpp:189)
    n_errors = int(collectives.sum_scalar(n_errors))
    if n_errors == 0:
        pout.write("\nAll tests passed\n")
    else:
        pout.write(f"\nSome tests failed ({n_errors} errors)\n")
    pout.write("\n" + profiler.summary() + "\n")
    return min(n_errors, 255)


if __name__ == "__main__":
    raise SystemExit(main())
