"""Multi-process startup/shutdown shims: the JAX equivalent of the
reference's MPI bootstrap (src/MPI_helpers.h:9-27).

Mapping:

* ``startup(argc, argv)`` (MPI_Init) -> :func:`startup` wrapping
  ``jax.distributed.initialize`` -- on a real pod the coordinator address,
  process count and process id come from the launcher environment and
  ``startup()`` with no arguments picks them up automatically; a local
  multi-process CPU "cluster" (the test harness, tools/run_distributed.py)
  passes them explicitly;
* ``shutdown()`` (MPI_Finalize) -> :func:`shutdown`;
* ``rank()`` / ``size()`` (MPI_Comm_rank/size) -> :func:`rank` / :func:`size`;
* ``barrier()`` (MPI_Barrier) -> :func:`barrier` (a psum over the process
  mesh, which cannot complete until every process reaches it);
* the no-MPI inline shims (src/MPI_helpers.h:41-52) -> every function here
  is a no-op / identity when the process group was never initialized.

The process mesh used by the collectives in
:mod:`raytrace_tpu.parallel.collectives` picks one device per process, so
rank boundaries match the MPI model exactly (one process = one rank) while
intra-process device parallelism stays on the shard_map mesh.
"""

from __future__ import annotations

import jax
import numpy as np

__all__ = ["startup", "shutdown", "rank", "size", "barrier", "process_mesh",
           "is_distributed"]

_INITIALIZED = False


def startup(coordinator_address: str | None = None,
            num_processes: int | None = None,
            process_id: int | None = None) -> None:
    """Initialize the process group (MPI_Init analogue).

    With no arguments, defers to JAX's automatic cluster detection (cluster
    metadata / launcher env vars); single-process runs where nothing is
    detected remain single-process, mirroring the reference's no-MPI build.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
            _INITIALIZED = True
        except ValueError:
            # "coordinator_address should be defined": no cluster
            # environment was detected -> single-process mode (the no-MPI
            # shim). Any OTHER failure (unreachable coordinator, half-set
            # launcher env) propagates: silently degrading a pod launch to
            # independent single-process runs would produce wrong aggregate
            # results where the reference's MPI_Init aborts loudly.
            _INITIALIZED = False
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _INITIALIZED = True


def shutdown() -> None:
    """Tear down the process group (MPI_Finalize analogue)."""
    global _INITIALIZED
    if _INITIALIZED:
        jax.distributed.shutdown()
        _INITIALIZED = False


def is_distributed() -> bool:
    return jax.process_count() > 1


def rank() -> int:
    """This process's rank (MPI_Comm_rank analogue)."""
    return jax.process_index()


def size() -> int:
    """Number of processes (MPI_Comm_size analogue)."""
    return jax.process_count()


_PROCESS_MESH = None


def process_mesh():
    """A 1-D mesh with ONE device per process -- the rank axis for host-side
    collectives (gatherAll / sumReduce). None when single-process. Cached:
    the device set is fixed for the life of the process group."""
    global _PROCESS_MESH
    if jax.process_count() <= 1:
        return None
    if _PROCESS_MESH is None:
        from jax.sharding import Mesh

        devs = []
        for p in range(jax.process_count()):
            devs.append(next(d for d in jax.devices() if d.process_index == p))
        _PROCESS_MESH = Mesh(np.array(devs), ("rank",))
    return _PROCESS_MESH


def barrier(name: str = "raytrace_barrier") -> None:
    """Block until every process arrives (MPI_Barrier analogue)."""
    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
