"""Collective operations: the JAX equivalents of the reference's MPI
layer (SURVEY.md section 2.4 P5/P6).

Mapping:

* ``gatherAll`` (MPI_Allgather of per-rank timings, src/MPI_helpers.h:34-38)
  -> :func:`gather_all`: a real ``jax.lax.all_gather`` over the one-device-
  per-process rank mesh (see :func:`distributed.process_mesh`);
* ``sumReduce`` of error counts (src/MPI_helpers.h:29-33)
  -> :func:`sum_scalar`: a real ``jax.lax.psum`` over the rank mesh;
* ``intensity_step_struct::sum_reduce`` (MPI_Allreduce DOUBLE SUM over the
  flattened image buffers, src/RayTraceStructures.cpp:1603-1646)
  -> :func:`host_sum_arrays`: each rank's *distinct* buffers are placed as
  that rank's shard of a ``[P, total]`` global array (shard the input, never
  psum a replica) and reduced with one psum, matching the reference's single
  flattened Allreduce (RayTraceStructures.cpp:1612-1628);
* in-shard_map device reductions -> :func:`sum_reduce` (psum over the ray
  mesh axis, used by parallel.sharding for the image reduce);
* the no-MPI inline shims (src/MPI_helpers.h:41-52) -> every host-side
  function degrades to the identity when ``jax.process_count() == 1``.

Process model: one JAX process = one MPI rank. Each process may drive many
local devices (the shard_map ray mesh); the rank-level collectives below run
over a mesh with exactly one device per process so their semantics match
MPI's. Verified end-to-end by the 2-process CPU harness in
tests/test_distributed.py + tools/run_distributed.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from jax import shard_map

from raytrace_tpu.parallel import distributed
from raytrace_tpu.parallel.mesh import RAY_AXIS

__all__ = ["sum_reduce", "gather_all", "sum_scalar", "host_sum_arrays",
           "mesh_all_gather"]


def sum_reduce(tree, axis: str = RAY_AXIS):
    """Sum a pytree across the mesh axis (use inside shard_map/pjit)."""
    return jax.tree_util.tree_map(lambda x: jax.lax.psum(x, axis), tree)


@functools.lru_cache(maxsize=None)
def _jit_rank_op(mesh: Mesh, op: str):
    """Jitted rank collective, cached per (mesh, op): a fresh closure per
    call would miss jax's jit cache every time and pay a full retrace +
    compile per collective invocation."""
    if op == "gather":
        def inner(x):  # x: [1, n] local shard
            g = jax.lax.all_gather(x, "rank")  # [P, 1, n]
            return g.reshape(g.shape[0], -1)
    else:
        def inner(x):
            return jax.lax.psum(x, "rank")
    return jax.jit(shard_map(inner, mesh=mesh,
                             in_specs=PartitionSpec("rank"),
                             out_specs=PartitionSpec(), check_vma=False))


def _rank_collective(local, op, out_rows):
    """Run a cached collective over the one-device-per-process rank mesh,
    with ``local`` as this rank's shard of the [P, n] input."""
    mesh = distributed.process_mesh()
    P = jax.process_count()
    local = np.asarray(local, np.float64).reshape(1, -1)
    n = local.shape[1]
    sharding = NamedSharding(mesh, PartitionSpec("rank"))
    garr = jax.make_array_from_process_local_data(sharding, local, (P, n))
    out = _jit_rank_op(mesh, op)(garr)
    return np.asarray(jax.device_get(out.addressable_data(0))).reshape(out_rows, n)


def gather_all(values, mesh=None):
    """All-gather per-rank values (gatherAll analogue, MPI_helpers.h:34-38).

    ``values``: this rank's scalar or 1-D array (e.g. its timing samples).
    Returns a ``[P, len(values)]`` numpy array with every rank's contribution
    in rank order; identity (shape ``[1, n]``) when single-process. ``mesh``
    is accepted for signature compatibility and ignored: rank collectives
    always run over the process mesh.
    """
    arr = np.atleast_1d(np.asarray(values, dtype=np.float64))
    if jax.process_count() <= 1:
        return arr.reshape(1, -1)

    return _rank_collective(arr, "gather", jax.process_count())


def sum_scalar(value, mesh=None):
    """Sum a host scalar across ranks (sumReduce, MPI_helpers.h:29-33);
    identity when single-process."""
    if jax.process_count() <= 1:
        return value
    out = _rank_collective(np.array([float(value)]), "psum", 1)
    res = float(out[0, 0])
    return type(value)(res) if isinstance(value, (int, float)) else res


def host_sum_arrays(arrays, mesh=None):
    """Elementwise-sum each rank's *distinct* host buffers across ranks (the
    production ``intensity_step_struct::sum_reduce`` contract,
    src/RayTraceStructures.cpp:1603-1646).

    ``arrays``: list of this rank's numpy buffers. All ranks must pass the
    same shapes. The buffers are flattened and concatenated into one vector
    (like the reference's single MPI_Allreduce), placed as this rank's shard
    of a [P, total] global array, psum-reduced, and split back. Identity when
    single-process (the no-MPI shim).
    """
    arrays = [np.asarray(a, np.float64) for a in arrays]
    if jax.process_count() <= 1:
        return arrays
    sizes = [a.size for a in arrays]
    flat = np.concatenate([a.reshape(-1) for a in arrays]) if arrays else \
        np.zeros((0,), np.float64)
    out = _rank_collective(flat, "psum", 1)[0]
    res = []
    off = 0
    for a, s in zip(arrays, sizes):
        res.append(out[off:off + s].reshape(a.shape))
        off += s
    return res


def mesh_all_gather(per_device, mesh: Mesh, axis: str = RAY_AXIS):
    """Device-level all_gather over a shard_map mesh axis: ``per_device`` is
    a host array with leading dim ``mesh.size`` (one row per device); every
    device receives the full array. Exposed for mesh-axis aggregation tests;
    rank-level stats use :func:`gather_all`."""
    per_device = np.asarray(per_device, np.float64)
    if mesh is None or mesh.size <= 1:
        return per_device
    if per_device.shape[0] != mesh.size:
        raise ValueError("leading dim must equal mesh.size")
    return np.asarray(jax.device_get(
        _jit_mesh_gather(mesh, axis)(jnp.asarray(per_device))))


@functools.lru_cache(maxsize=None)
def _jit_mesh_gather(mesh: Mesh, axis: str):
    def inner(x):
        g = jax.lax.all_gather(x, axis)
        return g.reshape(g.shape[0] * x.shape[0], *x.shape[1:])

    return jax.jit(shard_map(inner, mesh=mesh,
                             in_specs=PartitionSpec(axis),
                             out_specs=PartitionSpec(), check_vma=False))
