"""Device-mesh helpers for multi-chip runs.

The reference distributes work across MPI ranks with a stride contract and
reduces images with MPI_Allreduce (SURVEY.md section 2.4). The JAX
equivalent is a 1-D ``jax.sharding.Mesh`` over the ray batch ("rays" axis):
rays ride data parallelism, image reductions ride a ``psum`` over the interconnect. A mesh of
size 1 degrades to the single-chip path, mirroring the reference's no-MPI
shims (src/MPI_helpers.h:41-52).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["RAY_AXIS", "make_mesh", "ray_sharding", "replicated"]

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Create a 1-D mesh over the ray axis. ``n_devices=None`` uses all
    local devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (ray) dimension across the mesh."""
    return NamedSharding(mesh, PartitionSpec(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
