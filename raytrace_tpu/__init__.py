"""raytrace_tpu: a JAX rebuild of the RayTrace miniapp capabilities.

Public API surface mirroring ``src/RayTrace.h``:

* :func:`create_image`   -- near-field + far-field image from a work unit
* :func:`create_image_stream` -- overlapped executor over independent work
  units (serving mode; no reference analogue)
* :func:`calc_ray`       -- single-ray propagation (diagnostic)
* :func:`calc_ray_path`  -- ray trajectories + running intensity (diagnostic)
* :func:`calc_seed`      -- seed spectrum at a phase-space point
* :func:`load_input` / :func:`save_input` -- byte-exact ``.dat`` snapshot IO

float64 must be available for image accumulation parity with the reference's
double buffers, so importing this package enables jax x64 mode; all
performance-critical arrays declare explicit (mostly float32) dtypes.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

#: the persistent compilation cache when JAX_COMPILATION_CACHE_DIR is unset:
#: a fixed path (the path is part of what a later process finds again)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def _setup_compile_cache() -> None:
    """Persistent compilation cache: first-call compiles of the pipelines
    take tens of seconds, and the cache makes later processes start warm.
    JAX reads JAX_COMPILATION_CACHE_DIR itself; only when it is unset is
    the cache put at DEFAULT_CACHE_DIR. On the CPU platform XLA's own
    caches stay off (their entries are machine code for the compiling
    host); on the GPU they keep XLA's autotuning results."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    if (jax.config.jax_platforms or "").split(",") == ["cpu"]:
        jax.config.update("jax_persistent_cache_enable_xla_caches", "none")


_setup_compile_cache()

from raytrace_tpu.io.loader import load_input, save_input, scale_problem  # noqa: E402
from raytrace_tpu.models.ray_tracer import (  # noqa: E402
    create_image, create_image_stream)
from raytrace_tpu.api import calc_ray, calc_ray_path, calc_seed  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "create_image", "create_image_stream",
    "calc_ray", "calc_ray_path", "calc_seed",
    "load_input", "save_input", "scale_problem",
]
