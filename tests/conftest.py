"""Test configuration: force an 8-device virtual CPU mesh so multi-chip
sharding tests run without several cards (SURVEY.md section 4 test plan
(d)). The platform is set in jax.config before device init; Pallas kernels
then run in interpret mode, and subprocesses the tests start stay on the
CPU too. Tests that need the card carry the ``gpu`` marker and skip here;
``JAX_PLATFORMS=cuda python -m pytest -m gpu`` runs them on a GPU.
"""
import os

if os.environ.get("JAX_PLATFORMS", "") in ("", "cpu"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
