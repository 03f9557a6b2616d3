"""Distributed-collectives tests (SURVEY.md section 2.4 P5/P6).

Two tiers:

* single-process: the no-MPI shim behavior (identity, MPI_helpers.h:41-52)
  and the device-level mesh all_gather on the virtual 8-CPU mesh;
* multi-process: a real 2-process CPU "cluster" (jax.distributed + Gloo)
  running tools/run_distributed.py on both ranks -- gather_all returns both
  ranks' distinct values, sum_scalar/host_sum_arrays reduce across
  processes, and the sharded-pipeline image psum spans processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from raytrace_tpu.parallel import collectives, distributed
from raytrace_tpu.parallel.mesh import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_single_process_shims():
    """Without a process group every rank collective is the identity."""
    assert distributed.rank() == 0
    assert distributed.size() == 1
    assert distributed.process_mesh() is None
    g = collectives.gather_all(np.array([1.5, 2.5]))
    assert g.shape == (1, 2) and np.allclose(g[0], [1.5, 2.5])
    assert collectives.sum_scalar(7) == 7
    arrs = [np.arange(3.0), np.ones((2, 2))]
    out = collectives.host_sum_arrays(arrs)
    assert all(np.array_equal(a, b) for a, b in zip(arrs, out))
    distributed.barrier()  # no-op


def test_mesh_all_gather_devices():
    """Device-level all_gather over the virtual mesh: every row arrives."""
    mesh = make_mesh(8)
    per_dev = np.arange(8.0)[:, None] * 10 + np.arange(3.0)[None, :]
    out = collectives.mesh_all_gather(per_dev, mesh)
    assert out.shape == (8, 3)
    assert np.allclose(out, per_dev)
    # 1-device mesh degrades to identity (the serial shim)
    m1 = make_mesh(1)
    one = np.array([[4.0, 5.0]])
    assert np.allclose(collectives.mesh_all_gather(one, m1), one)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_import_does_not_init_backend():
    """Importing the package must not initialize an XLA backend:
    jax.distributed.initialize() (the MPI_Init analogue) requires a cold
    runtime, so module-level jnp constants are a regression (they once broke
    the 2-process harness via spectrum.py)."""
    code = (
        "import raytrace_tpu\n"
        "from raytrace_tpu.parallel import sharding, distributed\n"
        "from raytrace_tpu.testing import synthetic_problem\n"
        "import jax._src.xla_bridge as xb\n"
        "import sys\n"
        "sys.exit(0 if not xb._backends else 3)\n"
    )
    env = dict(os.environ)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.slow
def test_two_process_collectives():
    """Real cross-process communication: 2 JAX processes on CPU."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "run_distributed.py"),
             str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=REPO, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out}"
        assert f"RESULT[{pid}] ALL_PASS" in out, out
        assert "FAIL" not in out, out


@pytest.mark.slow
def test_production_loop_two_process_matches_single():
    """The full-app iteration contract (tools/production_loop.py): each
    rank computes its ray stride, IntensityStep::sum_reduce spans the
    process group, and the reduced per-step energy must equal the
    single-process value (the stride partition covers the same rays)."""
    import re

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # both sides on CPU: the f32 trace differs per platform at ulp level,
    # which amplification turns into ~1e-7 -- not what this test gates on
    env["JAX_PLATFORMS"] = "cpu"

    def esums(text):
        return [float(m) for m in re.findall(r"E_sum=([0-9.e+-]+)", text)]

    r1 = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "production_loop.py")],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    ref = esums(r1.stdout)
    assert len(ref) == 2 and all(v > 0 for v in ref)

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tools", "production_loop.py"),
             str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=REPO, text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    assert all(p.returncode == 0 for p in procs), outs[0] + outs[1]
    got = esums(outs[0])  # rank 0 prints (pio gates rank > 0)
    assert len(got) == 2
    for a, b in zip(ref, got):
        assert abs(a - b) / a < 1e-10, (ref, got)
