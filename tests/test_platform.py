"""Platform policy: what runs where, decided without a card.

The backend listing, ``auto``, the deposit policy and the kernel's
interpret mode follow ``jax.default_backend()``; here it is monkeypatched
to ``"gpu"`` so the GPU decisions are tested on the CPU. Also: the compile
cache's directory, the ``-nprocs`` workers' card pinning, the production
shapes, and the on-card checks that skip here.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytrace_tpu.models import ray_tracer
from raytrace_tpu.models.ray_tracer import (_resolve_backend,
                                            available_methods,
                                            resolve_bin_deposit)
from raytrace_tpu.ops import pallas_kernel as pk
from raytrace_tpu.testing import (production_problem, synthetic_problem,
                                  time_stream_detailed)
from raytrace_tpu.utils.cli import worker_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_available_methods_lists_pallas_on_gpu(on_gpu):
    assert available_methods() == ["lax-exact", "lax", "pallas"]


def test_available_methods_cpu_has_no_pallas():
    # the kernel would run through the interpreter: not "at speed"
    assert "pallas" not in available_methods()


@pytest.mark.parametrize("platform,want", [("gpu", "pallas"),
                                           ("cpu", "lax")])
def test_auto_backend(monkeypatch, platform, want):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert _resolve_backend("auto", True, True) == want
    # outside the kernel's envelope auto never picks it
    assert _resolve_backend("auto", False, True) == "lax"
    assert _resolve_backend("auto", False, False) == "lax-exact"


@pytest.mark.parametrize("alias", ["cuda", "cuda-multigpu", "kokkos-cuda"])
def test_cuda_aliases_mean_the_kernel(on_gpu, alias):
    assert _resolve_backend(alias, True, True) == "pallas"
    p = synthetic_problem()
    assert ray_tracer.resolve_method(p, alias) == "pallas"


def test_bin_deposit_policy_on_gpu(on_gpu):
    """auto is the segment_sum scatter (no platform branch); the one-hot
    matrix-product deposit runs only when asked for."""
    assert resolve_bin_deposit("auto") == "scatter"
    assert resolve_bin_deposit("matmul") == "matmul"
    with pytest.raises(Exception):
        resolve_bin_deposit("mxu")
    # and a seeded pallas call on the GPU builds the scatter pipeline
    p = synthetic_problem(seeded=True)
    prep = ray_tracer.prepare_pipeline(p, "pallas")
    assert prep.cfg["bin_deposit"] == "scatter"


@pytest.mark.parametrize("platform,want", [("cpu", True), ("gpu", False),
                                           ("metal", None), ("rocm", None)])
def test_interpret_default(monkeypatch, platform, want):
    """Interpret mode is the CPU test mode, compiled Triton the GPU's;
    any other platform has no lowering and raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if want is None:
        with pytest.raises(RuntimeError, match="no lowering"):
            pk.interpret_default()
    else:
        assert pk.interpret_default() is want


def test_trace_rays_rejects_single_segment():
    p = synthetic_problem(N=3)
    pg = pk.pack_gain_tables(p.gain, True)
    rays = {k: jnp.zeros(4, jnp.float32) for k in "xyab"}
    with pytest.raises(ValueError):
        pk.trace_rays(rays, 1, 0.05, pg, 1)


_CACHE_PROBE = ("import json, jax, raytrace_tpu; print(json.dumps("
                "[jax.config.jax_compilation_cache_dir, "
                "jax.config.jax_persistent_cache_enable_xla_caches, "
                "raytrace_tpu.DEFAULT_CACHE_DIR]))")


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and the package sets no other
    directory; unset, the cache is the fixed <repo>/.jax_cache. On the CPU
    platform XLA's own (host-machine-code) caches stay off."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    cache_dir, xla_caches, default = json.loads(out.stdout.splitlines()[-1])
    assert default == os.path.join(REPO, ".jax_cache")
    assert cache_dir == (str(tmp_path) if env_dir else default)
    assert xla_caches == "none"


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_nprocs_worker_pins_one_card(rank):
    env = worker_env({"PATH": "/bin"}, rank, 4, 4321)
    assert env["CUDA_VISIBLE_DEVICES"] == str(rank)
    assert env["RAYTRACE_PROC_ID"] == str(rank)
    assert env["RAYTRACE_NPROCS"] == "4"
    assert env["RAYTRACE_COORD"] == "localhost:4321"
    # an inherited card list: rank r takes its r-th entry
    env = worker_env({"CUDA_VISIBLE_DEVICES": "4,5,6,7"}, rank, 4, 1)
    assert env["CUDA_VISIBLE_DEVICES"] == "4,5,6,7".split(",")[rank]


def test_nprocs_worker_env_cpu_group_and_too_few_cards():
    env = worker_env({"JAX_PLATFORMS": "cpu"}, 1, 2, 1)
    assert "CUDA_VISIBLE_DEVICES" not in env
    assert env["JAX_PLATFORMS"] == "cpu"
    with pytest.raises(SystemExit):
        worker_env({"CUDA_VISIBLE_DEVICES": "0,1"}, 2, 3, 1)


@pytest.mark.parametrize("kind,rays,nv,seed_dims", [
    ("ase", 399_000, 52, None),
    ("seed", 7_803_000, 82, (120, 25, 51, 51))])
def test_production_problem_shapes(kind, rays, nv, seed_dims):
    p = production_problem(kind, 0)
    b = p.euv_beam
    assert (b.nx, b.ny, b.na, b.nb, b.nv) == (60, 25, 19, 14, nv)
    assert p.N == 3 and len(p.gain) == 3
    assert all((g.Nx, g.Ny) == (106, 26) for g in p.gain)
    assert b.y[0] >= 0  # half-plane: the y mirror is on
    src = p.seed_beam if kind == "seed" else b
    assert src.nx * src.ny * src.na * src.nb == rays
    if seed_dims:
        assert (src.nx, src.ny, src.na, src.nb) == seed_dims
        assert all(len(x) == 251 for x in p.seed.x[:4])
    else:
        assert p.seed is None
    # the kernel and the lax backend both cover it
    assert ray_tracer.resolve_method(p, "pallas") == "pallas"
    assert ray_tracer.resolve_method(p, "lax") == "lax"
    # generated from the seed: same seed, same tables; another, others
    again = production_problem(kind, 0)
    assert np.array_equal(again.gain[1].g0, p.gain[1].g0)
    other = production_problem(kind, 1)
    assert not np.array_equal(other.gain[1].g0, p.gain[1].g0)


def test_production_problem_unknown_kind():
    with pytest.raises(ValueError):
        production_problem("medium")


def test_time_stream_detailed_empty():
    with pytest.raises(ValueError):
        time_stream_detailed(lambda n, salt: [], 0, 1, iter)
    with pytest.raises(ValueError, match="no result"):
        time_stream_detailed(lambda n, salt: [None] * n, 2, 1,
                             lambda units: iter(()))


def test_chip_smoke_needs_a_gpu(capsys):
    """Without a card the smoke test fails at its device phase and prints
    no result line."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert "no GPU" in out and '"ok"' not in out


def test_bench_needs_a_gpu():
    out = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs a GPU" in out.stdout


@pytest.fixture
def card():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (chip_smoke.py runs these checks on the "
                    "card)")


@pytest.mark.gpu
def test_kernel_compiled_matches_lax_on_card(card):
    """On the card: the compiled Triton kernel against the lax backend on
    the reference-validated ASE fixture."""
    from raytrace_tpu import create_image, load_input

    fixture = os.path.join(REPO, "tests", "fixtures", "golden_ase.dat")
    p, _, _ = load_input(fixture)
    assert not pk.interpret_default()
    img_k, ang_k = create_image(p, "pallas")
    p, _, _ = load_input(fixture)
    img_l, ang_l = create_image(p, "lax")
    assert np.linalg.norm(img_k - img_l) / np.linalg.norm(img_l) < 1e-5
    assert np.linalg.norm(ang_k - ang_l) / np.linalg.norm(ang_l) < 1e-5


def test_chip_smoke_reads_one_card_per_rank():
    """The -nprocs check of chip_smoke.py reads the ranks' device lines even
    when they run together on the shared pipe."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    out = ("rank 3/4: gpu x1 NVIDIA H100 CUDA_VISIBLE_DEVICES=3\n"
           "rank 1/4: gpu x1 NVIDIA H100 CUDA_VISIBLE_DEVICES=1"
           "rank 2/4: gpu x1 NVIDIA H100 CUDA_VISIBLE_DEVICES=2\n"
           "Running pallas\nrank 0/4: gpu x1 NVIDIA H100 "
           "CUDA_VISIBLE_DEVICES=0\n")
    ranks = chip_smoke.rank_devices(out)
    assert sorted(ranks) == [(r, "gpu", 1, str(r)) for r in range(4)]
    assert chip_smoke.one_card_each(ranks, 4)
    assert not chip_smoke.one_card_each(ranks[:3], 4)
    shared = [(r, "gpu", 1, "0") for r in range(4)]
    assert not chip_smoke.one_card_each(shared, 4)
    on_cpu = chip_smoke.rank_devices(
        "rank 0/2: cpu x8 cpu CUDA_VISIBLE_DEVICES=\n"
        "rank 1/2: cpu x8 cpu CUDA_VISIBLE_DEVICES=\n")
    assert not chip_smoke.one_card_each(on_cpu, 2)
