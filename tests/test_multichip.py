"""Multi-chip sharding correctness on the virtual 8-device CPU mesh
(SURVEY.md section 4 test plan (d)).

Two tiers, like test_golden.py: synthetic-problem checks always run; the
shipped production snapshots (399k/780k rays through the sharded pipeline,
~1 min each on the timeshared CPU mesh) are gated behind
``RAYTRACE_GOLDEN_TESTS=1``."""

import os

import numpy as np
import pytest

import raytrace_tpu  # noqa: F401
import jax

from raytrace_tpu import create_image, load_input
from raytrace_tpu.parallel import collectives
from raytrace_tpu.parallel.mesh import make_mesh
from raytrace_tpu.parallel.sharding import create_image_sharded
from raytrace_tpu.structures import IntensityStep
from raytrace_tpu.testing import (ASE_SNAPSHOT as ASE, SEED_SNAPSHOT as SEED,
                                  synthetic_problem)
from raytrace_tpu.utils.stats import check_ans

run_golden = os.environ.get("RAYTRACE_GOLDEN_TESTS") == "1"

needs_mesh = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@needs_mesh
@pytest.mark.parametrize("seeded", [False, True])
def test_sharded_matches_single(seeded):
    p1 = synthetic_problem(seeded=seeded)
    img1, ang1 = create_image(p1, "lax")
    mesh = make_mesh(8)
    p8 = synthetic_problem(seeded=seeded)
    img8, ang8 = create_image_sharded(p8, mesh, "lax")
    # deposits run in float32 per shard (dense path on single device vs
    # scatter on the mesh), so agreement is at f32 summation level
    assert np.linalg.norm(img1 - img8) / np.linalg.norm(img1) < 2e-6
    assert np.linalg.norm(ang1 - ang8) / np.linalg.norm(ang1) < 2e-6


@needs_mesh
@pytest.mark.parametrize("seeded", [False, True])
def test_sharded_pallas_matches_single(seeded):
    """The fastest backend runs per shard (no silent lax downgrade) -- the
    reference's multi-GPU path likewise drives its CUDA kernel per device
    (src/RayTraceImage.cpp:396-405). On the CPU the kernel executes via the
    Pallas interpreter."""
    p1 = synthetic_problem(seeded=seeded)
    img1, ang1 = create_image(p1, "lax")
    mesh = make_mesh(8)
    p8 = synthetic_problem(seeded=seeded)
    img8, ang8 = create_image_sharded(p8, mesh, "pallas")
    assert np.linalg.norm(img1 - img8) / np.linalg.norm(img1) < 2e-6
    assert np.linalg.norm(ang1 - ang8) / np.linalg.norm(ang1) < 2e-6


@needs_mesh
def test_sharded_deposit_parity():
    """The deposit-strategy knob reaches the sharded pipeline with the same
    semantics as single-chip (the reference's multi-GPU path drives the
    same fastest kernel per device, src/RayTraceImage.cpp:396-405): the one-hot
    matmul deposit and the scatter deposit must agree on the mesh."""
    mesh = make_mesh(8)
    ps = synthetic_problem(seeded=True)
    img_s, ang_s = create_image_sharded(ps, mesh, "lax", deposit="scatter")
    pm = synthetic_problem(seeded=True)
    img_m, ang_m = create_image_sharded(pm, mesh, "lax", deposit="matmul")
    assert np.linalg.norm(img_s - img_m) / np.linalg.norm(img_s) < 2e-6
    assert np.linalg.norm(ang_s - ang_m) / np.linalg.norm(ang_s) < 2e-6


@needs_mesh
def test_sharded_auto_deposit_matches_single_chip_policy():
    """create_image_sharded resolves 'auto' through the exact same policy
    function as create_image -- config parity by construction."""
    from raytrace_tpu.models.ray_tracer import resolve_bin_deposit
    assert resolve_bin_deposit("auto") in ("matmul", "scatter")
    # explicit strategies pass through; 'dense' maps to scatter (the dense
    # row layout requires natural-order full coverage, not stride shards)
    assert resolve_bin_deposit("matmul") == "matmul"
    assert resolve_bin_deposit("dense") == "scatter"


@needs_mesh
def test_sharded_nontrivial_stride_partition():
    """Rank-stride x device-stride nesting: the P-way N_start/N_parallel
    partition of the rays, each part computed through the sharded pipeline
    (device stride nested inside the rank stride), must sum to the full
    image (src/RayTraceImage.cpp:300-328 contract)."""
    mesh = make_mesh(8)
    p_full = synthetic_problem(seeded=True)
    img_full, ang_full = create_image_sharded(p_full, mesh, "lax")
    P = 3
    img_sum = np.zeros_like(img_full)
    ang_sum = np.zeros_like(ang_full)
    for k in range(P):
        pk = synthetic_problem(seeded=True)
        pk.N_start, pk.N_parallel = k, P
        img_k, ang_k = create_image_sharded(pk, mesh, "lax")
        img_sum += img_k
        ang_sum += ang_k
    assert np.linalg.norm(img_full - img_sum) / np.linalg.norm(img_full) < 2e-6
    assert np.linalg.norm(ang_full - ang_sum) / np.linalg.norm(ang_full) < 2e-6


@needs_mesh
def test_sharded_nonuniform_gain_pallas():
    """Non-uniform gain grids through the sharded pallas path: the
    findindex-bisection kernel variant must shard exactly like the
    uniform one (same fits_pallas envelope feeds both resolutions)."""
    p1 = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5,
                           non_uniform_gain=0.5)
    img1, ang1 = create_image(p1, "lax-exact")
    mesh = make_mesh(8)
    p8 = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5,
                           non_uniform_gain=0.5)
    img8, ang8 = create_image_sharded(p8, mesh, "pallas", chunk_size=4096)
    assert np.linalg.norm(img1 - img8) / np.linalg.norm(img1) < 2e-3


@needs_mesh
def test_sharded_mesh_sizes():
    """Any mesh size (including 1 = the no-MPI shim analogue) gives the
    same images."""
    ref_img = None
    for n in (1, 2, 4):
        p = synthetic_problem()
        mesh = make_mesh(n)
        img, _ = create_image_sharded(p, mesh, "lax")
        if ref_img is None:
            ref_img = img
        else:
            assert np.linalg.norm(img - ref_img) / np.linalg.norm(ref_img) < 2e-6


def test_gather_all_identity_without_mesh():
    # single-process: one rank row holding this rank's values (no-MPI shim)
    out = collectives.gather_all([1.0, 2.0], None)
    assert out.shape == (1, 2) and np.array_equal(out[0], [1.0, 2.0])


def test_intensity_step_sum_reduce_no_mesh():
    step = IntensityStep().initialize(4, 3, 2, 2, 5, 1)
    step.image[:] = 1.0
    step.sum_reduce()  # single host: identity
    assert np.all(step.image == 1.0)
    assert step.valid()
    step.E_v[0] = -1.0
    assert not step.valid()


# ---------------------------------------------------------------------------
# production-snapshot tier (env-gated: ~1 min per case on the CPU mesh)
# ---------------------------------------------------------------------------

@pytest.mark.skipif(not (run_golden and os.path.exists(ASE)),
                    reason="set RAYTRACE_GOLDEN_TESTS=1")
def test_ase_small_sharded_golden():
    """The real shipped ASE snapshot through the full sharded pipeline on
    the 8-device mesh, judged by the reference's own embedded golden gate
    (check_ans, src/CreateImageHelpers.cpp:66-100) -- multi-chip
    correctness at production scale, not toy shapes."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8)
    problem, image0, i_ang0 = load_input(ASE)
    image, i_ang = create_image_sharded(problem, mesh, "lax")
    assert check_ans(image0, i_ang0, image, i_ang)
    rel = np.linalg.norm(image0 - image) / np.linalg.norm(image0)
    assert rel < 1e-4


@pytest.mark.skipif(not (run_golden and os.path.exists(ASE)),
                    reason="set RAYTRACE_GOLDEN_TESTS=1")
def test_ase_small_sharded_stride_partition_golden():
    """Nontrivial rank stride at production scale: the 3-way
    N_start/N_parallel partition of ASE_small, each part through the
    sharded pipeline (device stride nested inside rank stride), must sum
    to an image passing the embedded golden gate."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8)
    _, image0, i_ang0 = load_input(ASE)
    P = 3
    img_sum = ang_sum = None
    for k in range(P):
        pk, _, _ = load_input(ASE)
        pk.N_start, pk.N_parallel = k, P
        img_k, ang_k = create_image_sharded(pk, mesh, "lax")
        img_sum = img_k if img_sum is None else img_sum + img_k
        ang_sum = ang_k if ang_sum is None else ang_sum + ang_k
    assert check_ans(image0, i_ang0, img_sum, ang_sum)


@pytest.mark.skipif(not (run_golden and os.path.exists(SEED)),
                    reason="set RAYTRACE_GOLDEN_TESTS=1")
def test_seed_small_sharded_reduced_scale():
    """The seeded snapshot at -scale=0.1 (~780k rays; full 7.8M is too slow
    for the timeshared CPU mesh) through the sharded pipeline. No embedded
    golden exists at scale != 1 (CreateImage.cpp:156-160), so the gate is
    cross-config: the single-device image is the golden for the sharded one
    under the same one-sided 5e-6 norm check."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from raytrace_tpu.io.loader import scale_problem

    mesh = make_mesh(8)
    p1, _, _ = load_input(SEED)
    scale_problem(p1, 0.1)
    img1, ang1 = create_image(p1, "lax")
    p8, _, _ = load_input(SEED)
    scale_problem(p8, 0.1)
    img8, ang8 = create_image_sharded(p8, mesh, "lax")
    assert check_ans(img1, ang1, img8, ang8)


def test_sharded_split_upload_matches_one_dispatch(monkeypatch):
    """The two-dispatch sharded pipeline (gv upload overlapping the trace,
    make_sharded_split_pipeline) must engage on ASE-class calls and
    produce bitwise-identical images to the one-dispatch pipeline -- the
    split moves the gv transfer, not the math."""
    from raytrace_tpu.parallel.sharding import prepare_sharded

    mesh = make_mesh(min(8, len(jax.devices())))
    p = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5, rng=77)
    prep = prepare_sharded(p, mesh, "lax", chunk_size=2048)
    assert prep.cfg["split"], "ASE-class sharded call should take the split"
    img_s, ang_s = create_image_sharded(
        synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5, rng=77), mesh,
        "lax", chunk_size=2048)
    monkeypatch.setenv("RAYTRACE_NO_SPLIT", "1")
    p1 = synthetic_problem(nx=6, ny=4, na=4, nb=3, nv=5, rng=77)
    prep1 = prepare_sharded(p1, mesh, "lax", chunk_size=2048)
    assert not prep1.cfg["split"]
    img_1, ang_1 = create_image_sharded(p1, mesh, "lax", chunk_size=2048)
    assert np.array_equal(img_s, img_1)
    assert np.array_equal(ang_s, ang_1)


@pytest.mark.skipif(not (run_golden and os.path.exists(SEED)),
                    reason="set RAYTRACE_GOLDEN_TESTS=1")
def test_seed_scaled_sharded_matches_single():
    """The seed_medium proxy (seed_small at -scale=4, ~30.7M-ray geometry;
    Readme.txt:47-49, src/CreateImageHelpers.cpp:104-150) through the
    sharded pipeline on the CPU mesh. The full ray count is a GPU
    measurement (bench.py's seed_scale4_* row); here the stride contract
    (N_parallel) computes every 997th ray of the SCALED geometry -- the
    production sharding mechanism itself -- so the scaled grids, seed
    tables and deposits all run at that scale while the CPU does ~31k
    rays. Gate: the single-device image is the golden for the sharded one
    under the reference's one-sided 5e-6 norm check."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from raytrace_tpu.io.loader import scale_problem

    mesh = make_mesh(8)
    p1, _, _ = load_input(SEED)
    scale_problem(p1, 4.0)
    p1.N_start, p1.N_parallel = 5, 997
    img1, ang1 = create_image(p1, "lax")
    p8, _, _ = load_input(SEED)
    scale_problem(p8, 4.0)
    p8.N_start, p8.N_parallel = 5, 997
    img8, ang8 = create_image_sharded(p8, mesh, "lax")
    assert check_ans(img1, ang1, img8, ang8)
    rel = np.linalg.norm(img1 - img8) / max(np.linalg.norm(img1), 1e-300)
    assert rel < 1e-4


def test_dryrun_multichip_entry():
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import importlib
    graft = importlib.import_module("__graft_entry__")
    if len(jax.devices()) >= 8:
        graft.dryrun_multichip(8)
    fn, args = graft.entry()
    img, ang = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(img)))


@needs_mesh
def test_sharded_stream_matches_per_call():
    """create_image_stream(mesh=...) is serving mode over the whole mesh:
    it must reproduce per-call create_image_sharded bitwise, in order,
    including a mixed ASE/seeded sequence."""
    from raytrace_tpu import create_image_stream

    mesh = make_mesh(8)

    def make(i):
        return synthetic_problem(nx=5, ny=4, na=3, nb=3, nv=4,
                                 seeded=i % 2 == 1, rng=300 + i)

    want = []
    for i in range(3):
        p = make(i)
        want.append(create_image_sharded(p, mesh, "lax", chunk_size=2048))

    probs = [make(i) for i in range(3)]
    got = list(create_image_stream(probs, "lax", chunk_size=2048, mesh=mesh))
    assert len(got) == 3
    for i, ((gi, ga), (wi, wa)) in enumerate(zip(got, want)):
        assert np.array_equal(gi, wi), i
        assert np.array_equal(ga, wa), i
        assert np.array_equal(probs[i].image, wi)
        assert np.array_equal(probs[i].I_ang, wa)
