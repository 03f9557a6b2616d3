"""Golden-image validation (SURVEY.md section 4: the reference's real test,
src/CreateImageHelpers.cpp:66-100).

Two tiers:

* **Default (always runs)**: reference-anchored miniature fixtures in
  ``tests/fixtures/`` -- each was validated by the reference C++ binary
  at creation (it recomputed the problem and passed its own 5e-6 gate
  against the embedded golden; tools/make_golden_fixtures.py). Every
  backend of both method families must pass ``check_ans`` against them,
  so a regression in the seeded path or the pallas kernel fails plain
  ``pytest -q``.
* **Full snapshots (RAYTRACE_GOLDEN_TESTS=1)**: the shipped 399k/7.8M-ray
  production problems, minutes on the CPU test mesh. The GPU benchmark
  harness (bench.py) exercises the same gates on every bench run. The
  snapshots are not in the repository; the tier reads them from
  ``snapshots/`` at the repository root once they are.
"""

import os

import numpy as np
import pytest

import raytrace_tpu
from raytrace_tpu import create_image, load_input
from raytrace_tpu.testing import ASE_SNAPSHOT, SEED_SNAPSHOT
from raytrace_tpu.utils.stats import check_ans

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
ASE, SEED = ASE_SNAPSHOT, SEED_SNAPSHOT
run_golden = os.environ.get("RAYTRACE_GOLDEN_TESTS") == "1"


# ---------------------------------------------------------------------------
# default tier: reference-validated fixtures, all backends, both families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["golden_ase.dat", "golden_seed.dat"])
@pytest.mark.parametrize("method", ["lax", "lax-exact", "pallas"])
def test_fixture_golden(fixture, method):
    """Golden gate on the committed fixtures (pallas runs via the
    interpreter on the CPU test mesh -- same kernel semantics)."""
    problem, image0, i_ang0 = load_input(os.path.join(FIXTURES, fixture))
    image, i_ang = create_image(problem, method)
    assert check_ans(image0, i_ang0, image, i_ang)
    # two-sided sanity: the computed fields must actually match, not just
    # the norms
    rel_img = np.linalg.norm(image0 - image) / np.linalg.norm(image0)
    rel_ang = np.linalg.norm(i_ang0 - i_ang) / np.linalg.norm(i_ang0)
    assert rel_img < 1e-5 and rel_ang < 1e-5


def test_fixture_golden_dense_pallas():
    """The pure-reduction (dense) deposit under the pallas backend: chunks
    align to lcm(BLOCK, na*nb) so whole angular blocks land in whole kernel
    blocks. Kept as a tested capability (the deposit the reference's natural-order CPU loop
    collapses to, src/RayTraceImageCPU.cpp:56-68)."""
    problem, image0, i_ang0 = load_input(os.path.join(FIXTURES,
                                                      "golden_ase.dat"))
    image, i_ang = create_image(problem, "pallas", deposit="dense")
    assert check_ans(image0, i_ang0, image, i_ang)


# ---------------------------------------------------------------------------
# full-snapshot tier (env-gated: minutes per case on the CPU test mesh)
# ---------------------------------------------------------------------------

@pytest.mark.skipif(not (run_golden and os.path.exists(ASE)),
                    reason="set RAYTRACE_GOLDEN_TESTS=1")
@pytest.mark.parametrize("method", ["lax", "pallas"])
def test_ase_small_golden(method):
    problem, image0, i_ang0 = load_input(ASE)
    image, i_ang = create_image(problem, method)
    assert check_ans(image0, i_ang0, image, i_ang)
    # two-sided sanity on the near-field image (the far-field golden in the
    # file disagrees with the reference binary itself; see README)
    rel = np.linalg.norm(image0 - image) / np.linalg.norm(image0)
    assert rel < 1e-4


@pytest.mark.skipif(not (run_golden and os.path.exists(SEED)),
                    reason="set RAYTRACE_GOLDEN_TESTS=1")
@pytest.mark.parametrize("method", ["lax", "pallas"])
def test_seed_small_golden(method):
    problem, image0, i_ang0 = load_input(SEED)
    image, i_ang = create_image(problem, method)
    assert check_ans(image0, i_ang0, image, i_ang)
    rel = np.linalg.norm(image0 - image) / np.linalg.norm(image0)
    assert rel < 1e-4
