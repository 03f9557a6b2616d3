"""End-to-end harness tests: the CLI mirrors the reference's CreateImage
driver (src/CreateImage.cpp): per-method golden gates, the -scale path that
disables them (CreateImage.cpp:156-160), and the timing-stability gates
(CreateImage.cpp:174-181)."""

import numpy as np
import pytest

from raytrace_tpu import create_image
from raytrace_tpu.io.loader import save_input
from raytrace_tpu.testing import synthetic_problem
from raytrace_tpu.utils import cli
from raytrace_tpu.utils.errors import RayTraceError
from raytrace_tpu.utils.stats import TimingStats, stability_errors


@pytest.fixture(scope="module")
def golden_file(tmp_path_factory):
    """A synthetic .dat with this framework's own output embedded as the
    golden, exactly how production inputs carry theirs."""
    p = synthetic_problem(nx=8, ny=5, na=5, nb=4, nv=6)
    img, ang = create_image(p, "lax")
    p.image = img
    p.I_ang = ang
    path = tmp_path_factory.mktemp("cli") / "synthetic.dat"
    save_input(path, p)
    return str(path)


def test_cli_end_to_end(golden_file, capsys):
    # -iterations=1 keeps the timing-stability gates deterministic (with a
    # warm pipeline cache, multi-iteration CPU timings are pure jitter and
    # the reference's 10%/15% gates trip on noise, not on correctness)
    rc = cli.main(["-methods=lax,lax-exact", "-iterations=1", golden_file])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "All tests passed" in out
    assert "lax-exact" in out  # per-method timing table rows


def test_cli_scale_disables_golden(golden_file, capsys):
    # scaled problems have no matching golden; the harness must still run
    # and pass (the reference skips check_ans when scale != 1)
    rc = cli.main(["-methods=lax", "-iterations=1", "-scale=0.5", golden_file])
    out = capsys.readouterr().out
    assert rc == 0
    assert "All tests passed" in out


def test_cli_unknown_method(golden_file):
    with pytest.raises(RayTraceError, match="Unknown method"):
        cli.main(["-methods=vulkan", "-iterations=1", golden_file])


def test_cli_no_files_usage():
    assert cli.main([]) == 1


def test_stability_gates(capsys):
    # tight timings: no errors
    assert stability_errors(TimingStats.of([1.0, 1.01, 0.99])) == 0
    # large spread trips both the 10% stddev and 15% max gates
    n = stability_errors(TimingStats.of([1.0, 1.0, 2.0]))
    capsys.readouterr()
    assert n == 2


def test_cli_nprocs_process_group():
    """-nprocs=P spawns a local process group (the mpirun analogue): Gloo
    collectives pool timings/errors across ranks and rank 0 prints the
    verdict. Uses the committed fixture so workers need no tmp plumbing."""
    import os
    import subprocess
    import sys

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "golden_ase.dat")
    env = dict(os.environ)
    # the workers inherit JAX_PLATFORMS=cpu (conftest); scrub this
    # process's test-mesh env
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-m", "raytrace_tpu.utils.cli", "-methods=lax",
         "-iterations=1", "-nprocs=2", fixture],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    # the reference's timing-stability gates legitimately count as errors
    # and trip when the test machine is loaded (two ranks, one sample
    # each); this test gates on CORRECTNESS, so golden failures fail it but
    # pure stability-gate errors under load do not
    golden_failed = "Answers do not match" in r.stdout
    stability_only = (r.returncode != 0 and not golden_failed
                      and "Standard deviation" in r.stdout)
    assert not golden_failed, r.stdout + r.stderr
    assert r.returncode == 0 or stability_only, r.stdout + r.stderr
    if r.returncode == 0:
        assert "All tests passed" in r.stdout


def test_cli_default_methods_all_available(golden_file, capsys):
    """No -methods= flag benchmarks every available backend ('Default is
    all availible methods', CreateImageHelpers.h:61) -- and, with more
    than one device present, the mesh-sharded path as well (the reference
    defaults include Cuda-MultiGPU when several GPUs exist)."""
    rc = cli.main(["-iterations=1", golden_file])
    out = capsys.readouterr().out
    # exact line matches: "Running lax" alone is a substring of
    # "Running lax-exact" and would mask the lax backend being dropped
    assert "Running lax-exact\n" in out and "Running lax\n" in out, out
    assert "multichip[8]" in out, out
    assert "Answers do not match" not in out
    assert rc == 0, out


def test_cli_multichip_flag(golden_file, capsys):
    """-multichip runs the mesh-sharded path over the full virtual CPU mesh
    and its result must pass the same golden gate as the serial methods;
    with -stream it also reports the mesh serving-mode row."""
    rc = cli.main(["-methods=lax", "-iterations=1", "-multichip",
                   "-stream=2", golden_file])
    out = capsys.readouterr().out
    assert "multichip[8]" in out, out
    assert "multichip[8]+stream" in out, out
    assert "Answers do not match" not in out
    # rc carries the silent error paths (e.g. non-finite stream outputs
    # increment n_errors without printing) -- it must be checked
    assert rc == 0, out


def test_cli_stream_row(golden_file, capsys):
    """-stream=N adds a "<method>+stream" serving-mode row; the synchronous
    golden gate still runs and passes."""
    rc = cli.main(["-methods=lax", "-iterations=1", "-stream=3", golden_file])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "lax+stream" in out
    assert "All tests passed" in out


def test_cli_reorder_requires_stream():
    with pytest.raises(SystemExit):
        cli.Options(["-reorder", "x.dat"])


def test_cli_reorder_label_reflects_execution(golden_file, capsys):
    """The row says +reorder only when the reorder actually executed: on
    the lax backend the flag is silently inert (no counts signal), so the
    row must stay '+stream' -- a mislabeled row could wrongly justify
    flipping the default the ROADMAP gates on this measurement."""
    rc = cli.main(["-methods=lax", "-iterations=1", "-stream=2", "-reorder",
                   golden_file])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "lax+stream" in out and "+stream+reorder" not in out

    rc = cli.main(["-methods=pallas", "-iterations=1", "-stream=2",
                   "-reorder", golden_file])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "pallas+stream+reorder" in out


def test_time_stream_detailed_accounting(tmp_path, monkeypatch):
    """The stream-row timing helper's accounting identities: per_call =
    round_wall / n_units, round_wall ~= fill + sum(yield_s), one fill +
    n-1 yields per round -- the contract bench.py's steady-state stream
    stats (and their stability gates) are computed against."""
    from raytrace_tpu import testing as T

    # fake unit source: no file IO, three sentinel units per round
    monkeypatch.setattr(T, "perturbed_problems",
                        lambda path, n, salt=0, scale=None: list(range(n)))

    def fake_stream(units):
        for u in units:
            yield u

    per_call, detail = T.time_stream_detailed("ignored", 3, 2, fake_stream)
    assert len(per_call) == 2 and len(detail) == 2
    for pc, d in zip(per_call, detail):
        assert len(d["yield_s"]) == 2  # n_units - 1
        assert d["fill_s"] >= 0 and d["round_wall_s"] >= 0
        recon = d["fill_s"] + sum(d["yield_s"])
        assert abs(recon - d["round_wall_s"]) < 5e-3  # rounding only
        assert abs(pc - d["round_wall_s"] / 3) < 5e-3
