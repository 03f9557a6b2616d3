"""Cost-feedback ray reorder (create_image_stream(reorder=True)).

The serving-mode lever from the micro-step census (ROADMAP.md): per-ray
trace cost is invariant under production-style table perturbation, so a
stream sorts call k's rays by (entry fetch row, call k-1's measured
per-lane micro-step count) -- ray_tracer.reorder_perm (tools/bench_reorder.py
measures it). These tests pin the plumbing on the CPU interpreter:
the permutation math, the counts round trip, and that the reordered
executor reproduces the synchronous images (up to f64 scatter-add
reassociation -- the documented non-bitwise trade, SURVEY.md section 5).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from raytrace_tpu import create_image
from raytrace_tpu.models import ray_tracer
from raytrace_tpu.models.ray_tracer import (_window_perm, create_image_stream,
                                            prepare_pipeline)
from raytrace_tpu.testing import synthetic_problem


def test_window_perm_sorts_within_windows():
    rng = np.random.default_rng(3)
    costs = rng.integers(0, 1000, size=20).astype(np.int32)
    w = 8
    perm = np.asarray(_window_perm(jnp.asarray(costs), w))
    # a true permutation of range(n)
    assert sorted(perm.tolist()) == list(range(20))
    # window-local: each window maps to itself...
    for lo in range(0, 20, w):
        hi = min(lo + w, 20)
        block = perm[lo:hi]
        assert set(block.tolist()) == set(range(lo, hi))
        # ...and is cost-sorted (the ragged tail too: int32-max sentinels
        # sort strictly after every real count)
        assert np.all(np.diff(costs[block]) >= 0)


def test_window_perm_identity_on_uniform_costs():
    # stable argsort: the stream's first call (all-zero feedback) must run
    # in natural order
    perm = np.asarray(_window_perm(jnp.zeros(24, jnp.int32), 8))
    assert np.array_equal(perm, np.arange(24))


def test_reorder_perm_groups_rows_then_sorts_cost():
    """The production sort key (reorder_perm): stable argsort by (entry
    fetch row k2, cost). Constructed so no entry y sits near a cell
    boundary (the row id is a heuristic, but the test should be exact)."""
    dims = (4, 3, 2, 2)  # nx, ny, na, nb -> 48 rays
    n = 4 * 3 * 2 * 2
    # gain rows: y0=0.0, dy=1.0, rows 0..2 -> entry y 0.4/1.4/2.4 map to
    # rows 0/1/2 (ceil(y-eff/dy)-1 with clip)
    cfg = dict(dims=dims, reorder_row=(0.0, 1.0, 2))
    gy = jnp.asarray([0.4, 1.4, 2.4])
    ray_grids = (jnp.zeros(4), gy, jnp.zeros(2), jnp.zeros(2))
    ijkm = jnp.arange(n, dtype=jnp.int64)
    rng = np.random.default_rng(9)
    costs = rng.integers(1, 300, size=n).astype(np.int32)
    perm = np.asarray(ray_tracer.reorder_perm(cfg, jnp.asarray(costs), ijkm,
                                              ray_grids))
    assert sorted(perm.tolist()) == list(range(n))
    j = (np.arange(n) // 4) % 3  # b-fastest unflatten: j = (ijkm//(na*nb))%ny
    k2 = j  # rows land 1:1 by construction
    assert np.all(np.diff(k2[perm]) >= 0), "primary key: fetch row"
    for row in range(3):
        sel = perm[k2[perm] == row]
        assert np.all(np.diff(costs[sel]) >= 0), "secondary key: cost"
    # all-zero feedback (a stream's first call) keeps NATURAL order
    perm0 = np.asarray(ray_tracer.reorder_perm(
        cfg, jnp.zeros(n, jnp.int32), ijkm, ray_grids))
    assert np.array_equal(perm0, np.arange(n))
    # no row geometry -> window-local fallback (the _window_perm contract)
    cfg_nr = dict(cfg, reorder_row=None)
    pf = np.asarray(ray_tracer.reorder_perm(cfg_nr, jnp.asarray(costs), ijkm,
                                            ray_grids))
    assert np.array_equal(pf, np.asarray(_window_perm(jnp.asarray(costs),
                                                      min(8 * 1024, n))))


def _reorder_prep(p, **kw):
    prep = prepare_pipeline(p, "pallas", chunk_size=2048, reorder=True, **kw)
    assert prep.cfg["reorder"], "pallas problem should build the reorder pipeline"
    return prep


def test_reorder_pipeline_it_follows_feedback_perm():
    """Feed a synthetic cost pattern and check the pipeline really processes
    stride indices in reorder_perm's (fetch row, cost) order, with this
    call's counts scattered back to natural positions (the next call's
    key)."""
    p = synthetic_problem(nx=8, ny=5, na=5, nb=4, nv=6)
    prep = _reorder_prep(p)
    cfg = prep.cfg
    assert cfg["reorder_row"] is not None
    n_chunks, chunk = cfg["n_chunks"], cfg["chunk"]
    rng = np.random.default_rng(11)
    pc = rng.integers(0, 500, size=(n_chunks, chunk)).astype(np.int32)
    outs = prep.pipeline(*prep.operands, jnp.asarray(pc))
    assert len(outs) == 6
    counts, it_all = np.asarray(outs[4]), np.asarray(outs[5])
    src = p.euv_beam
    ray_grids = tuple(jnp.asarray(np.asarray(g)) for g in
                      (src.x, src.y, src.a, src.b))
    for ci in range(n_chunks):
        it = it_all[ci]
        # every chunk still covers exactly its natural stride indices
        assert sorted(it.tolist()) == list(range(ci * chunk,
                                                 (ci + 1) * chunk))
        # ... visited in exactly the library's published permutation
        # (padding positions clamp to ray 0, like the pipeline's stride map)
        raw = np.arange(ci * chunk, (ci + 1) * chunk)
        nt = int(np.prod(cfg["dims"]))
        ijkm_nat = jnp.asarray(np.where(raw < nt, raw, 0), jnp.int64)
        want = np.asarray(ray_tracer.reorder_perm(
            cfg, jnp.asarray(pc[ci]), ijkm_nat, ray_grids))
        assert np.array_equal(it - ci * chunk, want)
    # the counts output is in NATURAL order: re-running with it as feedback
    # must sort positions by it, and real traces take >= 1 micro-step
    assert counts.shape == (n_chunks, chunk)
    assert counts.min() >= 1


#: the reordered deposits reassociate the per-chunk f32 scatter adds
#: (ops/binning.py:126); measured ~5e-8 relative on these synthetics, and
#: the documented bound is ~3e-7 at 500k-ray chunks -- well under the
#: reference's 5e-6 golden gate, which is the semantic contract here
_REASSOC_TOL = 2e-6


def _distinct_units(n, salt, **kw):
    """n same-shape work units with genuinely distinct gain tables (the
    serving-mode shape: production perturbs the tables every iteration)."""
    units = []
    for i in range(n):
        p = synthetic_problem(**kw)
        f = np.float32(1.0 + 1e-3 * (salt + i))
        for g in p.gain:
            g.g0 = (np.asarray(g.g0, np.float32) * f).astype(np.float32)
        units.append(p)
    return units


def test_stream_reorder_matches_sync():
    """Reordered serving results == synchronous results up to f32
    deposit reassociation (well below the 5e-6 golden gate)."""
    kw = dict(nx=8, ny=5, na=5, nb=4, nv=6)
    units = _distinct_units(3, 1, **kw)
    want = [create_image(p, "pallas", chunk_size=2048)
            for p in _distinct_units(3, 1, **kw)]
    got = list(create_image_stream(units, "pallas", chunk_size=2048,
                                   reorder=True))
    assert len(got) == len(want)
    # first call = natural order (all-zero feedback): bitwise identical
    assert np.array_equal(got[0][0], want[0][0])
    assert np.array_equal(got[0][1], want[0][1])
    for (gi, ga), (wi, wa) in zip(got, want):
        assert (np.linalg.norm(gi - wi)
                <= _REASSOC_TOL * max(np.linalg.norm(wi), 1e-300))
        assert (np.linalg.norm(ga - wa)
                <= _REASSOC_TOL * max(np.linalg.norm(wa), 1e-300))


def test_stream_reorder_seeded_matches_sync():
    kw = dict(nx=8, ny=5, na=5, nb=4, nv=6, seeded=True)
    units = _distinct_units(2, 7, **kw)
    want = [create_image(p, "pallas", chunk_size=2048)
            for p in _distinct_units(2, 7, **kw)]
    got = list(create_image_stream(units, "pallas", chunk_size=2048,
                                   reorder=True))
    for (gi, ga), (wi, wa) in zip(got, want):
        assert (np.linalg.norm(gi - wi)
                <= _REASSOC_TOL * max(np.linalg.norm(wi), 1e-300))
        assert (np.linalg.norm(ga - wa)
                <= _REASSOC_TOL * max(np.linalg.norm(wa), 1e-300))


def test_stream_reorder_row_free_fallback_e2e(monkeypatch):
    """End-to-end drive of the ROW-FREE reorder fallback: when a problem
    has no readable fetch-row geometry (reorder_row_geom -> None), the
    stream must run the window-local cost sort (_window_perm) instead of
    the (row, cost) key -- and still reproduce the synchronous images.
    No shipped geometry is row-free (every valid gain grid has Ny >= 2),
    so the trigger is simulated by patching reorder_row_geom; everything
    downstream of the trigger -- pipeline build, permuted trace, counts
    round trip, deposits -- is the real path."""
    monkeypatch.setattr(ray_tracer, "reorder_row_geom", lambda p: None)
    kw = dict(nx=8, ny=5, na=5, nb=4, nv=6)
    prep = prepare_pipeline(synthetic_problem(**kw), "pallas",
                            chunk_size=2048, reorder=True)
    assert prep.cfg["reorder"] and prep.cfg["reorder_row"] is None
    # the permuted `it` output follows the window-local sort exactly
    cfg = prep.cfg
    n_chunks, chunk = cfg["n_chunks"], cfg["chunk"]
    rng = np.random.default_rng(13)
    pc = rng.integers(0, 500, size=(n_chunks, chunk)).astype(np.int32)
    outs = prep.pipeline(*prep.operands, jnp.asarray(pc))
    it_all = np.asarray(outs[5])
    w = min(ray_tracer._REORDER_WINDOW, chunk)
    for ci in range(n_chunks):
        want = np.asarray(_window_perm(jnp.asarray(pc[ci]), w))
        assert np.array_equal(it_all[ci] - ci * chunk, want)
    # full serving drive: reordered results == synchronous results up to
    # deposit reassociation (the documented non-bitwise trade)
    units = _distinct_units(3, 21, **kw)
    want_im = [create_image(p, "pallas", chunk_size=2048)
               for p in _distinct_units(3, 21, **kw)]
    got = list(create_image_stream(units, "pallas", chunk_size=2048,
                                   reorder=True))
    assert np.array_equal(got[0][0], want_im[0][0])  # first call: natural
    for (gi, ga), (wi, wa) in zip(got, want_im):
        assert (np.linalg.norm(gi - wi)
                <= _REASSOC_TOL * max(np.linalg.norm(wi), 1e-300))
        assert (np.linalg.norm(ga - wa)
                <= _REASSOC_TOL * max(np.linalg.norm(wa), 1e-300))


def test_reorder_falls_back_off_pallas():
    """Off the pallas envelope there is no counts signal: the flag must be
    silently off (same policy as the backend envelope fallbacks), and the
    stream must still work."""
    p = synthetic_problem(nx=5, ny=3, na=4, nb=3, nv=5)
    prep = prepare_pipeline(p, "lax", reorder=True)
    assert not prep.cfg["reorder"]
    outs = list(create_image_stream(
        [synthetic_problem(rng=7, nx=5, ny=3, na=4, nb=3, nv=5)], "lax",
        reorder=True))
    assert len(outs) == 1 and np.isfinite(outs[0][0]).all()


def test_sharded_reorder_it_follows_feedback_perm_per_device():
    """The sharded feedback plumbing is position-exact: device d's block of
    the global prev_counts drives device d's own sort (a transposed spec or
    misaligned scatter would still pass the image gates -- deposits are
    permutation-invariant -- so this checks the it output directly)."""
    import jax

    from raytrace_tpu.parallel.mesh import make_mesh
    from raytrace_tpu.parallel.sharding import prepare_sharded

    D = min(8, len(jax.devices()))
    mesh = make_mesh(D)
    p = synthetic_problem(nx=8, ny=5, na=5, nb=4, nv=6)
    prep = prepare_sharded(p, mesh, "pallas", chunk_size=4096, reorder=True)
    assert prep.cfg["reorder"]
    n_chunks, chunk = prep.cfg["n_chunks"], prep.cfg["chunk"]
    per_dev = chunk // D
    rng = np.random.default_rng(5)
    pc = rng.integers(0, 400, size=(n_chunks, chunk)).astype(np.int32)
    outs = prep.pipeline(*prep.operands, jnp.asarray(pc))
    counts, it_all = np.asarray(outs[4]), np.asarray(outs[5])
    assert counts.shape == (n_chunks, chunk) and counts.min() >= 1
    src = p.euv_beam
    ray_grids = tuple(jnp.asarray(np.asarray(g)) for g in
                      (src.x, src.y, src.a, src.b))
    nt = int(np.prod(prep.cfg["dims"]))
    for ci in range(n_chunks):
        for d in range(D):
            blk = it_all[ci, d * per_dev:(d + 1) * per_dev]
            # the device covers exactly its own strided it set...
            nat = ci * chunk + d + np.arange(per_dev) * D
            assert sorted(blk.tolist()) == sorted(nat.tolist())
            # ...visited in the library's (fetch row, cost) permutation of
            # ITS OWN slice of prev_counts (per-dev position j of device d
            # sits at global column d*per_dev + j), padding clamped like
            # the stride map
            ijkm_nat = jnp.asarray(np.where(nat < nt, nat, 0), jnp.int64)
            costs = pc[ci, d * per_dev:(d + 1) * per_dev]
            want = np.asarray(ray_tracer.reorder_perm(
                prep.cfg, jnp.asarray(costs), ijkm_nat, ray_grids))
            assert np.array_equal(blk, ci * chunk + d + want * D)


def test_sharded_stream_reorder_matches_sync():
    """Reorder over a mesh: each shard sorts its own rays by its own
    previous counts; results must match the synchronous sharded call to
    deposit-reassociation level on the virtual 8-device mesh."""
    import jax

    from raytrace_tpu.parallel.mesh import make_mesh
    from raytrace_tpu.parallel.sharding import (create_image_sharded,
                                                prepare_sharded)

    mesh = make_mesh(min(8, len(jax.devices())))
    kw = dict(nx=8, ny=5, na=5, nb=4, nv=6)
    prep = prepare_sharded(_distinct_units(1, 0, **kw)[0], mesh, "pallas",
                           chunk_size=4096, reorder=True)
    assert prep.cfg["reorder"]
    want = [create_image_sharded(p, mesh, "pallas", chunk_size=4096)
            for p in _distinct_units(2, 3, **kw)]
    got = list(create_image_stream(_distinct_units(2, 3, **kw), "pallas",
                                   chunk_size=4096, mesh=mesh,
                                   reorder=True))
    for (gi, ga), (wi, wa) in zip(got, want):
        assert (np.linalg.norm(gi - wi)
                <= _REASSOC_TOL * max(np.linalg.norm(wi), 1e-300))
        assert (np.linalg.norm(ga - wa)
                <= _REASSOC_TOL * max(np.linalg.norm(wa), 1e-300))


def test_reorder_stride_partition_sums_to_full():
    """The stride contract survives reordering: a 2-way N_start/N_parallel
    partition, each half streamed with reorder, sums to the full image."""
    full = create_image(synthetic_problem(nx=8, ny=5, na=5, nb=4,
                                          nv=6), "pallas", chunk_size=2048)
    parts = []
    for k in range(2):
        units = []
        for r in range(2):  # two units so the second uses real feedback
            pk_ = synthetic_problem(nx=8, ny=5, na=5, nb=4, nv=6)
            pk_.N_start, pk_.N_parallel = k, 2
            units.append(pk_)
        outs = list(create_image_stream(units, "pallas", chunk_size=2048,
                                        reorder=True))
        parts.append(outs[1])  # the feedback-sorted call
    img = parts[0][0] + parts[1][0]
    assert (np.linalg.norm(img - full[0])
            <= _REASSOC_TOL * np.linalg.norm(full[0]))
