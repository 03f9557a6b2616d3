"""Batched steppers (exact + fast) vs the scalar oracle on a synthetic
problem (SURVEY.md section 4 test plan (c))."""

import numpy as np
import pytest

import raytrace_tpu  # noqa: F401
import jax.numpy as jnp
from raytrace_tpu.models.problem import prepare_gain
from raytrace_tpu.ops import fast_stepper, oracle, stepper
from raytrace_tpu.testing import synthetic_problem


def _sample_rays(p, n, rng):
    b = p.euv_beam
    i = rng.integers(0, b.nx, n)
    j = rng.integers(0, b.ny, n)
    k = rng.integers(0, b.na, n)
    m = rng.integers(0, b.nb, n)
    return (b.x[i].astype(np.float32), b.y[j].astype(np.float32),
            b.a[k].astype(np.float32), b.b[m].astype(np.float32))


@pytest.mark.parametrize("method", [1, 2])
def test_exact_stepper_vs_oracle(method):
    p = synthetic_problem(seeded=(method == 2))
    b = p.euv_beam
    use_emis = method == 1
    gain_dev = prepare_gain(p.gain)
    rng = np.random.default_rng(0)
    xs, ys, aa, bb = _sample_rays(p, 32, rng)
    rays = {k: jnp.asarray(v) for k, v in zip("xyab", (xs, ys, aa, bb))}
    res = stepper.trace_batch(rays, p.N, b.dz, gain_dev, method,
                              use_emis=use_emis)
    gvl = np.asarray(res.gvl)
    ivl = np.asarray(res.ivl)
    n_ivl_ok = 0
    for t in range(32):
        o = oracle.calc_ray((xs[t], ys[t], aa[t], bb[t]), p.N, b.dz, p.gain,
                            p.seed if method == 2 else None, b.nv, method)
        want = o.gvl[: p.N - 1].ravel()
        got = gvl[t].ravel()
        # trip-count sensitivity allows small per-ray jitter; see
        # ops/fast_stepper.py docstring
        denom = np.maximum(np.abs(want), 1e-6)
        assert np.max(np.abs(got - want) / denom) < 0.05
        n_ivl_ok += int(np.array_equal(ivl[t].ravel(), o.ivl[: p.N - 1].ravel()))
    assert n_ivl_ok >= 28  # cell-boundary flips are rare


def test_fast_stepper_matches_exact():
    p = synthetic_problem()
    b = p.euv_beam
    gain_dev = prepare_gain(p.gain)
    ft = fast_stepper.pack_fast_tables(p.gain, use_emis=True)
    rng = np.random.default_rng(1)
    xs, ys, aa, bb = _sample_rays(p, 256, rng)
    rays = {k: jnp.asarray(v) for k, v in zip("xyab", (xs, ys, aa, bb))}
    r_exact = stepper.trace_batch(rays, p.N, b.dz, gain_dev, 1, use_emis=True)
    r_fast = fast_stepper.trace_batch_fast(rays, p.N, b.dz, ft, 1,
                                           use_emis=True)
    g_e = np.asarray(r_exact.gvl)
    g_f = np.asarray(r_fast.gvl)
    rel = np.abs(g_f - g_e) / np.maximum(np.abs(g_e), 1e-5)
    # batchwise agreement: median tight, tail bounded by trip-count jitter
    assert np.median(rel) < 1e-4
    assert np.mean(rel) < 5e-3
    assert np.array_equal(np.asarray(r_exact.escaped), np.asarray(r_fast.escaped))


@pytest.mark.parametrize("backend", ["exact", "fast", "pallas"])
def test_lockstep_straight_rays(backend):
    """Lockstep parity tier: refraction-free problem (dn/dx = dn/dy = 0),
    so every implementation's micro-step sequence is geometry-determined and
    identical to the oracle's -- no trajectory chaos. Per-ray gvl must agree
    to 1e-5 (f32 accumulation error, typically ~1e-7) and the cell indices
    exactly; a half-cell indexing bug (get_index's 0.5*d shift,
    src/RayTraceStructures.cpp:70-78 analogue) cannot hide here, unlike the
    loose 5% chaotic-tolerance tier above (kept for the production loop
    shape). Single-ray kernel surface: src/RayTrace.h:37-60."""
    p = synthetic_problem(refraction_free=True)
    b = p.euv_beam
    rng = np.random.default_rng(7)
    n_rays = 64
    xs, ys, aa, bb = _sample_rays(p, n_rays, rng)
    rays = {k: jnp.asarray(v) for k, v in zip("xyab", (xs, ys, aa, bb))}
    if backend == "exact":
        gain_dev = prepare_gain(p.gain)
        res = stepper.trace_batch(rays, p.N, b.dz, gain_dev, 1, use_emis=True)
    elif backend == "fast":
        ft = fast_stepper.pack_fast_tables(p.gain, use_emis=True)
        res = fast_stepper.trace_batch_fast(rays, p.N, b.dz, ft, 1,
                                            use_emis=True)
    else:
        # the Pallas-Triton kernel in interpret mode, one 128-ray block
        # (the GPU block size) holding the 64 rays plus padding
        from raytrace_tpu.ops import pallas_kernel as pk
        pg = pk.pack_gain_tables(p.gain, use_emis=True)
        res = pk.trace_rays(rays, p.N, b.dz, pg, 1, block=pk.BLOCK)
    gvl = np.asarray(res.gvl)
    ivl = np.asarray(res.ivl)
    for t in range(n_rays):
        o = oracle.calc_ray((xs[t], ys[t], aa[t], bb[t]), p.N, b.dz, p.gain,
                            None, b.nv, 1)
        want = o.gvl[: p.N - 1].ravel()
        got = gvl[t].ravel()
        denom = np.maximum(np.abs(want), 1e-6)
        assert np.max(np.abs(got - want) / denom) < 1e-5, (
            f"ray {t}: max rel {np.max(np.abs(got - want) / denom)}")
        assert np.array_equal(ivl[t].ravel(), o.ivl[: p.N - 1].ravel()), (
            f"ray {t}: cell-index mismatch")


def test_non_uniform_requires_exact():
    p = synthetic_problem(non_uniform_gain=True)
    assert not fast_stepper.is_uniform(p.gain)
    with pytest.raises(ValueError):
        fast_stepper.pack_fast_tables(p.gain, use_emis=True)


def test_exact_stepper_non_uniform_grid():
    """The exact stepper's bisection handles non-uniform gain grids."""
    p = synthetic_problem(non_uniform_gain=True)
    b = p.euv_beam
    gain_dev = prepare_gain(p.gain)
    rng = np.random.default_rng(3)
    xs, ys, aa, bb = _sample_rays(p, 8, rng)
    rays = {k: jnp.asarray(v) for k, v in zip("xyab", (xs, ys, aa, bb))}
    res = stepper.trace_batch(rays, p.N, b.dz, gain_dev, 1, use_emis=True)
    gvl = np.asarray(res.gvl)
    for t in range(8):
        o = oracle.calc_ray((xs[t], ys[t], aa[t], bb[t]), p.N, b.dz, p.gain,
                            None, b.nv, 1)
        want = o.gvl[: p.N - 1].ravel()
        denom = np.maximum(np.abs(want), 1e-6)
        assert np.max(np.abs(gvl[t].ravel() - want) / denom) < 0.05


def test_pallas_step_counts_match_fast_census():
    """The pallas kernel's per-lane micro-step counter (counts=True, the
    cost-feedback reorder signal) must equal the fast stepper's census
    counter exactly: the two backends run one step function
    (fast_stepper.segment_walk), so their counts are the same integers, not
    just statistically close."""
    from raytrace_tpu.ops import pallas_kernel as pk

    p = synthetic_problem()
    b = p.euv_beam
    ft = fast_stepper.pack_fast_tables(p.gain, use_emis=True)
    pg = pk.pack_gain_tables(p.gain, use_emis=True)
    rng = np.random.default_rng(3)
    xs, ys, aa, bb = _sample_rays(p, 1024, rng)
    rays = {k: jnp.asarray(v) for k, v in zip("xyab", (xs, ys, aa, bb))}

    fast_stepper.DEBUG_COUNTERS = True
    try:
        _, ctr = fast_stepper.trace_batch_fast(rays, p.N, b.dz, ft, 1,
                                               use_emis=True)
    finally:
        fast_stepper.DEBUG_COUNTERS = False
    want = np.asarray(ctr["steps"])

    res, cnt = pk.trace_rays(rays, p.N, b.dz, pg, 1, counts=True)
    got = np.asarray(cnt)
    assert np.array_equal(got, want), (
        f"count mismatch on {np.sum(got != want)} lanes")
    # and the counting variant must not perturb the physics outputs
    res0 = pk.trace_rays(rays, p.N, b.dz, pg, 1)
    for name in res._fields:
        assert np.array_equal(np.asarray(getattr(res, name)),
                              np.asarray(getattr(res0, name))), name


@pytest.mark.parametrize("seeded", [False, True])
def test_kernel_block_padding_invariant(seeded):
    """A batch that is not a multiple of the block is padded with rays that
    escape at once and cut back; lanes are independent, so every output
    (counts included) is bitwise the same at any block size."""
    from raytrace_tpu.ops import pallas_kernel as pk

    p = synthetic_problem(seeded=seeded, rng=11)
    b = p.euv_beam
    use_emis = not seeded
    method = 2 if seeded else 1
    pg = pk.pack_gain_tables(p.gain, use_emis=use_emis)
    rng = np.random.default_rng(5)
    xs, ys, aa, bb = _sample_rays(p, 300, rng)
    rays = {k: jnp.asarray(v) for k, v in zip("xyab", (xs, ys, aa, bb))}
    outs = {blk: pk.trace_rays(rays, p.N, b.dz, pg, method, counts=True,
                               block=blk) for blk in (128, 512)}
    (r1, c1), (r2, c2) = outs[128], outs[512]
    assert r1.gvl.shape == (300, p.N - 1, 3) and c1.shape == (300,)
    for name in r1._fields:
        assert np.array_equal(np.asarray(getattr(r1, name)),
                              np.asarray(getattr(r2, name))), name
    assert np.array_equal(np.asarray(c1), np.asarray(c2))
    assert int(np.asarray(c1).max()) > 0


@pytest.mark.parametrize("method", [1, 2])
def test_kernel_lockstep_with_fast_stepper(method):
    """Kernel (gather fetch, block batch) vs the XLA stepper (one-hot fetch,
    chunk batch) on refraction-free rays: the shared step function gives
    the same cell ids and step counts, and values to f32 rounding."""
    from raytrace_tpu.ops import pallas_kernel as pk

    p = synthetic_problem(refraction_free=True, seeded=(method == 2))
    b = p.euv_beam
    use_emis = method == 1
    rng = np.random.default_rng(8)
    xs, ys, aa, bb = _sample_rays(p, 200, rng)
    rays = {k: jnp.asarray(v) for k, v in zip("xyab", (xs, ys, aa, bb))}
    ft = fast_stepper.pack_fast_tables(p.gain, use_emis=use_emis)
    fast_stepper.DEBUG_COUNTERS = True
    try:
        r_f, ctr = fast_stepper.trace_batch_fast(rays, p.N, b.dz, ft, method,
                                                 use_emis=use_emis)
    finally:
        fast_stepper.DEBUG_COUNTERS = False
    pg = pk.pack_gain_tables(p.gain, use_emis=use_emis)
    r_k, cnt = pk.trace_rays(rays, p.N, b.dz, pg, method, counts=True)
    assert np.array_equal(np.asarray(cnt), np.asarray(ctr["steps"]))
    assert np.array_equal(np.asarray(r_k.ivl), np.asarray(r_f.ivl))
    assert np.array_equal(np.asarray(r_k.escaped), np.asarray(r_f.escaped))
    g_f = np.asarray(r_f.gvl)
    rel = np.abs(np.asarray(r_k.gvl) - g_f) / np.maximum(np.abs(g_f), 1e-6)
    assert rel.max() < 1e-5, rel.max()


def test_exact_stepper_grid_line_tie():
    """A ray entering EXACTLY on a gain-grid line must resolve the
    findindex tie like the oracle/reference (f64 grid compares -- the
    reference's ray_gain_struct keeps x/y double,
    RayTraceStructures.h:215-217). Round-5 fuzz regression: the exact
    stepper's then-f32 device grids flipped the tie to the adjacent
    cell on a seeded full-plane case and chaos amplified the different
    step sequence to a 20% image error over N=7 segments."""
    from raytrace_tpu.testing import physical_gain

    p = synthetic_problem(nx=4, ny=3, na=2, nb=3, nv=4, N=7, seeded=True,
                          seed_dim=18, full_plane=True, rng=22)
    physical_gain(p)
    b = p.euv_beam
    sb = p.seed_beam
    # seed grid x[1] coincides exactly with gain grid x[7] = 0.00175 --
    # the configuration fuzz case 22 (seed 888) diverged on
    x, y, aa, bb = (np.float32(sb.x[1]), np.float32(sb.y[0]),
                    np.float32(sb.a[0]), np.float32(sb.b[0]))
    gain_dev = prepare_gain(p.gain)
    rays = {k: jnp.asarray(np.array([v], np.float32))
            for k, v in zip("xyab", (x, y, aa, bb))}
    res = stepper.trace_batch(rays, p.N, b.dz, gain_dev, 2, use_emis=False)
    o = oracle.calc_ray((x, y, aa, bb), p.N, b.dz, p.gain, None, b.nv, 2)
    got = np.asarray(res.gvl)[0][: p.N - 1].ravel()
    want = o.gvl[: p.N - 1].ravel()
    denom = np.maximum(np.abs(want), 1e-6)
    assert np.max(np.abs(got - want) / denom) < 1e-5, (
        f"max rel {np.max(np.abs(got - want) / denom)}")
    assert np.array_equal(np.asarray(res.ivl)[0][: p.N - 1].ravel(),
                          o.ivl[: p.N - 1].ravel())


def test_kernel_nonuniform_grid_line_tie():
    """The kernel's findindex bisection on non-uniform grids compares in
    f64 against the f64 coordinate rows, so a ray entering EXACTLY on a
    gain-grid line resolves to the oracle's cell (the exact stepper's
    grid-line rule above)."""
    from raytrace_tpu.ops import pallas_kernel as pk

    p = synthetic_problem(nx=4, ny=3, na=2, nb=3, nv=4, N=4,
                          non_uniform_gain=0.5, refraction_free=True, rng=3)
    b = p.euv_beam
    g = p.gain[1]
    # entry x exactly on an interior grid line (f32-representable)
    x = np.float32(g.x[9])
    for s_ in p.gain:
        s_.x[9] = float(x)
    y, aa, bb = (np.float32(b.y[1]), np.float32(0.0), np.float32(0.0))
    pg = pk.pack_gain_tables(p.gain, use_emis=True)
    assert pg.nonuniform
    rays = {k: jnp.asarray(np.array([v], np.float32))
            for k, v in zip("xyab", (x, y, aa, bb))}
    res = pk.trace_rays(rays, p.N, b.dz, pg, 1)
    o = oracle.calc_ray((x, y, aa, bb), p.N, b.dz, p.gain, None, b.nv, 1)
    assert np.array_equal(np.asarray(res.ivl)[0].ravel(),
                          o.ivl[: p.N - 1].ravel())
    got = np.asarray(res.gvl)[0].ravel()
    want = o.gvl[: p.N - 1].ravel()
    denom = np.maximum(np.abs(want), 1e-6)
    assert np.max(np.abs(got - want) / denom) < 1e-5
