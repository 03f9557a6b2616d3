"""Synthetic problem generation for tests and multi-chip dry runs.

Builds physically-sane random ``create_image`` work units shaped like the
production snapshots (plasma gain column, half-plane y symmetry, optional
separable seed): miniatures that trace on CPU in milliseconds, and
:func:`production_problem` units at the snapshots' full shapes.
"""

from __future__ import annotations

import os

import numpy as np

from raytrace_tpu.structures import (
    CreateImageProblem, EUVBeam, RayGain, RaySeed, SeedBeam,
)

__all__ = ["synthetic_problem", "production_problem", "perturbed_problems",
           "oracle_images", "physical_gain", "time_stream_rounds",
           "time_stream_detailed", "ASE_SNAPSHOT", "SEED_SNAPSHOT"]

#: the shipped snapshots ASE_small.dat and seed_small.dat, read from
#: ``snapshots/`` at the repository root. They are not in the repository:
#: what needs them skips or says so, and :func:`production_problem`
#: generates units of the same shapes
SNAPSHOT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "snapshots")
ASE_SNAPSHOT = os.path.join(SNAPSHOT_DIR, "ASE_small.dat")
SEED_SNAPSHOT = os.path.join(SNAPSHOT_DIR, "seed_small.dat")


def time_stream_rounds(path, n_units, rounds, consume, salt0=0, scale=None):
    """Per-call seconds of a serving-mode stream over fresh work units.

    The shared timing protocol for every ``create_image_stream`` row
    (bench.py, the CLI ``-stream`` rows): each round builds ``n_units``
    distinct-tables snapshots via :func:`perturbed_problems` (salt varies
    per round so factors never repeat), ``consume(units)`` drains the
    stream, and the round's wall time is divided by the unit count.
    Returns the list of per-call seconds, one entry per round.
    """
    import time

    # one source of truth: the detailed variant's round-wall accounting IS
    # this function's contract (round_wall = fill + sum(yields))
    def make_stream(units):
        def gen():
            consume(units)
            yield None  # single mark at drain end: round wall only
        return gen()

    per_call, _ = time_stream_detailed(path, n_units, rounds, make_stream,
                                       salt0=salt0, scale=scale)
    return per_call


def time_stream_detailed(path, n_units, rounds, make_stream, salt0=0,
                         scale=None):
    """Per-YIELD wall times of a serving-mode stream (the self-attributing
    variant of :func:`time_stream_rounds`).

    ``make_stream(units)`` returns the stream iterator; this helper drains
    it and timestamps every yield, so the artifact can carry per-call
    completion intervals instead of only a round average. Returns
    ``(per_call, rounds_detail)`` where ``per_call`` is the per-round
    round_wall/n_units list (identical semantics to time_stream_rounds)
    and ``rounds_detail`` is one dict per round::

        {"round_wall_s": ..., "fill_s": <first-yield latency — pipeline
         fill: upload+compute+readback of call 0 with nothing to overlap>,
         "yield_s": [<t(yield k) - t(yield k-1)> for k >= 1]}

    The steady-state throughput statistic is ``yield_s`` (inter-completion
    spacing while the pipeline is full); ``fill_s`` is reported separately
    because folding it in understates a deep pipeline.

    ``path`` is a snapshot file, or a callable ``path(n, salt)`` returning
    the round's ``n`` work units (generated inputs).
    """
    import time

    if n_units < 1:
        raise ValueError("time_stream_detailed needs n_units >= 1")
    per_call, detail = [], []
    for r in range(rounds):
        if callable(path):
            units = path(n_units, salt0 + r)
        else:
            units = perturbed_problems(path, n_units, salt=salt0 + r,
                                       scale=scale)
        t0 = time.perf_counter()
        marks = []
        for _ in make_stream(units):
            marks.append(time.perf_counter())
        if not marks:
            raise ValueError("the stream yielded no result")
        wall = marks[-1] - t0
        per_call.append(wall / len(units))
        detail.append({
            "round_wall_s": round(wall, 4),
            "fill_s": round(marks[0] - t0, 4),
            "yield_s": [round(b - a, 4)
                        for a, b in zip(marks, marks[1:])],
        })
    return per_call, detail


def physical_gain(p: CreateImageProblem) -> CreateImageProblem:
    """Scale ``p``'s gain to the saturated X-ray-laser regime for long
    (N > ~5) paths: total exponent ~14 instead of ~57, keeping intensities
    inside float32 range, which the f32 two-float spectrum requires and
    every real workload satisfies (the reference accumulates in double and
    would carry e^57 -- unphysical for a saturated column). The single
    shared definition: the fuzz/interop gates compare problems scaled in
    different code paths and depend on the copies being bitwise-identical.
    """
    for g in p.gain:
        g.g0 = (np.asarray(g.g0) * np.float32(0.25)).astype(np.float32)
    return p


def _uniform_grid(lo, hi, n):
    d = (hi - lo) / n
    return lo + (0.5 + np.arange(n)) * d, d


def synthetic_problem(nx=8, ny=5, na=5, nb=4, nv=6, N=3, seeded=False,
                      seed_dim=21, rng=None, non_uniform_gain=False,
                      refraction_free=False,
                      full_plane=False, gain_nx=30,
                      gain_ny=12, seed_grid=None,
                      n_dip=2e-5) -> CreateImageProblem:
    """A miniature ASE or seeded work unit with smooth random gain tables.

    ``refraction_free``: constant index of refraction (n = 1 everywhere, so
    dn/dx = dn/dy = 0). Rays travel in straight lines, which makes every
    implementation's micro-step sequence geometry-determined and identical
    -- the lockstep-parity regime (tests/test_stepper.py) where per-ray
    results must agree to float32 accumulation error, with no trajectory
    chaos to hide a half-cell indexing bug. The gain tables stay nonzero so
    the cell walk, bilinear gain interpolation, and path integrals are all
    still exercised.

    ``full_plane``: grids span negative y too (the reference's abs_y mirror
    is OFF: RayTraceImageHelper.h:325-336 only mirrors when y[0] >= 0), so
    the non-mirrored index/gradient/binning paths get exercised.

    ``seed_grid``: the seeded ray grid's (nx, ny, na, nb); by default it is
    derived from the euv grid as (nx+2, ny, na+1, nb+1).

    ``n_dip``: depth of the index-of-refraction dip (see below).
    """
    rng = np.random.default_rng(rng)
    p = CreateImageProblem()
    p.N = N
    p.N_start = 0
    p.N_parallel = 1

    beam = EUVBeam()
    beam.run_ASE, beam.run_sat, beam.run_refract = True, True, True
    beam.lam = 1.7e-6
    # A is compared by operator== but never serialized by the reference's
    # euv pack (RayTraceStructures.cpp:441-506), so keep it at the default
    beam.A = 0.0
    beam.Nc = 3.8e24
    beam.R_scale = beam.G_scale = -1.0
    beam.x, beam.dx = _uniform_grid(1e-4, 6e-3, nx)
    if full_plane:
        beam.y, beam.dy = _uniform_grid(-2.4e-3, 2.4e-3, ny)
    else:
        beam.y, beam.dy = _uniform_grid(0.0, 2.4e-3, ny)
    beam.a, beam.da = _uniform_grid(-10.0, 8.0, na)
    beam.b, beam.db = _uniform_grid(-9.0, 5.0, nb)
    beam.z = np.linspace(0.0, 0.05 * (N - 1), max(N, 2))
    beam.dz = 0.05
    v0 = 1.76e16
    beam.v, dv0 = _uniform_grid(v0 * 0.99998, v0 * 1.00002, nv)
    beam.dv = np.full(nv, dv0)
    beam.v0 = v0
    p.euv_beam = beam

    gains = []
    Nx, Ny = gain_nx, gain_ny
    gx, _ = _uniform_grid(0.0, 7e-3, Nx)
    if full_plane:
        gy, _ = _uniform_grid(-2.45e-3, 2.45e-3, Ny)
    else:
        gy, _ = _uniform_grid(0.0, 2.45e-3, Ny)
    gx = np.sort(gx)
    gy = np.sort(gy)
    if non_uniform_gain is True:
        gx = np.sort(gx + rng.uniform(-2e-5, 2e-5, Nx))
        gy = np.sort(gy + rng.uniform(-5e-6, 5e-6, Ny))
    elif non_uniform_gain:
        # float strength w: power-warp the coordinates (t -> t^(1+w) over
        # the same extents) -- strongly non-uniform spacings that really
        # exercise findindex bisection, unlike the tiny jitter above
        w = float(non_uniform_gain)

        def _warp(g):
            t = (g - g[0]) / (g[-1] - g[0])
            return g[0] + (g[-1] - g[0]) * t ** (1.0 + w)

        gx = _warp(gx)
        gy = gy if gy[0] < 0 else _warp(gy)  # keep full-plane grids simple
    X, Y = np.meshgrid(gx, gy)  # [Ny, Nx]
    for s in range(N):
        g = RayGain()
        g.x = gx.copy()
        g.y = gy.copy()
        # smooth, *gentle* index-of-refraction dip. Trajectories through a
        # refracting column are chaotic: 1-ulp arithmetic differences between
        # implementations amplify per sub-length (measured ~1000x/sub at
        # production-strength gradients on a 30-cell grid). Tests compare
        # per-ray results against the scalar oracle, so the synthetic keeps
        # gradients weak enough that implementations agree to ~1e-5; the
        # production-strength regime is covered by the golden-image norm
        # gates against the real snapshots.
        blob = np.exp(-((X - 2.5e-3) ** 2) / (3e-3) ** 2
                      - (Y / 2.5e-3) ** 2)
        n_dip = 0.0 if refraction_free else n_dip
        g.n = (1.0 - n_dip * blob * (1 + 0.05 * s)).reshape(-1)
        g.g0 = (60.0 * blob * (1 + 0.1 * s)).astype(np.float32).reshape(-1)
        g.E0 = (1e-4 * blob).astype(np.float32).reshape(-1)
        # normalized Lorentzian-ish lineshape per frequency
        prof = 1.0 / (1.0 + np.linspace(-2, 2, nv) ** 2)
        g.gv = (np.ones((Ny * Nx, 1)) * prof[None, :]).astype(np.float32).reshape(-1)
        g.gv0 = np.full(Ny * Nx, prof.max(), np.float32)
        gains.append(g)
    p.gain = gains

    if seeded:
        sb = SeedBeam()
        snx, sny, sna, snb = seed_grid or (nx + 2, ny, na + 1, nb + 1)
        sb.x, sb.dx = _uniform_grid(5e-4, 5.5e-3, snx)
        if full_plane:
            sb.y, sb.dy = _uniform_grid(-2.2e-3, 2.2e-3, sny)
        else:
            sb.y, sb.dy = _uniform_grid(0.0, 2.2e-3, sny)
        sb.a, sb.da = _uniform_grid(-6.0, 6.0, sna)
        sb.b, sb.db = _uniform_grid(-6.0, 6.0, snb)
        sb.Wx = sb.Wy = 1e-3
        sb.Wa = sb.Wb = 3.0
        sb.Wv = 1e-5
        sb.Wt = 1e-12
        sb.E = 1e-6
        p.seed_beam = sb

        seed = RaySeed()
        dims = [seed_dim] * 4 + [nv]
        seed.initialize(dims)
        centers = (2.5e-3, 1.0e-3, 0.0, 0.0)
        widths = (1.5e-3, 0.8e-3, 4.0, 4.0)
        spans = ((0.0, 6.5e-3), (-2.5e-3, 2.5e-3), (-8.0, 8.0), (-8.0, 8.0))
        for ax in range(4):
            gr = np.linspace(*spans[ax], seed_dim)
            seed.x[ax] = gr
            seed.f[ax] = np.exp(-((gr - centers[ax]) / widths[ax]) ** 2)
        seed.x[4] = beam.v.copy()
        seed.f[4] = 1.0 / (1.0 + np.linspace(-1, 1, nv) ** 2)
        seed.f0 = 3e10
        p.seed = seed
    return p


#: the shipped snapshots' shapes (SURVEY.md section 0): euv grid
#: 60x25x19x14, N=3 segments of 106x26 uniform gain grids, half-plane beams;
#: ASE nv=52 (399,000 backward rays); seeded nv=82 on a 120x25x51x51 seed
#: grid (7,803,000 forward rays) with separable 251-point seed tables. The
#: index dip n_dip=1e-4 puts the ASE unit's micro-steps per ray at mean
#: 49.7, p99 124, max 132 (8,192-ray sample, lax stepper on the CPU),
#: against the snapshot census of 34.8 / 195 / 272 (ROADMAP.md)
PRODUCTION_SHAPES = {
    "ase": dict(nx=60, ny=25, na=19, nb=14, nv=52, N=3, gain_nx=106,
                gain_ny=26, n_dip=1e-4),
    "seed": dict(nx=60, ny=25, na=19, nb=14, nv=82, N=3, gain_nx=106,
                 gain_ny=26, n_dip=1e-4, seeded=True, seed_dim=251,
                 seed_grid=(120, 25, 51, 51)),
}


def production_problem(kind: str, seed: int = 0) -> CreateImageProblem:
    """A generated work unit at a shipped snapshot's full shape (``kind``
    "ase" or "seed"). The snapshots themselves are not in the repository;
    these units stand in for them at the same ray counts, grids and
    spectra. Each segment's gain ``g0`` is scaled by a factor in
    [0.99, 1.01] drawn from ``seed``, so units of different seeds have
    distinct tables (production changes the tables every iteration,
    Readme.txt:43) while the trajectories stay those of the shape."""
    if kind not in PRODUCTION_SHAPES:
        raise ValueError(f"unknown production problem {kind!r} "
                         f"(expected one of {sorted(PRODUCTION_SHAPES)})")
    p = synthetic_problem(rng=seed, **PRODUCTION_SHAPES[kind])
    rng = np.random.default_rng([seed, 1])
    for g in p.gain:
        f = np.float32(1.0 + 0.01 * rng.uniform(-1.0, 1.0))
        g.g0 = (np.asarray(g.g0, np.float32) * f).astype(np.float32)
    return p


def perturbed_problems(path, n, salt=0, scale=None):
    """``n`` fresh copies of the snapshot at ``path``, each with its gain
    ``g0`` tables scaled by a distinct factor ``1 + 1e-5*(salt*n + i + 1)``.

    This is the distinct-tables benchmarking protocol shared by bench.py,
    the CLI ``-stream`` rows, and tools/bench_stream.py: every timed call
    receives distinct inputs, so no cache of any kind can serve a
    measurement, and it matches production semantics -- the gain tables
    change every iteration (Readme.txt:43). Vary ``salt`` across timing
    rounds so factors never repeat within a process.
    """
    from raytrace_tpu.io.loader import load_input, scale_problem

    probs = []
    for i in range(n):
        p, _, _ = load_input(path)
        if scale is not None and scale != 1.0:
            scale_problem(p, scale)
        f = np.float32(1.0 + 1e-5 * (salt * n + i + 1))
        for g in p.gain:
            g.g0 = (np.asarray(g.g0, np.float32) * f).astype(np.float32)
        probs.append(p)
    return probs


def oracle_images(p, method):
    """Brute-force reference deposit via the scalar oracle: trace every ray
    with ops.oracle.calc_ray and bin like the reference kernel
    (RayTraceImageCuda.cu:84-125 semantics -- method 1 bins at entry
    coords, method 2 at the negated exit angles with the y mirror).

    Returns ``(image, i_ang)`` as float64 arrays, or ``(None, None)`` if
    any ray hits the failure path (the caller decides whether that is a
    skip or an assertion failure). Shared by the test suite and
    tools/fuzz_oracle.py so the two gates can never diverge.
    """
    from raytrace_tpu.ops import oracle

    b = p.euv_beam
    src = p.seed_beam if method == 2 else b
    scale = 1.0 if method == 1 else (
        (src.dx * src.dy * src.da * src.db) / (b.dx * b.dy))
    image = np.zeros(b.nx * b.ny * b.nv)
    i_ang = np.zeros(b.na * b.nb)

    def get_index(grid, d, y):
        if y < grid[0] - 0.5 * d or y > grid[-1] + 0.5 * d:
            return -1
        return oracle.find_first_single(grid, y - 0.5 * d)

    for i in range(src.nx):
        for j in range(src.ny):
            for k in range(src.na):
                for m in range(src.nb):
                    ray = (np.float32(src.x[i]), np.float32(src.y[j]),
                           np.float32(src.a[k]), np.float32(src.b[m]))
                    res = oracle.calc_ray(
                        ray, p.N, b.dz, p.gain,
                        p.seed if method == 2 else None, b.nv, method)
                    if res.error != 0:
                        return None, None  # failure-path config
                    if method == 1:
                        bx, by, ba, bb_ = ray
                    else:
                        bx, by = res.ray_out[0], res.ray_out[1]
                        ba, bb_ = -res.ray_out[2], -res.ray_out[3]
                        if by < 0 and b.y[0] >= 0:
                            by = -by
                    i1 = get_index(b.x, b.dx, bx)
                    i2 = get_index(b.y, b.dy, by)
                    i3 = get_index(b.a, b.da, ba)
                    i4 = get_index(b.b, b.db, bb_)
                    if i1 >= 0 and i2 >= 0:
                        base = b.nv * (i1 + i2 * b.nx)
                        image[base:base + b.nv] += res.Iv * scale
                    if i3 >= 0 and i4 >= 0:
                        i_ang[i3 + i4 * b.na] += float(
                            np.sum(2.0 * b.dv * res.Iv))
    return image, i_ang
