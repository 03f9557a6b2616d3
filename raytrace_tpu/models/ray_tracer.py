"""``create_image`` orchestration: ray-list generation, backend dispatch,
chunked device execution, failure handling.

Rebuild of ``RayTrace::create_image`` (src/RayTraceImage.cpp:227-434):

* limits + uniform-grid validation (RayTraceImage.cpp:229-264)
* ray-list generation with the N_start/N_parallel stride-decomposition
  contract (RayTraceImage.cpp:277-328)
* method dispatch -> backend registry {"lax", "lax-exact", "pallas"} instead
  of the reference's compile-time backend zoo (cpu/threads/OpenMP/Cuda/...)
* per-ray failure codes -> bitmask -> failed-ray dump -> abort
  (RayTraceImage.cpp:427-430)

Execution model: rays are processed in fixed-size chunks by one jitted
pipeline (trace -> seed -> amplify -> bin) whose partial images accumulate on
device in float64. Pipelines are cached process-wide by their static
configuration, so repeated ``create_image`` calls (the benchmark protocol)
pay compilation once -- the analogue of the reference's GPU warmup fixture
(src/CreateImage.cpp:118-132).
"""

from __future__ import annotations

import math
import os
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.models.problem import (
    DeviceBeam, prepare_gain, prepare_seed,
)
from raytrace_tpu.ops import (binning, fast_stepper, seed as seed_ops,
                              spectrum, stepper)
from raytrace_tpu.structures import CreateImageProblem
from raytrace_tpu.utils import errors as err_util
from raytrace_tpu.utils.timer import profiler

__all__ = ["create_image", "create_image_stream", "prepare_pipeline",
           "PreparedCall",
           "generate_ray_indices", "available_methods",
           "BACKENDS", "N_MAX", "K_MAX"]

N_MAX = 20   # max length segments (RayTraceImageHelper.h:29)
K_MAX = 100  # max frequencies (RayTraceImageHelper.h:30)

#: backend registry: name -> pipeline factory(cfg) -> jitted chunk fn.
BACKENDS: dict[str, Callable] = {}

#: process-wide cache of compiled pipelines, keyed by static config
_PIPELINE_CACHE: dict = {}

#: upload-overlap (split) pipeline gate: the stacked trace results live in
#: device memory between the two dispatches, so cap them to ASE-class sizes
#: (the seeded stack is ~0.7 GB). Whether the split pays on the GPU is not
#: measured yet (ROADMAP.md Queue 3, item 4)
_SPLIT_MAX_BYTES = 96 * 2 ** 20


def _check_grid(n: int, d: float, grid: np.ndarray) -> bool:
    """Uniform-spacing check at 1e-12*d tolerance (check_grid,
    src/RayTraceImage.cpp:220-226)."""
    diffs = np.diff(np.asarray(grid, np.float64))
    return bool(np.any(np.abs(diffs - d) > 1e-12 * d))


def generate_ray_indices(problem: CreateImageProblem) -> np.ndarray:
    """Global flat ray indices honoring the stride contract: worker takes
    ``ijkm = N_start + it * N_parallel`` (RayTraceImage.cpp:300-328)."""
    beam = problem.seed_beam if problem.seed is not None else problem.euv_beam
    Nt = beam.nx * beam.ny * beam.na * beam.nb
    skip = problem.N_parallel
    offset = problem.N_start
    its = np.arange(Nt // skip + 1, dtype=np.int64)
    ijkm = offset + its * skip
    return ijkm[ijkm < Nt]


def _unflatten_rays(ijkm, dims):
    """b-fastest unflatten of the 4-D ray-grid index
    (RayTraceImage.cpp:309-313)."""
    nx, ny, na, nb = dims
    m = ijkm % nb
    k = (ijkm // nb) % na
    j = (ijkm // (na * nb)) % ny
    i = ijkm // (ny * na * nb)
    return i.astype(jnp.int32), j.astype(jnp.int32), k.astype(jnp.int32), m.astype(jnp.int32)


def unpack_bundle(cfg: dict, pack):
    """Slice the single packed host->device transfer back into the small
    per-call arrays (grids, dv, seed factor tables).

    Shipping one concatenated f64 vector instead of ~16 small arrays matters
    on hosts where each transfer pays link latency; scalars ride in the
    static config. Layout entries are (name, offset, length).
    """
    arrays = {}
    for name, off, ln in cfg["pack_layout"]:
        arrays[name] = jax.lax.slice(pack, (off,), (off + ln,))
    sc = cfg["beam_scalars"]
    beam = DeviceBeam(
        x=arrays["bx"], y=arrays["by"], a=arrays["ba"], b=arrays["bb"],
        dv=arrays["bdv"],
        dx=jnp.float64(sc[0]), dy=jnp.float64(sc[1]),
        da=jnp.float64(sc[2]), db=jnp.float64(sc[3]),
        y0_nonneg=jnp.bool_(sc[4]))
    ray_grids = (arrays["sx"], arrays["sy"], arrays["sa"], arrays["sb"])
    dseed = None
    if any(n == "seed_tx" for n, _, _ in cfg["pack_layout"]):
        dseed = seed_ops.EntrySeedTables(
            tx=arrays["seed_tx"], ty=arrays["seed_ty"], ta=arrays["seed_ta"],
            tb=arrays["seed_tb"], fv=arrays["seed_fv"],
            f0=jnp.float64(cfg["seed_f0"]))
    return ray_grids, beam, dseed


def make_bundle_pack(beam, src, entry_seed=None):
    """Host-side companion of unpack_bundle: returns (pack f64 array, layout,
    beam_scalars)."""
    parts = [("bx", beam.x), ("by", beam.y), ("ba", beam.a), ("bb", beam.b),
             ("bdv", beam.dv), ("sx", src.x), ("sy", src.y), ("sa", src.a),
             ("sb", src.b)]
    if entry_seed is not None:
        parts += [("seed_tx", entry_seed.tx), ("seed_ty", entry_seed.ty),
                  ("seed_ta", entry_seed.ta), ("seed_tb", entry_seed.tb),
                  ("seed_fv", entry_seed.fv)]
    layout = []
    bufs = []
    off = 0
    for name, arr in parts:
        arr = np.asarray(arr, np.float64)
        layout.append((name, off, len(arr)))
        bufs.append(arr)
        off += len(arr)
    scalars = (float(beam.dx), float(beam.dy), float(beam.da),
               float(beam.db), bool(beam.y[0] >= 0.0))
    return jnp.asarray(np.concatenate(bufs)), tuple(layout), scalars


def _chunk_rays(cfg: dict, ijkm, ray_grids):
    """Entry coordinates for one chunk of flat ray indices (b-fastest
    unflatten + f32 grid lookup)."""
    i, j, k, m = _unflatten_rays(ijkm, cfg["dims"])
    gx, gy, ga, gb = ray_grids
    rays = {
        "x": gx[i].astype(jnp.float32),
        "y": gy[j].astype(jnp.float32),
        "a": ga[k].astype(jnp.float32),
        "b": gb[m].astype(jnp.float32),
    }
    return rays, (i, j, k, m)


def chunk_trace(cfg: dict, trace_fn, ijkm, ray_grids, trace_tables):
    """Trace stage of one chunk: ray gen -> stepper. Returns the
    TraceResult pytree (everything chunk_post needs besides the lineshape
    tables), so the gv upload can overlap this stage's execution on
    latency-bound device links (see _make_split_pipeline)."""
    rays, _ = _chunk_rays(cfg, ijkm, ray_grids)
    return trace_fn(rays, trace_tables)


def chunk_post(cfg: dict, ijkm, valid, ray_grids, res, gv_tables, dseed,
               beam):
    """Post-trace stage of one chunk: seed -> amplify -> code -> bin."""
    N = cfg["N"]
    K = cfg["K"]
    method = cfg["method"]
    use_emis = cfg["use_emis"]
    scale = cfg["scale"]
    dense = cfg.get("dense", False)
    spectrum_dtype = jnp.dtype(cfg["spectrum_dtype"])

    rays, (i, j, k, m) = _chunk_rays(cfg, ijkm, ray_grids)
    B = ijkm.shape[0]
    if dseed is None:
        Iv0 = jnp.zeros((B, K), dtype=spectrum_dtype)
    else:
        if isinstance(dseed, seed_ops.EntrySeedTables):
            # forward seeding at entry coords: precomputed per-axis factors
            Iv0 = seed_ops.calc_seed_entry(dseed, i, j, k, m, K)
        elif method == 1:
            Iv0 = seed_ops.calc_seed_batch(dseed, res.exit_x, res.exit_y,
                                           res.exit_a, res.exit_b, K)
        else:
            Iv0 = seed_ops.calc_seed_batch(dseed, rays["x"], rays["y"],
                                           rays["a"], rays["b"], K)
        Iv0 = jnp.where(res.escaped[:, None], 0.0, Iv0).astype(spectrum_dtype)
    Iv = spectrum.amplify(res, Iv0, gv_tables, N, use_emis,
                          dtype=spectrum_dtype)
    neg = jnp.any(Iv < 0.0, axis=1)
    nan = jnp.any(Iv != Iv, axis=1)
    code = jnp.where(res.perp, -1, jnp.where(neg, -2, jnp.where(nan, -3, 0)))
    code = jnp.where(valid, code, 0).astype(jnp.int32)
    ok = valid & (code == 0)
    if dense:
        img_p, ang_p = binning.bin_images_dense(Iv, beam, ok)
    else:
        img_p, ang_p = binning.bin_images(Iv, res, rays, beam, method,
                                          scale, ok,
                                          deposit=cfg.get("bin_deposit",
                                                          "scatter"))
    return img_p, ang_p, code


def chunk_core(cfg: dict, trace_fn, ijkm, valid, ray_grids, trace_tables,
               gv_tables, dseed, beam):
    """Shared per-chunk compute: ray gen -> trace -> seed -> amplify -> bin.

    Returns (image_partial, iang_partial, code). ``image_partial`` is
    [cells_chunk, K] in i-major order when cfg['dense'] else the full
    [nx*ny, K] scatter deposit. Used by both the single-device pipeline and
    the shard_map multi-chip path (raytrace_tpu.parallel.sharding).
    """
    res = chunk_trace(cfg, trace_fn, ijkm, ray_grids, trace_tables)
    return chunk_post(cfg, ijkm, valid, ray_grids, res, gv_tables, dseed,
                      beam)


def reorder_chunk_core(cfg: dict, trace_fn, ijkm, valid, perm, ray_grids,
                       trace_tables, gv_tables, dseed, beam):
    """chunk_core for the counts-variant trace_fn: the chunk's rays arrive
    already permuted (``ijkm`` in window-sorted order, ``perm`` the
    permutation that produced it) and the kernel's per-lane micro-step
    counts come back scattered to NATURAL positions -- the next call's
    sort key. Shared by the single-device reorder pipeline and the
    mesh-sharded worker so the counts round-trip convention cannot
    diverge. Returns (image_partial, iang_partial, code, counts_nat)."""
    rays, _ = _chunk_rays(cfg, ijkm, ray_grids)
    res, cnt = trace_fn(rays, trace_tables)
    img_p, ang_p, code = chunk_post(cfg, ijkm, valid, ray_grids, res,
                                    gv_tables, dseed, beam)
    cnt_nat = jnp.zeros((perm.shape[0],), jnp.int32).at[perm].set(cnt)
    return img_p, ang_p, code, cnt_nat


def _stack_gv(gains, K):
    """Lineshape tables for segments 1..N-1 (segment 0 is never read); a
    single zero row keeps shapes valid for N=1 (no segments).

    Returned as HOST numpy: the split pipeline's whole point is to enqueue
    this transfer AFTER the trace dispatch so it rides the link during the
    trace (an eager ``jnp.asarray`` here would put it on the critical path
    ahead of every dispatch); the single-jit pipeline transfers it as an
    ordinary call argument."""
    if len(gains) <= 1:
        return np.zeros((1, 1, K), dtype=np.float32)
    return np.stack([
        np.asarray(g.gv, np.float32).reshape(-1, K) for g in gains[1:]])


def _entry_seed_host(seed, src, K):
    """Host-side per-axis seed factor tables at the entry grid points (the
    numpy companion of seed_ops.make_entry_seed_tables, feeding the packed
    transfer)."""
    from raytrace_tpu.ops import oracle

    class _T:
        pass

    t = _T()
    for name, grid, axis in (("tx", src.x, 0), ("ty", src.y, 1),
                             ("ta", src.a, 2), ("tb", src.b, 3)):
        pts = np.asarray(grid, np.float64).astype(np.float32).astype(np.float64)
        xi = np.asarray(seed.x[axis], np.float64)
        fi = np.asarray(seed.f[axis], np.float64)
        vals = np.array([oracle.interp_pchip(xi, fi, p) for p in pts])
        inside = (pts >= xi[0]) & (pts <= xi[-1])
        setattr(t, name, np.where(inside, vals, 0.0))
    t.fv = np.asarray(seed.f[4], np.float64)[:K]
    return t


def _fail_bits(code):
    """Fold per-ray error codes into the reference's failure bitmask
    (set_bit(-error), src/RayTraceImageCPU.cpp:34)."""
    return (
        jnp.where(jnp.any(code == -1), jnp.uint32(1 << 1), jnp.uint32(0))
        | jnp.where(jnp.any(code == -2), jnp.uint32(1 << 2), jnp.uint32(0))
        | jnp.where(jnp.any(code == -3), jnp.uint32(1 << 3), jnp.uint32(0))
    )


def make_stride_mapper(cfg: dict):
    """The N_start/N_parallel stride contract (RayTraceImage.cpp:300-328)
    as a function of the raw stride index: ``map_it(it) -> (ijkm, valid)``.
    The SINGLE source of the boundary conditions (it <= Nt//skip, ijkm <
    Nt, invalid clamp to 0) shared by every pipeline -- single-jit, split,
    reorder, and the mesh-sharded worker (which composes its own ``it``
    from the device stride)."""
    dims = cfg["dims"]
    Nt = dims[0] * dims[1] * dims[2] * dims[3]
    offset = cfg["N_start"]
    skip = cfg["N_parallel"]
    it_max = Nt // skip  # last valid stride index (RayTraceImage.cpp:304)

    def map_it(it):
        ijkm = offset + it * skip
        valid = (it <= it_max) & (ijkm < Nt)
        return jnp.where(valid, ijkm, 0), valid

    return map_it


def _make_chunk_indices(cfg: dict):
    """On-device ray-index generation for chunk ``ci`` under the stride
    contract -- the single-device composition over make_stride_mapper.
    Returns ``chunk_indices(ci, perm=None) -> (ijkm, valid, it)``; ``perm``
    optionally permutes the chunk's within-chunk positions (the
    cost-feedback reorder)."""
    chunk = cfg["chunk"]
    map_it = make_stride_mapper(cfg)

    def chunk_indices(ci, perm=None):
        pos = jnp.arange(chunk, dtype=jnp.int64) if perm is None \
            else perm.astype(jnp.int64)
        it = ci.astype(jnp.int64) * chunk + pos
        ijkm, valid = map_it(it)
        return ijkm, valid, it

    return chunk_indices


#: cost-feedback reorder window in rays. The micro-step census
#: (tools/steps_analysis.py, ROADMAP.md) showed window-local sorts at this
#: width capture ~all of the perfect-sort ceiling of the census model on the
#: divergent backward-ASE class while keeping every ray within 8192 of its
#: natural position (bounded spatial decoherence for the cell fetch).
_REORDER_WINDOW = 8192


def _window_perm(costs, window: int):
    """Window-local stable argsort: a permutation of ``range(len(costs))``
    that sorts each ``window``-sized block of positions by cost.

    Stable, so uniform costs (e.g. the all-zero feedback of a stream's
    first call) yield the identity permutation. The tail block is padded
    with int32-max sentinels, which sort strictly after every real count
    and land past the real length, so the static ``[:n]`` slice drops
    exactly them."""
    n = costs.shape[0]
    nw = -(-n // window)
    pad = nw * window - n
    c = jnp.pad(costs.astype(jnp.int32), (0, pad),
                constant_values=np.iinfo(np.int32).max)
    perm = jnp.argsort(c.reshape(nw, window), axis=1)
    perm = perm + (jnp.arange(nw, dtype=perm.dtype) * window)[:, None]
    return perm.reshape(-1)[:n]


def reorder_row_geom(problem):
    """Static geometry of the kernel's cell-fetch row grid, the primary
    reorder sort key: ``(y0, mean_dy, last_row)`` of the first traced
    segment's gain grid (segments 1..N-1 are the ones the kernel reads;
    shipped inputs have uniform geometry across segments). ``None`` when
    there is no readable row grid -- the reorder then falls back to the
    row-free window-local sort. Heuristic only: the row id never touches
    the physics, so an approximate (mean-spacing) id on non-uniform grids
    is fine."""
    if problem.N < 2 or len(problem.gain) < 2:
        return None
    g1 = problem.gain[1]
    if g1.Ny < 2 or g1.y is None:
        return None
    y1 = np.asarray(g1.y, np.float64)
    return (float(y1[0]), float(np.diff(y1).mean()), int(g1.Ny - 2))


def reorder_perm(cfg: dict, costs, ijkm_nat, ray_grids):
    """Within-chunk permutation for the cost-feedback reorder: stable
    argsort by ``(entry fetch row k2, previous-call micro-step count)``.

    Grouping by the entry fetch row keeps the cell fetch spatially
    coherent, which a pure cost sort destroys, while the within-row cost
    sort drains the idle-lane tail of each block. Rays at the same (x, y)
    differ only in angle, so sorting them across the whole chunk by cost
    keeps blocks row-pure AND cost-uniform. Whether this pays on the GPU
    is not measured yet.

    All-zero feedback (a stream's first call) keeps NATURAL order -- the
    first call stays bitwise identical to the synchronous pipeline (pinned
    by tests/test_reorder.py).

    Falls back to the window-local sort when the problem has no readable
    row geometry (``cfg['reorder_row'] is None``)."""
    n = costs.shape[0]
    row = cfg.get("reorder_row")
    if row is None:
        return _window_perm(costs, min(_REORDER_WINDOW, n))
    y0, dy, last = row
    _i, j, _k, _m = _unflatten_rays(ijkm_nat, cfg["dims"])
    y = ray_grids[1][j].astype(jnp.float32)
    # half-plane grids mirror y (RayTraceImageHelper.h:325-336); row id per
    # the census tooling (tools/bench_reorder.py)
    y_eff = jnp.abs(y) if y0 >= 0.0 else y
    k2 = jnp.clip(jnp.ceil((y_eff - y0) / dy) - 1.0, 0, last)
    key = (k2.astype(jnp.int64) * jnp.int64(2 ** 32)
           + jnp.clip(costs, 0, 2 ** 31 - 1).astype(jnp.int64))
    natural = jnp.arange(n, dtype=jnp.int64)
    key = jnp.where(jnp.any(costs > 0), key, natural)
    return jnp.argsort(key, stable=True).astype(jnp.int32)


def _make_reorder_pipeline(cfg: dict, trace_fn):
    """Cost-feedback-reordered pipeline: each chunk's rays are processed in
    (fetch-row, PREVIOUS call's per-ray micro-step count) order.

    The pallas kernel's per-block cost is the max total micro-step count
    over its lanes; on the divergent backward-ASE ray class the census
    model puts about half the lane rounds in the idle-lane tail
    (tools/steps_analysis.py). No static entry proxy predicts the cost
    (trajectory-dependent), but it is invariant under production-style
    table perturbation (corr 1.0 measured), so a serving stream can sort
    call k's rays by call k-1's measured counts -- the feedback loop this
    pipeline implements, entirely on device (no extra link traffic):

    * extra operand  ``prev_counts [n_chunks, chunk] i32`` (all-zero on the
      stream's first call -> natural order, bitwise-sync),
    * per chunk: (fetch-row, cost) argsort (:func:`reorder_perm`) ->
      permuted stride indices ``it`` ->
      trace (counts variant) -> the same deposits (order-invariant up to
      rounding; the reference's atomics make the same trade, SURVEY.md
      section 5 race detection),
    * extra outputs: this call's counts scattered back to natural order
      (the next call's sort key) and the permuted ``it`` per position (so
      the failure path can still name the physical ray).

    Image semantics vs the natural-order pipeline: identical up to
    scatter-add reassociation in the per-chunk f32 deposits (measured
    ~5e-8 relative on synthetics, bounded ~3e-7 at 500k-ray chunks --
    ops/binning.py:126 -- well under the 5e-6 golden gate); NOT bitwise,
    which is why ``reorder`` is opt-in on the stream.
    """
    K = cfg["K"]
    n_chunks = cfg["n_chunks"]
    img_rows = cfg["img_rows"]
    packed = cfg.get("pack_layout") is not None
    chunk_indices = _make_chunk_indices(cfg)

    @partial(jax.jit, donate_argnums=())
    def run_call(ray_grids, trace_tables, gv_tables, dseed, beam,
                 prev_counts):
        if packed:
            ray_grids_u, beam_u, dseed_u = unpack_bundle(cfg, ray_grids)
            if dseed_u is None:
                dseed_u = dseed
        else:
            ray_grids_u, beam_u, dseed_u = ray_grids, beam, dseed
        image0 = jnp.zeros((img_rows, K), dtype=jnp.float64)
        iang0 = jnp.zeros((cfg["na_nb"],), dtype=jnp.float64)

        def body(carry, xs):
            image_acc, iang_acc, fail_acc = carry
            ci, pc = xs
            ijkm_nat, _valid_nat, _it_nat = chunk_indices(ci)
            perm = reorder_perm(cfg, pc, ijkm_nat, ray_grids_u)
            ijkm, valid, it = chunk_indices(ci, perm)
            img_p, ang_p, code, cnt_nat = reorder_chunk_core(
                cfg, trace_fn, ijkm, valid, perm, ray_grids_u, trace_tables,
                gv_tables, dseed_u, beam_u)
            # it rides along so the (rare) failure path can name physical
            # rays; 4 B/ray of HBM writes (~40 us at seeded scale) that is
            # never fetched over the link unless a ray fails
            return ((image_acc + img_p, iang_acc + ang_p,
                     fail_acc | _fail_bits(code)),
                    (code, cnt_nat, it.astype(jnp.int32)))

        (image, i_ang, fail), (codes, counts, it_all) = jax.lax.scan(
            body, (image0, iang0, jnp.uint32(0)),
            (jnp.arange(n_chunks, dtype=jnp.int32), prev_counts))
        return image, i_ang, fail, codes, counts, it_all

    return run_call


def _make_split_pipeline(cfg: dict, trace_fn):
    """Two-dispatch pipeline overlapping the gv upload with the trace.

    An async ``device_put`` overlaps a running execution, and the gv
    lineshape tables (1.15 MB of ASE_small's 1.8 MB upload) are only needed
    by the amplify stage. So the call becomes: dispatch TRACE (needs pack + trace tables),
    ship gv during it, dispatch AMPLIFY+BIN on the resident trace results.
    Gated by prepare_pipeline to calls whose stacked trace results are
    small (ASE-class); the single-jit pipeline remains the general path.
    """
    n_chunks = cfg["n_chunks"]
    K = cfg["K"]
    img_rows = cfg["img_rows"]
    chunk_indices = _make_chunk_indices(cfg)

    @jax.jit
    def run_trace(pack, trace_tables):
        ray_grids_u, _beam, _dseed = unpack_bundle(cfg, pack)

        def body(_, ci):
            ijkm, _valid, _it = chunk_indices(ci)
            res = chunk_trace(cfg, trace_fn, ijkm, ray_grids_u, trace_tables)
            return (), res

        _, res_all = jax.lax.scan(body, (), jnp.arange(n_chunks, dtype=jnp.int32))
        return res_all

    @jax.jit
    def run_post(pack, gv_tables, res_all, dseed):
        ray_grids_u, beam_u, dseed_u = unpack_bundle(cfg, pack)
        if dseed_u is None:
            dseed_u = dseed
        image0 = jnp.zeros((img_rows, K), dtype=jnp.float64)
        iang0 = jnp.zeros((cfg["na_nb"],), dtype=jnp.float64)

        def body(carry, xs):
            image_acc, iang_acc, fail_acc = carry
            ci, res = xs
            ijkm, valid, _it = chunk_indices(ci)
            img_p, ang_p, code = chunk_post(cfg, ijkm, valid, ray_grids_u,
                                            res, gv_tables, dseed_u, beam_u)
            return ((image_acc + img_p, iang_acc + ang_p,
                     fail_acc | _fail_bits(code)), code)

        (image, i_ang, fail), codes = jax.lax.scan(
            body, (image0, iang0, jnp.uint32(0)),
            (jnp.arange(n_chunks, dtype=jnp.int32), res_all))
        return image, i_ang, fail, codes

    def run_call(pack, trace_tables, gv_tables, dseed, beam):
        res_all = run_trace(pack, trace_tables)   # async dispatch
        gv_dev = jax.device_put(gv_tables)        # rides the link during it
        return run_post(pack, gv_dev, res_all, dseed)

    return run_call


def _make_pipeline(cfg: dict, trace_fn):
    """Build the jitted whole-call pipeline: a lax.scan over ray chunks.

    One device dispatch per ``create_image`` call; ray indices are generated
    on device from the stride contract, so the only per-call host traffic is
    the problem tables (which the reference also re-uploads per call).
    ``cfg['split']`` selects the two-dispatch upload-overlap variant.
    """
    if cfg.get("split"):
        return _make_split_pipeline(cfg, trace_fn)
    K = cfg["K"]
    dense = cfg.get("dense", False)
    dims = cfg["dims"]
    chunk = cfg["chunk"]
    n_chunks = cfg["n_chunks"]
    img_rows = cfg["img_rows"]
    rows_per_chunk = chunk // (dims[2] * dims[3]) if dense else 0
    chunk_indices = _make_chunk_indices(cfg)

    packed = cfg.get("pack_layout") is not None

    @partial(jax.jit, donate_argnums=())
    def run_call(ray_grids, trace_tables, gv_tables, dseed, beam):
        if packed:
            # ray_grids carries the single packed transfer
            ray_grids_u, beam_u, dseed_u = unpack_bundle(cfg, ray_grids)
            if dseed_u is None:
                dseed_u = dseed
        else:
            ray_grids_u, beam_u, dseed_u = ray_grids, beam, dseed
        image0 = jnp.zeros((img_rows, K), dtype=jnp.float64)
        iang0 = jnp.zeros((cfg["na_nb"],), dtype=jnp.float64)

        def body(carry, ci):
            image_acc, iang_acc, fail_acc = carry
            ijkm, valid, _it = chunk_indices(ci)
            img_p, ang_p, code = chunk_core(cfg, trace_fn, ijkm, valid,
                                            ray_grids_u, trace_tables,
                                            gv_tables, dseed_u, beam_u)
            if dense:
                r0 = (ci * rows_per_chunk).astype(jnp.int32)
                z0 = jnp.int32(0)
                rows = img_p.shape[0]
                cur = jax.lax.dynamic_slice(image_acc, (r0, z0), (rows, K))
                image_new = jax.lax.dynamic_update_slice(
                    image_acc, cur + img_p, (r0, z0))
            else:
                image_new = image_acc + img_p
            return ((image_new, iang_acc + ang_p,
                     fail_acc | _fail_bits(code)), code)

        (image, i_ang, fail), codes = jax.lax.scan(
            body, (image0, iang0, jnp.uint32(0)),
            jnp.arange(n_chunks, dtype=jnp.int32))
        return image, i_ang, fail, codes

    return run_call


def _lax_exact_factory(cfg):
    """Reference-parity backend: exact f64 grid tables + bisection searches
    (ops/stepper.py). Handles non-uniform gain grids."""
    N, dz, c = cfg["N"], cfg["dz"], cfg["c"]
    method, use_emis = cfg["method"], cfg["use_emis"]

    def trace_fn(rays, tables):
        return stepper.trace_batch(rays, N, dz, tables, method, c=c,
                                   use_emis=use_emis)

    return _make_pipeline(cfg, trace_fn)


def _lax_fast_factory(cfg):
    """Fast backend: one-hot table fetch + uniform-grid arithmetic
    (ops/fast_stepper.py). ``cfg['fast_meta']`` carries the static geometry."""
    N, dz, c = cfg["N"], cfg["dz"], cfg["c"]
    method, use_emis = cfg["method"], cfg["use_emis"]
    meta, nch, nyc = cfg["fast_meta"]

    def trace_fn(rays, tx):
        ft = fast_stepper.FastTables(tx=tx, meta=meta, nch=nch, ny_cells=nyc)
        return fast_stepper.trace_batch_fast(rays, N, dz, ft, method, c=c,
                                             use_emis=use_emis)

    return _make_pipeline(cfg, trace_fn)


def make_pallas_trace_fn(cfg, counts: bool = False):
    """Build the pallas-backend trace_fn from a pipeline cfg.

    Shared by the single-device pipeline (_pallas_factory) and the multi-chip
    shard_map path (parallel/sharding.py) -- the reference's multi-GPU path
    likewise drives its fastest (CUDA) backend per device
    (src/RayTraceImage.cpp:396-405). On the CPU platform the kernel runs
    through the Pallas interpreter (ops/pallas_kernel.interpret_default), so
    the virtual CPU mesh executes the same kernel semantics.

    With ``counts`` the kernel's per-lane micro-step counter variant runs
    and the trace_fn returns ``(TraceResult, counts[B] int32)`` -- the
    cost-feedback reorder signal (see create_image_stream's ``reorder``).
    """
    from raytrace_tpu.ops import pallas_kernel as pk

    N, dz, c = cfg["N"], cfg["dz"], cfg["c"]
    method = cfg["method"]
    meta, nch, nyc, nonuniform = cfg["pallas_meta"]

    def trace_fn(rays, tables):
        tx, xg, yg = tables
        pg = pk.PackedGain(tables=tx, xg=xg, yg=yg, meta=meta, nch=nch,
                           ny_cells=nyc, nonuniform=nonuniform)
        return pk.trace_rays(rays, N, dz, pg, method, c=c, counts=counts)

    return trace_fn


def _pallas_factory(cfg):
    """Pallas-Triton kernel backend (ops/pallas_kernel.py): one ray per
    lane, the whole loop nest per block of rays inside one kernel, so each
    block's trip count is set by its own slowest ray rather than the
    chunk's -- the design of the reference's CUDA path
    (src/RayTraceImageCuda.cu).
    """
    if cfg.get("reorder"):
        return _make_reorder_pipeline(
            cfg, make_pallas_trace_fn(cfg, counts=True))
    return _make_pipeline(cfg, make_pallas_trace_fn(cfg))


BACKENDS["lax-exact"] = _lax_exact_factory
BACKENDS["lax"] = _lax_fast_factory
BACKENDS["pallas"] = _pallas_factory


#: drop-in aliases for the reference's compute_method names
#: (src/RayTraceImage.cpp:333-423): every reference backend maps onto the
#: XLA dispatch; "cuda"-class methods map to the Pallas kernel
_METHOD_ALIASES = {
    "cpu": "lax-exact", "threads": "lax", "openmp": "lax",
    "kokkos-serial": "lax-exact", "kokkos-openmp": "lax",
    "kokkos-thread": "lax", "kokkos-cuda": "pallas",
    "cuda": "pallas", "cuda-multigpu": "pallas", "openacc": "lax",
}


def resolve_bin_deposit(deposit: str) -> str:
    """Deposit-strategy policy, shared verbatim by the single-device and
    mesh-sharded pipelines (the reference's multi-GPU path drives the same
    fastest kernel per device, src/RayTraceImage.cpp:396-405).

    ``auto`` is the ``segment_sum`` scatter on every backend; the one-hot
    matmul deposit (f32-internal) runs only when asked for.
    """
    if deposit == "auto":
        return "scatter"
    if deposit in ("matmul", "scatter", "dense"):
        return deposit if deposit != "dense" else "scatter"
    raise err_util.RayTraceError(
        f"Unknown deposit strategy '{deposit}' "
        "(expected auto/dense/matmul/scatter)")


def available_methods() -> list[str]:
    """Every backend available on this host, slowest first.

    The reference benchmarks all compiled-in methods when ``-methods=`` is
    absent ("Default is all availible methods",
    src/CreateImageHelpers.h:61); availability here means the backend can
    run at full speed -- the pallas kernel counts only on the GPU (on the
    CPU it would run through the interpreter, the analogue of a CUDA method
    with no GPU present).
    """
    methods = ["lax-exact", "lax"]
    if jax.default_backend() == "gpu":
        methods.append("pallas")
    return methods


def _resolve_backend(name: str, pallas_ok: bool,
                     fast_ok: bool | None = None) -> str:
    """``pallas_ok``: inside the pallas kernel's envelope
    (pallas_kernel.fits_pallas -- one y-mirror convention, a channel table
    the int32 gather offsets can index); ``fast_ok``: uniform
    grids narrow enough for the lax fast backend's one-hot lane tables
    (fast_stepper.fits_fast). Out-of-envelope requests fall back to
    lax-exact (the general-geometry backend) instead of raising."""
    if fast_ok is None:
        fast_ok = pallas_ok
    name = name.lower()
    name = _METHOD_ALIASES.get(name, name)
    if name == "auto":
        # on the GPU the kernel: 37x (ASE) and 58x (seeded) faster end to
        # end than lax at the production shapes on an H100 at 400 W
        # (PERF.md); lax elsewhere
        if pallas_ok and jax.default_backend() == "gpu":
            name = "pallas"
        else:
            name = "lax" if fast_ok else "lax-exact"
    if name == "pallas" and not pallas_ok:
        name = "lax-exact"
    if name == "lax" and not fast_ok:
        name = "lax-exact"
    if name not in BACKENDS:
        raise err_util.RayTraceError(f"Unknown method: {name}")
    return name


def resolve_method(problem: "CreateImageProblem",
                   compute_method: str = "auto") -> str:
    """The backend a ``create_image`` call on this problem would actually
    execute, after alias resolution and envelope fallbacks (pallas/lax fall
    back to lax-exact outside their geometry envelope). Cheap -- no table
    packing -- so harnesses can label benchmark rows with the backend that
    really ran instead of the one that was requested."""
    use_emis = problem.gain[0].E0 is not None and problem.seed is None
    from raytrace_tpu.ops import pallas_kernel as pk
    pallas_ok = pk.fits_pallas(problem.gain, use_emis) and problem.N > 1
    return _resolve_backend(compute_method, pallas_ok,
                            fast_stepper.fits_fast(problem.gain))


class PreparedCall(NamedTuple):
    """The prepare/execute split of a ``create_image`` call.

    ``pipeline(*operands)`` runs the whole jitted call (upload of the
    packed problem tables + chunked scan + on-device accumulation) and
    returns device arrays. Used by :func:`create_image`,
    :func:`create_image_stream` and the benchmark, which times the stages
    of exactly the production pipeline.
    """
    pipeline: Callable
    #: (packed ray-grid bundle, trace tables, gv tables, seed_dev, beam_dev)
    operands: tuple
    cfg: dict
    timer_name: str


class CommonPrep(NamedTuple):
    """Problem-dependent state shared by the single-chip and sharded
    prepares: validation happened, the backend is resolved, tables are
    packed, the bundle is built. Chunk policy and pipeline construction
    remain per-path."""
    backend: str
    method: int
    scale: float
    dims: tuple
    use_emis: bool
    K: int
    trace_tables: object
    fast_meta: object
    pallas_meta: object
    gv_tables: object
    seed_dev: object
    seed_f0: float
    pack: object
    pack_layout: object
    beam_scalars: object
    bin_deposit: str
    timer_name: str


def prepare_common(problem: CreateImageProblem, compute_method: str,
                   spectrum_dtype, deposit: str) -> CommonPrep:
    """Validate the problem, resolve the backend and pack its tables --
    everything a ``create_image`` call needs before the (single-chip or
    mesh-sharded) chunk policy. One implementation so the two paths can
    never diverge on validation or packing."""
    if problem.N > N_MAX:
        raise err_util.RayTraceError("Exceeded maximum number of length segments")
    if problem.euv_beam.nv >= K_MAX:
        raise err_util.RayTraceError("Exceeded maximum number of frequencies")

    beam = problem.euv_beam
    for g, d in ((beam.x, beam.dx), (beam.y, beam.dy),
                 (beam.a, beam.da), (beam.b, beam.db)):
        if _check_grid(len(g), d, g):
            raise err_util.RayTraceError(
                "Only uniform grid spacings are currently supported (euv_beam)")
    if problem.seed_beam is not None:
        sb = problem.seed_beam
        for g, d in ((sb.x, sb.dx), (sb.y, sb.dy), (sb.a, sb.da), (sb.b, sb.db)):
            if _check_grid(len(g), d, g):
                raise err_util.RayTraceError(
                    "Only uniform grid spacings are currently supported (seed_beam)")
        if (beam.y[0] >= 0.0) != (sb.y[0] >= 0.0):
            raise err_util.RayTraceError(
                "Negitive y positions in seed_beam or euv_beam, but not both")

    if problem.seed is not None:
        method = 2
        src = problem.seed_beam
        scale = (src.dx * src.dy * src.da * src.db) / (beam.dx * beam.dy)
        timer_name = "propagate_seed"
    else:
        method = 1
        src = beam
        scale = 1.0
        timer_name = "propagate_ASE"
    dims = (src.nx, src.ny, src.na, src.nb)

    use_emis = problem.gain[0].E0 is not None and problem.seed is None
    from raytrace_tpu.ops import pallas_kernel as pk
    # the pallas kernel's per-segment outputs are zero-width at N <= 1 (no
    # propagation segments); the lax tier handles that edge directly
    pallas_ok = pk.fits_pallas(problem.gain, use_emis) and problem.N > 1
    fast_ok = fast_stepper.fits_fast(problem.gain)
    backend = _resolve_backend(compute_method, pallas_ok, fast_ok)
    timer_name += "-" + backend
    K = beam.nv

    # host -> device conversion of the problem tables. Inside the timed
    # region on purpose: the reference re-uploads per call because the
    # production gain tables change every iteration (Readme.txt:43).
    pallas_meta = None
    if backend == "lax":
        ft = fast_stepper.pack_fast_tables(problem.gain, use_emis)
        trace_tables = ft.tx
        fast_meta = (ft.meta, ft.nch, ft.ny_cells)
        # the spectrum only needs the lineshape rows of segments 1..N-1
        gv_tables = _stack_gv(problem.gain, K)
    elif backend == "pallas":
        pg = pk.pack_gain_tables(problem.gain, use_emis)
        trace_tables = (pg.tables, pg.xg, pg.yg)
        fast_meta = None
        pallas_meta = (pg.meta, pg.nch, pg.ny_cells, pg.nonuniform)
        gv_tables = _stack_gv(problem.gain, K)
    else:
        trace_tables = prepare_gain(problem.gain)
        fast_meta = None
        gv_tables = trace_tables.gv[1:]
    # one packed transfer for all the small per-call arrays; the
    # backward-seeded path (general pchip at exit coords) keeps the full
    # device-seed pytree as a separate operand
    entry_seed_host = None
    seed_dev = None
    seed_f0 = 0.0
    if problem.seed is not None:
        if method == 2:
            entry_seed_host = _entry_seed_host(problem.seed, src, K)
            seed_f0 = float(problem.seed.f0)
        else:
            seed_dev = prepare_seed(problem.seed)
    pack, pack_layout, beam_scalars = make_bundle_pack(
        beam, src, entry_seed_host)
    bin_deposit = resolve_bin_deposit(deposit)
    return CommonPrep(backend=backend, method=method, scale=scale, dims=dims,
                      use_emis=use_emis, K=K, trace_tables=trace_tables,
                      fast_meta=fast_meta, pallas_meta=pallas_meta,
                      gv_tables=gv_tables, seed_dev=seed_dev, seed_f0=seed_f0,
                      pack=pack, pack_layout=pack_layout,
                      beam_scalars=beam_scalars, bin_deposit=bin_deposit,
                      timer_name=timer_name)


def prepare_pipeline(problem: CreateImageProblem,
                     compute_method: str = "auto",
                     chunk_size: int | None = None,
                     spectrum_dtype=jnp.float32, c: float = 0.5,
                     deposit: str = "auto",
                     reorder: bool = False) -> PreparedCall:
    """Validate the problem, pack its tables, resolve the static config and
    fetch (compiling if needed) the cached whole-call pipeline.

    Host-side packing happens here; the host->device transfer happens when
    the returned pipeline is invoked with the returned operands (inside the
    timed region on purpose: the reference re-uploads per call because the
    production gain tables change every iteration, Readme.txt:43).

    ``reorder`` requests the cost-feedback-reordered pipeline (an extra
    ``prev_counts`` operand and extra outputs -- see
    :func:`_make_reorder_pipeline`); it takes effect only where the
    feedback signal exists (pallas backend, positional-order-free deposits)
    and is silently off elsewhere -- the same fall-back-to-what-runs policy
    as the backend envelope checks. Check ``cfg['reorder']`` for what was
    actually built.
    """
    from raytrace_tpu.ops import pallas_kernel as pk
    cp = prepare_common(problem, compute_method, spectrum_dtype, deposit)
    beam = problem.euv_beam
    backend, method, scale, dims = cp.backend, cp.method, cp.scale, cp.dims
    use_emis, K = cp.use_emis, cp.K
    trace_tables, fast_meta, pallas_meta = (cp.trace_tables, cp.fast_meta,
                                            cp.pallas_meta)
    gv_tables, seed_dev, seed_f0 = cp.gv_tables, cp.seed_dev, cp.seed_f0
    ray_grids, pack_layout, beam_scalars = (cp.pack, cp.pack_layout,
                                            cp.beam_scalars)
    timer_name = cp.timer_name
    nx, ny, na, nb = beam.nx, beam.ny, beam.na, beam.nb
    beam_dev = None

    Nt = dims[0] * dims[1] * dims[2] * dims[3]
    skip = problem.N_parallel
    B_total = len(range(problem.N_start, Nt, skip)) if problem.N_start < Nt else 0
    # deposit strategy: "dense" (pure reduction; needs the full natural-order
    # grid, method 1), "matmul" (one-hot matrix product, on request),
    # "scatter" (segment_sum; the default).
    dense = (method == 1 and problem.N_start == 0 and problem.N_parallel == 1
             and B_total == Nt and deposit == "dense")
    bin_deposit = cp.bin_deposit
    blk = dims[2] * dims[3]
    auto_chunk = chunk_size is None
    if auto_chunk:
        # the lax stepper's batched while loops run every lane of a chunk to
        # the chunk's slowest ray, so its chunks stay small. The kernel
        # bounds divergence per block of pk.BLOCK rays, so its chunk (512
        # blocks) only sets the scan length and the trace-result buffer.
        if backend == "pallas":
            chunk_size = 65536
        else:
            chunk_size = 16384 if B_total < 2_000_000 else 32768
    chunk = min(chunk_size, max(B_total, 1))
    if backend == "pallas":
        # whole kernel blocks (the kernel pads a partial block with dead
        # rays); the dense (pure-reduction) deposit additionally needs whole
        # (na*nb) blocks, so align the chunk to lcm(BLOCK, na*nb)
        align = math.lcm(pk.BLOCK, blk) if dense else pk.BLOCK
        chunk = max(align, (chunk // align) * align)
        if auto_chunk and B_total > chunk:
            # minimize last-chunk padding: the largest align-multiple that
            # covers B_total in the same number of chunks (ASE_small: 7 x
            # 65536 would pad 13% dead rays, 7 x 57088 pads 0.2%)
            n = math.ceil(B_total / chunk)
            chunk = min(chunk, math.ceil(math.ceil(B_total / n) / align)
                        * align)
    elif dense:
        chunk = max(blk, (chunk // blk) * blk)

    n_chunks = math.ceil(B_total / chunk) if B_total else 0
    if dense:
        # pad the row space so the last chunk's dynamic_update_slice window
        # never clamps (clamping would silently shift the deposit rows)
        img_rows = max(nx * ny, n_chunks * (chunk // blk))
    else:
        img_rows = nx * ny
    # two-dispatch upload-overlap pipeline (gv ships during the trace):
    # only when the stacked trace results stay small (ASE-class workloads;
    # the seeded 7.8M-ray stack would be ~0.6 GB for a ~3% win)
    # cost-feedback reorder: needs the pallas counts variant and deposits
    # that key on ray attributes, not chunk position (dense deposits rows
    # positionally); the failure path rides stride indices as int32, so
    # absurdly large stride spaces keep natural order. The reorder
    # pipeline is single-jit; it forgoes the split upload overlap (its
    # targets are compute-bound workloads where the trace, not the link,
    # dominates).
    reorder = bool(reorder) and backend == "pallas" and not dense \
        and n_chunks > 0 and Nt // skip < 2 ** 31
    reorder_row = reorder_row_geom(problem) if reorder else None
    nseg = max(problem.N - 1, 1)
    trace_bytes = n_chunks * chunk * (36 * nseg + 18)
    split = ((not dense) and (not reorder) and n_chunks > 0
             and trace_bytes <= _SPLIT_MAX_BYTES
             and os.environ.get("RAYTRACE_NO_SPLIT") != "1")
    cfg_key = (backend, problem.N, float(beam.dz), K, method, use_emis, dims,
               float(scale), str(jnp.dtype(spectrum_dtype)), float(c), chunk,
               dense, bin_deposit, n_chunks, problem.N_start,
               problem.N_parallel, fast_meta, pallas_meta, pack_layout,
               beam_scalars, seed_f0, split, reorder, reorder_row)
    cfg = dict(N=problem.N, dz=float(beam.dz), K=K, method=method,
               use_emis=use_emis, dims=dims, scale=float(scale),
               spectrum_dtype=spectrum_dtype, c=float(c), dense=dense,
               bin_deposit=bin_deposit,
               chunk=chunk, n_chunks=n_chunks, img_rows=img_rows,
               na_nb=na * nb, N_start=problem.N_start,
               N_parallel=problem.N_parallel, fast_meta=fast_meta,
               pallas_meta=pallas_meta, pack_layout=pack_layout,
               beam_scalars=beam_scalars, seed_f0=seed_f0,
               split=split, reorder=reorder, reorder_row=reorder_row)
    if cfg_key not in _PIPELINE_CACHE:
        _PIPELINE_CACHE[cfg_key] = BACKENDS[backend](cfg)
    return PreparedCall(
        pipeline=_PIPELINE_CACHE[cfg_key],
        operands=(ray_grids, trace_tables, gv_tables, seed_dev, beam_dev),
        cfg=cfg, timer_name=timer_name)


def create_image(problem: CreateImageProblem, compute_method: str = "auto",
                 chunk_size: int | None = None, spectrum_dtype=jnp.float32,
                 c: float = 0.5, deposit: str = "auto",
                 failed_ray_path: str = "Failed_RayTrace_rays.dat",
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Compute the near-field image and far-field angular image.

    Returns ``(image, I_ang)`` as float64 numpy arrays in the reference's
    flat layouts ``image[nv*(i1+i2*nx)+iv]`` and ``I_ang[i3+i4*na]``; they
    are also stored on ``problem.image`` / ``problem.I_ang``.
    """
    profiler.start("create_image")
    try:
        prep = prepare_pipeline(problem, compute_method, chunk_size,
                                spectrum_dtype, c, deposit)
    except Exception:
        profiler.stop("create_image")
        raise

    profiler.start(prep.timer_name)
    try:
        outs = prep.pipeline(*prep.operands)
        return _finalize_call(problem, prep, outs, failed_ray_path)
    finally:
        profiler.stop(prep.timer_name)
        profiler.stop("create_image")


def _finalize_call(problem: CreateImageProblem, prep: PreparedCall, outs,
                   failed_ray_path: str) -> tuple[np.ndarray, np.ndarray]:
    """Blocking tail of a dispatched call: readback, failure path, layout
    fixup, store on the problem. Shared by :func:`create_image` and
    :func:`create_image_stream`."""
    cfg = prep.cfg
    beam = problem.euv_beam
    src = problem.seed_beam if problem.seed is not None else beam
    method, dims, dense = cfg["method"], cfg["dims"], cfg["dense"]
    K, nx, ny = cfg["K"], beam.nx, beam.ny

    # reorder pipelines append (counts, it) outputs: counts feed the next
    # stream call; it maps permuted positions back to physical rays. Keyed
    # on the cfg (not tuple length) so a future >4-output variant cannot
    # be silently misread as permuted indices.
    image_d, iang_d, fail_acc, codes_all = outs[:4]
    it_all = outs[5] if prep.cfg.get("reorder") else None
    # single blocking readback (one device->host round trip)
    image, i_ang, fail_bits = jax.device_get((image_d, iang_d, fail_acc))
    fail_bits = int(fail_bits)

    # failure path (RayTraceImage.cpp:427-430)
    if fail_bits != 0:
        failed_rays = []
        codes_flat = np.asarray(codes_all).reshape(-1)
        its = (np.asarray(it_all).reshape(-1)
               if it_all is not None else None)
        for bidx in np.nonzero(codes_flat < 0)[0][: err_util.N_FAILED_MAX]:
            stride_it = int(its[bidx]) if its is not None else int(bidx)
            gidx = problem.N_start + stride_it * problem.N_parallel
            gi, gj, gk, gm = (np.asarray(v) for v in _unflatten_rays(
                jnp.asarray(gidx), dims))
            failed_rays.append(np.array(
                [src.x[gi], src.y[gj], src.a[gk], src.b[gm]], np.float32))
        for msg in err_util.failure_messages(fail_bits):
            print(msg)
        err_util.write_failures(failed_ray_path, fail_bits,
                                np.array(failed_rays), method, problem.N,
                                beam.dz, problem.gain)
        raise err_util.RayTraceError("Some rays failed")

    if dense:
        # dense accumulation is i-major [i*ny + j]; reference layout is
        # image[nv*(i1 + i2*nx) + iv] = [j, i, v] C-order
        image_np = (image[: nx * ny]
                    .reshape(nx, ny, K).transpose(1, 0, 2).reshape(-1).copy())
    else:
        image_np = image.reshape(-1)
    i_ang_np = i_ang
    problem.image = image_np
    problem.I_ang = i_ang_np
    return image_np, i_ang_np


def create_image_stream(problems, compute_method: str = "auto",
                        chunk_size: int | None = None,
                        spectrum_dtype=jnp.float32, c: float = 0.5,
                        deposit: str = "auto", depth: int = 2,
                        failed_ray_path: str = "Failed_RayTrace_rays.dat",
                        mesh=None, reorder: bool = False):
    """Overlapped execution over a sequence of independent work units.

    Yields ``(image, I_ang)`` per problem, exactly as :func:`create_image`
    would return for each -- same fresh-table upload per call (the
    reference's per-call re-upload semantics, Readme.txt:43), same failure
    path, same layouts. Throughput improves because up to ``depth`` calls
    are in flight: call k+1's host-side packing and table upload ride the
    device link while call k computes, and call k's image readback overlaps
    call k+1's compute (JAX dispatch is asynchronous; the only blocking
    point is each call's readback, taken one call behind the dispatch
    front).

    The reference harness has no analogue -- it times synchronous calls
    (src/CreateImage.cpp:147-153) -- so bench.py's headline numbers remain
    synchronous; this is the serving-mode executor for *independent* work
    units (parameter scans, snapshot batches). ``depth`` bounds in-flight
    device memory (each in-flight call holds its tables + outputs; the
    default 2 = classic double buffering).

    With ``mesh`` (a ``jax.sharding.Mesh``), every call runs the
    ray-sharded multi-chip pipeline (``create_image_sharded`` semantics:
    stride decomposition + end-of-call psum) with the same cross-call
    overlap -- serving mode over the whole mesh. ``reorder`` composes:
    each shard sorts its own rays by its own previous counts (the feedback
    arrays stay device-sharded; nothing extra crosses devices or the host link).

    ``reorder`` turns on the cost-feedback ray reorder: each call's rays
    run in window-local order of the previous call's measured per-ray
    micro-step counts (see :func:`_make_reorder_pipeline`). Per-ray cost is
    invariant under production-style table perturbation, so the previous
    call is a near-perfect sort key for same-shaped work units; the first
    call (and any shape change) runs in natural order. Opt-in because the
    permuted deposits reassociate the per-chunk f32 scatter adds --
    results match the natural-order executor to fp-reassociation level
    (well under the 5e-6 golden gate), not bitwise.
    """
    if depth < 1:
        raise err_util.RayTraceError("create_image_stream needs depth >= 1")
    from collections import deque

    feedback = {"key": None, "counts": None}

    if mesh is None:
        def _prep(problem):
            return prepare_pipeline(problem, compute_method, chunk_size,
                                    spectrum_dtype, c, deposit,
                                    reorder=reorder)
        _fin = _finalize_call
    else:
        from raytrace_tpu.parallel import sharding

        def _prep(problem):
            return sharding.prepare_sharded(problem, mesh, compute_method,
                                            chunk_size, spectrum_dtype, c,
                                            deposit, reorder=reorder)
        _fin = sharding._finalize_sharded

    in_flight = deque()
    profiler.start("create_image_stream")
    try:
        for problem in problems:
            # retire the oldest call BEFORE dispatching the next one, so at
            # most ``depth`` calls are ever dispatched-but-unread (the
            # documented in-flight memory bound)
            if len(in_flight) >= depth:
                p, pr, o = in_flight.popleft()
                yield _fin(p, pr, o, failed_ray_path)
            prep = _prep(problem)
            if prep.cfg.get("reorder"):
                # sort key = the most recently DISPATCHED call's counts
                # (device-resident; the dependency resolves on device, so
                # the cross-call upload/readback overlap is unaffected)
                key = (prep.cfg["n_chunks"], prep.cfg["chunk"],
                       prep.cfg["dims"], prep.cfg["N_start"],
                       prep.cfg["N_parallel"])
                if feedback["key"] == key:
                    pc = feedback["counts"]
                else:  # first call / shape change: natural order.
                    # Created with the pipeline's own input sharding so the
                    # first call compiles the same program as every later
                    # one (and on a mesh, a host-local default-device array
                    # would not even be a valid input for a multi-process
                    # jit); zeros materialize on device -- no link upload.
                    shape = (prep.cfg["n_chunks"], prep.cfg["chunk"])
                    if mesh is not None:
                        from jax.sharding import (NamedSharding,
                                                  PartitionSpec as _P)
                        from raytrace_tpu.parallel.mesh import RAY_AXIS
                        pc = jnp.zeros(shape, jnp.int32,
                                       device=NamedSharding(
                                           mesh, _P(None, RAY_AXIS)))
                    else:
                        pc = jnp.zeros(shape, jnp.int32)
                outs = prep.pipeline(*prep.operands, pc)
                feedback["key"], feedback["counts"] = key, outs[4]
            else:
                outs = prep.pipeline(*prep.operands)  # asynchronous dispatch
            in_flight.append((problem, prep, outs))
        while in_flight:
            p, pr, o = in_flight.popleft()
            yield _fin(p, pr, o, failed_ray_path)
    finally:
        profiler.stop("create_image_stream")
