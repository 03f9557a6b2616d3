"""Multi-chip ``create_image``: shard_map over a device mesh.

The reference's multi-device story (SURVEY.md section 2.4):

* "Cuda-MultiGPU": one thread per GPU, each GPU a contiguous ray chunk,
  host-side image sum (src/RayTraceImage.cpp:396-405);
* production MPI: stride decomposition of rays across ranks
  (N_start/N_parallel) + MPI_Allreduce of the image buffers
  (src/RayTraceStructures.cpp:1603-1646).

Equivalent here: rays are stride-decomposed across a 1-D mesh exactly like
the MPI contract (device d of D takes rays d, d+D, 2D, ...); each device
runs the whole chunked scan pipeline on its shard, and the accumulated
images meet in a single ``jax.lax.psum`` over the interconnect at the end
of the call.
A 1-device mesh degrades to the serial path (the no-MPI shim analogue).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from raytrace_tpu.models import ray_tracer

from raytrace_tpu.ops import fast_stepper, stepper
from raytrace_tpu.parallel.mesh import RAY_AXIS
from raytrace_tpu.structures import CreateImageProblem
from raytrace_tpu.utils import errors as err_util
from raytrace_tpu.utils.timer import profiler

__all__ = ["create_image_sharded", "make_sharded_pipeline",
           "prepare_sharded"]

_SHARDED_CACHE: dict = {}


def make_sharded_pipeline(cfg: dict, trace_fn, mesh: Mesh):
    """Jitted sharded whole-call pipeline.

    Each device scans its chunks with device-strided on-device ray indices
    (it = ci*chunk + d + j*D inside chunk windows), accumulating partial
    images; one psum reduces at the end (the MPI_Allreduce analogue).

    With ``cfg['reorder']`` the cost-feedback reorder runs PER DEVICE: each
    shard sorts its own per-chunk positions by (entry fetch row, its own
    previous-call counts) -- ray_tracer.reorder_perm nested inside the
    device stride -- takes a [n_chunks, chunk]-global ``prev_counts`` operand
    sharded over the ray axis, and returns (counts, it) extra outputs with
    the same sharding -- the feedback loop never crosses devices or the
    link.
    """
    D = mesh.size
    chunk = cfg["chunk"]           # global rays per scan step
    per_dev = chunk // D
    n_chunks = cfg["n_chunks"]
    K = cfg["K"]
    map_it = ray_tracer.make_stride_mapper(cfg)
    reorder = cfg.get("reorder", False)

    def worker(pack, trace_tables, gv_tables, dseed, prev_counts=None):
        d = jax.lax.axis_index(RAY_AXIS).astype(jnp.int64)
        ray_grids, beam, dseed_u = ray_tracer.unpack_bundle(cfg, pack)
        if dseed_u is None:
            dseed_u = dseed
        image0 = jnp.zeros((cfg["img_cells"], K), dtype=jnp.float64)
        iang0 = jnp.zeros((cfg["na_nb"],), dtype=jnp.float64)

        def body(carry, xs):
            image_acc, iang_acc, fail3 = carry
            if reorder:
                ci, pc = xs
                # natural ijkm first: the reorder sort key needs each
                # position's entry row (ray_tracer.reorder_perm)
                it_nat = (ci.astype(jnp.int64) * chunk + d
                          + jnp.arange(per_dev, dtype=jnp.int64) * D)
                ijkm_nat, _ = map_it(it_nat)
                perm = ray_tracer.reorder_perm(cfg, pc, ijkm_nat, ray_grids)
                pos = perm.astype(jnp.int64)
            else:
                ci = xs
                pos = jnp.arange(per_dev, dtype=jnp.int64)
            # device stride nested under the rank stride: per-device
            # position j maps to it = ci*chunk + d + j*D; the boundary
            # conditions come from the shared stride mapper
            it = ci.astype(jnp.int64) * chunk + d + pos * D
            ijkm, valid = map_it(it)
            if reorder:
                img_p, ang_p, code, cnt_nat = ray_tracer.reorder_chunk_core(
                    cfg, trace_fn, ijkm, valid, perm, ray_grids,
                    trace_tables, gv_tables, dseed_u, beam)
                ys = (code, cnt_nat, it.astype(jnp.int32))
            else:
                img_p, ang_p, code = ray_tracer.chunk_core(
                    cfg, trace_fn, ijkm, valid, ray_grids, trace_tables,
                    gv_tables, dseed_u, beam)
                ys = code
            bits3 = jnp.stack([jnp.any(code == -1), jnp.any(code == -2),
                               jnp.any(code == -3)]).astype(jnp.int32)
            return (image_acc + img_p, iang_acc + ang_p, fail3 + bits3), ys

        xs = jnp.arange(n_chunks, dtype=jnp.int32)
        (image, i_ang, fail3), ys = jax.lax.scan(
            body, (image0, iang0, jnp.zeros((3,), jnp.int32)),
            (xs, prev_counts) if reorder else xs)
        # single end-of-call image reduction -- the psum analogue of
        # the reference's MPI_Allreduce(DOUBLE, SUM)
        image = jax.lax.psum(image, RAY_AXIS)
        i_ang = jax.lax.psum(i_ang, RAY_AXIS)
        fail3 = jax.lax.psum(fail3, RAY_AXIS)
        if reorder:
            codes, counts, it_all = ys
            return image, i_ang, fail3, codes, counts, it_all
        return image, i_ang, fail3, ys

    sh = P(None, RAY_AXIS)
    sharded = shard_map(
        worker, mesh=mesh,
        in_specs=(P(), P(), P(), P()) + ((sh,) if reorder else ()),
        out_specs=(P(), P(), P(), sh) + ((sh, sh) if reorder else ()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_split_pipeline(cfg: dict, trace_fn, mesh: Mesh):
    """Two-dispatch sharded pipeline overlapping the gv upload with the
    trace -- the multi-chip analogue of ray_tracer._make_split_pipeline.

    The reference's multi-GPU path drives the identical fastest
    configuration per device (src/RayTraceImage.cpp:396-405); the
    single-chip pipeline ships the gv lineshape tables over the link while
    the trace kernel runs, and mesh calls were one dispatch and paid that
    cost. Here the call becomes: dispatch the sharded TRACE (pack + trace
    tables, replicated), ship gv during it (device_put to a replicated
    NamedSharding -- the transfer rides the link while every shard
    traces), then dispatch the sharded AMPLIFY+BIN on the resident
    per-shard trace results. The stacked trace results stay sharded over
    the ray axis between the two dispatches (spec P(None, RAY_AXIS):
    leading dim = chunk scan step, dim 1 = rays); nothing crosses devices
    until the end-of-call psum, exactly like the single-dispatch path.
    Gated by prepare_sharded to ASE-class trace stacks, same policy as
    single-chip."""
    D = mesh.size
    chunk = cfg["chunk"]
    per_dev = chunk // D
    n_chunks = cfg["n_chunks"]
    K = cfg["K"]
    map_it = ray_tracer.make_stride_mapper(cfg)

    def _dev_it(ci, d):
        # device stride nested under the rank stride (same composition as
        # make_sharded_pipeline's worker)
        return (ci.astype(jnp.int64) * chunk + d
                + jnp.arange(per_dev, dtype=jnp.int64) * D)

    def worker_trace(pack, trace_tables):
        d = jax.lax.axis_index(RAY_AXIS).astype(jnp.int64)
        ray_grids, _beam, _dseed = ray_tracer.unpack_bundle(cfg, pack)

        def body(_, ci):
            ijkm, _valid = map_it(_dev_it(ci, d))
            res = ray_tracer.chunk_trace(cfg, trace_fn, ijkm, ray_grids,
                                         trace_tables)
            return (), res

        _, res_all = jax.lax.scan(body, (),
                                  jnp.arange(n_chunks, dtype=jnp.int32))
        return res_all

    def worker_post(pack, gv_tables, res_all, dseed):
        d = jax.lax.axis_index(RAY_AXIS).astype(jnp.int64)
        ray_grids, beam, dseed_u = ray_tracer.unpack_bundle(cfg, pack)
        if dseed_u is None:
            dseed_u = dseed
        image0 = jnp.zeros((cfg["img_cells"], K), dtype=jnp.float64)
        iang0 = jnp.zeros((cfg["na_nb"],), dtype=jnp.float64)

        def body(carry, xs):
            image_acc, iang_acc, fail3 = carry
            ci, res = xs
            ijkm, valid = map_it(_dev_it(ci, d))
            img_p, ang_p, code = ray_tracer.chunk_post(
                cfg, ijkm, valid, ray_grids, res, gv_tables, dseed_u, beam)
            bits3 = jnp.stack([jnp.any(code == -1), jnp.any(code == -2),
                               jnp.any(code == -3)]).astype(jnp.int32)
            return (image_acc + img_p, iang_acc + ang_p, fail3 + bits3), code

        (image, i_ang, fail3), codes = jax.lax.scan(
            body, (image0, iang0, jnp.zeros((3,), jnp.int32)),
            (jnp.arange(n_chunks, dtype=jnp.int32), res_all))
        image = jax.lax.psum(image, RAY_AXIS)
        i_ang = jax.lax.psum(i_ang, RAY_AXIS)
        fail3 = jax.lax.psum(fail3, RAY_AXIS)
        return image, i_ang, fail3, codes

    sh = P(None, RAY_AXIS)
    # every trace-result leaf is [n_chunks, B_dev, ...]: rays on dim 1
    run_trace = jax.jit(shard_map(
        worker_trace, mesh=mesh, in_specs=(P(), P()),
        out_specs=stepper.TraceResult(gvl=sh, evl=sh, ivl=sh, exit_x=sh,
                                      exit_y=sh, exit_a=sh, exit_b=sh,
                                      escaped=sh, perp=sh),
        check_vma=False))
    run_post = jax.jit(shard_map(
        worker_post, mesh=mesh,
        in_specs=(P(), P(), stepper.TraceResult(
            gvl=sh, evl=sh, ivl=sh, exit_x=sh, exit_y=sh, exit_a=sh,
            exit_b=sh, escaped=sh, perp=sh), P()),
        out_specs=(P(), P(), P(), sh),
        check_vma=False))
    gv_sharding = NamedSharding(mesh, P())

    def run_call(pack, trace_tables, gv_tables, dseed):
        res_all = run_trace(pack, trace_tables)   # async dispatch
        gv_dev = jax.device_put(gv_tables, gv_sharding)  # rides the link
        return run_post(pack, gv_dev, res_all, dseed)

    return run_call


class PreparedShardedCall(NamedTuple):
    """The prepare/execute split of a sharded call (the multi-chip analogue
    of ray_tracer.PreparedCall): ``pipeline(*operands)`` dispatches the
    whole jitted sharded call asynchronously; ``_finalize_sharded`` blocks
    on the readback and applies the failure path + layout contract."""
    pipeline: object
    operands: tuple
    cfg: dict
    mesh: Mesh


def prepare_sharded(problem: CreateImageProblem, mesh: Mesh,
                    compute_method: str = "auto",
                    chunk_size: int | None = None,
                    spectrum_dtype=jnp.float32, c: float = 0.5,
                    deposit: str = "auto",
                    reorder: bool = False) -> PreparedShardedCall:
    """Validate + pack the problem and fetch (compiling if needed) the
    cached sharded whole-call pipeline. Host-side packing happens here; the
    host->device transfer happens when the pipeline runs (inside the timed
    region, per the reference's per-call re-upload semantics).

    Validation, backend resolution (the fastest backend runs per shard,
    exactly like the reference's multi-GPU path drives its CUDA kernel,
    RayTraceImage.cpp:396-405; on the CPU platform the pallas kernel runs
    through the interpreter), table packing and the deposit policy all come from
    ray_tracer.prepare_common -- one implementation, so the single-chip
    and multi-chip paths cannot diverge on them."""
    beam = problem.euv_beam
    D = mesh.size
    from raytrace_tpu.ops import pallas_kernel as pk
    cp = ray_tracer.prepare_common(problem, compute_method, spectrum_dtype,
                                   deposit)
    backend, method, scale, dims = cp.backend, cp.method, cp.scale, cp.dims
    use_emis, K = cp.use_emis, cp.K
    trace_tables, fast_meta, pallas_meta = (cp.trace_tables, cp.fast_meta,
                                            cp.pallas_meta)
    gv_tables, seed_dev, seed_f0 = cp.gv_tables, cp.seed_dev, cp.seed_f0
    pack, pack_layout, beam_scalars = (cp.pack, cp.pack_layout,
                                       cp.beam_scalars)
    bin_deposit = cp.bin_deposit
    nx, ny, na, nb = beam.nx, beam.ny, beam.na, beam.nb

    Nt = dims[0] * dims[1] * dims[2] * dims[3]
    skip = problem.N_parallel
    B_total = len(range(problem.N_start, Nt, skip)) if problem.N_start < Nt else 0
    auto_chunk = chunk_size is None
    if auto_chunk:
        if backend == "pallas":
            # the kernel bounds divergence per block, so the chunk only sets
            # the scan length (same policy as single-device)
            chunk_size = 65536
        else:
            chunk_size = 16384 if B_total < 2_000_000 else 32768
    chunk = min(chunk_size, max(B_total, 1))
    chunk = max(D, (chunk // D) * D)
    if backend == "pallas":
        # each device's chunk share is whole kernel blocks
        per_dev = max(pk.BLOCK, (chunk // D // pk.BLOCK) * pk.BLOCK)
        chunk = per_dev * D
        if auto_chunk and B_total > chunk:
            # minimize last-chunk padding (same policy as the single-device
            # path in models/ray_tracer.prepare_pipeline)
            n = math.ceil(B_total / chunk)
            align = pk.BLOCK * D
            chunk = min(chunk, math.ceil(math.ceil(B_total / n) / align)
                        * align)
    n_chunks = math.ceil(B_total / chunk) if B_total else 0

    # cost-feedback reorder (ray_tracer.reorder_chunk_core, run per
    # shard): needs the pallas counts variant; silently inert elsewhere --
    # the same fall-back-to-what-runs policy as the single-chip path
    # (incl. the int32 stride-index bound for the failure-path mapping)
    reorder = (bool(reorder) and backend == "pallas" and n_chunks > 0
               and Nt // skip < 2 ** 31)
    reorder_row = ray_tracer.reorder_row_geom(problem) if reorder else None
    # two-dispatch gv-upload overlap (make_sharded_split_pipeline): same
    # gate as the single-chip path -- ASE-class stacked trace results only
    # (the seeded stack would hold ~0.7 GB between the dispatches)
    nseg_s = max(problem.N - 1, 1)
    # per-DEVICE bytes: between the two dispatches each device holds only
    # its chunk/D shard of the stacked trace results (the stack is sharded
    # over the mesh's ray axis), so the budget gates what one chip's HBM
    # actually carries -- a whole-mesh bound would be D x too conservative
    trace_bytes = n_chunks * (chunk // D) * (36 * nseg_s + 18)
    # single-process meshes only: the mid-call device_put of the gv stack
    # to a replicated sharding is a single-controller idiom; multi-process
    # runs keep the one-dispatch pipeline (gv rides as a jit argument)
    split = ((not reorder) and n_chunks > 0
             and trace_bytes <= ray_tracer._SPLIT_MAX_BYTES
             and jax.process_count() == 1
             and os.environ.get("RAYTRACE_NO_SPLIT") != "1")
    cfg_key = ("sharded", id(mesh), backend, problem.N, float(beam.dz), K,
               method, use_emis, dims, float(scale),
               str(jnp.dtype(spectrum_dtype)), float(c), chunk, n_chunks,
               bin_deposit,
               problem.N_start, problem.N_parallel, fast_meta, pallas_meta,
               pack_layout, beam_scalars, seed_f0, reorder, reorder_row,
               split)
    cfg = dict(N=problem.N, dz=float(beam.dz), K=K, method=method,
               use_emis=use_emis, dims=dims, scale=float(scale),
               spectrum_dtype=spectrum_dtype, c=float(c), dense=False,
               bin_deposit=bin_deposit,
               chunk=chunk, n_chunks=n_chunks, na_nb=na * nb,
               img_cells=nx * ny, N_start=problem.N_start,
               N_parallel=problem.N_parallel, fast_meta=fast_meta,
               pallas_meta=pallas_meta,
               pack_layout=pack_layout, beam_scalars=beam_scalars,
               seed_f0=seed_f0, reorder=reorder, reorder_row=reorder_row, split=split)
    if cfg_key not in _SHARDED_CACHE:
        if backend == "pallas":
            trace_fn = ray_tracer.make_pallas_trace_fn(cfg, counts=reorder)
        elif backend == "lax":
            meta, nch, nyc = fast_meta

            def trace_fn(rays, tx):
                ftl = fast_stepper.FastTables(tx=tx, meta=meta, nch=nch,
                                              ny_cells=nyc)
                return fast_stepper.trace_batch_fast(
                    rays, cfg["N"], cfg["dz"], ftl, method, c=c,
                    use_emis=use_emis)
        else:
            def trace_fn(rays, tables):
                return stepper.trace_batch(rays, cfg["N"], cfg["dz"], tables,
                                           method, c=c, use_emis=use_emis)
        maker = (make_sharded_split_pipeline if split
                 else make_sharded_pipeline)
        _SHARDED_CACHE[cfg_key] = maker(cfg, trace_fn, mesh)
    return PreparedShardedCall(
        pipeline=_SHARDED_CACHE[cfg_key],
        operands=(pack, trace_tables, gv_tables, seed_dev),
        cfg=cfg, mesh=mesh)


def create_image_sharded(problem: CreateImageProblem, mesh: Mesh,
                         compute_method: str = "auto",
                         chunk_size: int | None = None,
                         spectrum_dtype=jnp.float32, c: float = 0.5,
                         deposit: str = "auto",
                         failed_ray_path: str = "Failed_RayTrace_rays.dat",
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Multi-chip create_image over a ray-sharded mesh.

    Every device computes a stride-decomposed share of the rays; the
    returned images are the psum-reduced totals (identical on every device).
    """
    profiler.start("create_image-sharded")
    try:
        prep = prepare_sharded(problem, mesh, compute_method, chunk_size,
                               spectrum_dtype, c, deposit)
        outs = prep.pipeline(*prep.operands)
        return _finalize_sharded(problem, prep, outs, failed_ray_path)
    finally:
        profiler.stop("create_image-sharded")


def _finalize_sharded(problem: CreateImageProblem, prep: PreparedShardedCall,
                      outs, failed_ray_path: str
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Blocking tail of a dispatched sharded call: readback, failure path,
    layout contract, store on the problem."""
    cfg = prep.cfg
    D = prep.mesh.size
    beam = problem.euv_beam
    src = problem.seed_beam if problem.seed is not None else beam
    method, dims, chunk = cfg["method"], cfg["dims"], cfg["chunk"]

    # reorder pipelines append (counts, it) outputs (keyed on the cfg, not
    # tuple length): counts feed the next stream call; it maps permuted
    # per-device positions back to physical rays
    image_d, iang_d, fail3_d, codes_d = outs[:4]
    it_d = outs[5] if cfg.get("reorder") else None
    image, i_ang, fail3_np = jax.device_get((image_d, iang_d, fail3_d))

    if np.any(fail3_np > 0):
        bits = 0
        for bpos, cnt in zip((1, 2, 3), fail3_np):
            if cnt > 0:
                bits = err_util.set_bit(bpos, bits)
        failed = []
        # codes is sharded over the mesh; on a multi-process mesh only the
        # local shards are addressable, so assemble what this rank owns (each
        # rank dumps its own failed rays, like the reference's per-rank
        # write_failures) -- single-process meshes reconstruct everything
        codes = np.zeros(codes_d.shape, dtype=np.int32)
        for sh in codes_d.addressable_shards:
            codes[sh.index] = np.asarray(sh.data)
        it_arr = None
        if it_d is not None:  # reorder: positions are permuted per device
            it_arr = np.zeros(it_d.shape, dtype=np.int32)
            for sh in it_d.addressable_shards:
                it_arr[sh.index] = np.asarray(sh.data)
        per_dev = chunk // D
        for ci, bidx in zip(*np.nonzero(codes < 0)):
            if it_arr is not None:
                it = int(it_arr[ci, bidx])
            else:
                dev, r = divmod(int(bidx), per_dev)
                it = int(ci) * chunk + dev + r * D
            gidx = problem.N_start + it * problem.N_parallel
            gi, gj, gk, gm = (np.asarray(v) for v in
                              ray_tracer._unflatten_rays(jnp.asarray(gidx),
                                                         dims))
            failed.append(np.array(
                [src.x[gi], src.y[gj], src.a[gk], src.b[gm]], np.float32))
            if len(failed) >= err_util.N_FAILED_MAX:
                break
        for msg in err_util.failure_messages(bits):
            print(msg)
        err_util.write_failures(failed_ray_path, bits, np.array(failed),
                                method, problem.N, beam.dz, problem.gain)
        raise err_util.RayTraceError("Some rays failed")

    image_np = np.asarray(image, dtype=np.float64).reshape(-1)
    i_ang_np = np.asarray(i_ang, dtype=np.float64)
    problem.image = image_np
    problem.I_ang = i_ang_np
    return image_np, i_ang_np
