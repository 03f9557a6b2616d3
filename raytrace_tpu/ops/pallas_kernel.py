"""Pallas-Triton trace kernel -- the ``pallas`` backend.

The reference's CUDA backend walks one ray per thread
(src/RayTraceImageCuda.cu:66-125). This kernel does the same through Pallas
on the Triton route: one program takes a block of ``BLOCK`` rays, one lane
per ray, and runs the segment loop and, inside it, the flattened cell walk
of :func:`raytrace_tpu.ops.fast_stepper.segment_walk` -- the same step
function the XLA ``lax`` backend runs over a whole chunk. The two differ
only in the batch (a block here, a chunk there) and in the fetch: each lane
here reads its cell's channels with gathers from the channel table in
device memory (ASE: 2 segments x 105x25 cells x 16 channels x 4 B, about
0.3 MB, so it stays in L2) instead of the one-hot matrix product.

A block's loops run while any of its lanes is active, so divergence is
bounded by the block rather than by the chunk, and each ray's state stays
in registers. The per-segment geometry is a small array read with scalar
loads, so the compiled program is O(1) in the segment count.

Grids: uniform grids index by arithmetic at any width (a gather has no lane
cap). Non-uniform grids run the reference's findindex bisection
(RayTraceImageHelper.h:131-143) with gathers over the float64 coordinate
rows, so a ray entering exactly on a grid line resolves to the same cell as
the reference's double compares.

Interpret mode: on the CPU platform the kernel runs through the Pallas
interpreter, which is how the tests run it; on the GPU it compiles through
Triton; any other platform raises.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from raytrace_tpu.ops import fast_stepper as fs
from raytrace_tpu.ops.stepper import N_SUB, TraceResult
from raytrace_tpu.structures import RayGain

__all__ = ["PackedGain", "pack_gain_tables", "fits_pallas", "trace_rays",
           "BLOCK"]

#: rays per program on the GPU: one lane per ray, one ray per thread
#: (4 warps), as the reference's CUDA kernel
BLOCK = 128
NUM_WARPS = 4

#: rays per program in interpret mode. The interpreter runs the grid as a
#: sequential loop on the CPU, so a wide block keeps the test suite's loop
#: count low; per-lane results do not depend on the block size.
INTERPRET_BLOCK = 4096

#: the gather offsets are int32: the channel table of all segments must
#: stay below 2^31 elements
MAX_TABLE_ELEMS = 2 ** 31 - 1

f32 = jnp.float32

#: columns of the per-segment geometry array
_GEOM_COLS = 12


class PackedGain(NamedTuple):
    """Device tables + hashable static geometry for the kernel."""

    tables: jax.Array    # [N-1, W*ny_cells*nch] f32 channel tables
    xg: jax.Array        # [N, max Nx] f64 coordinate rows (bisection)
    yg: jax.Array        # [N, max Ny] f64
    meta: tuple          # static: fast_stepper.FastTables.meta
    nch: int
    ny_cells: int
    nonuniform: bool

    @property
    def use_emis(self) -> bool:
        """The emissivity channels are packed exactly when nch == 16."""
        return self.nch == 16


def _table_elems(gains: list[RayGain], use_emis: bool) -> int:
    width = max(g.Nx - 1 for g in gains)
    nyc = max(g.Ny - 1 for g in gains)
    nch = 16 if use_emis else 12
    return max(len(gains) - 1, 1) * width * nyc * nch


def fits_pallas(gains: list[RayGain], use_emis: bool) -> bool:
    """True when the kernel covers the gain geometry: one y-mirror
    convention across the traced segments (it is compile-time in the hot
    loop) and a channel table the int32 gather offsets can index. Backend
    resolution falls back to lax-exact outside it instead of raising."""
    if len({bool(np.asarray(g.y)[0] >= 0) for g in gains[1:]} or {False}) > 1:
        return False
    return _table_elems(gains, use_emis) <= MAX_TABLE_ELEMS


def pack_gain_tables(gains: list[RayGain], use_emis: bool) -> PackedGain:
    """The fast stepper's channel tables at the widest grid's width, plus
    the f64 coordinate rows the non-uniform bisection reads."""
    if not fits_pallas(gains, use_emis):
        raise ValueError("gain geometry outside the pallas kernel's "
                         "envelope; use the lax-exact backend")
    width = max(g.Nx - 1 for g in gains)
    ft = fs.pack_tables(gains, use_emis, width)
    nxp = max(g.Nx for g in gains)
    nyp = max(g.Ny for g in gains)
    xg = np.zeros((len(gains), nxp))
    yg = np.zeros((len(gains), nyp))
    for s, g in enumerate(gains):
        xg[s, : g.Nx] = np.asarray(g.x, np.float64)
        yg[s, : g.Ny] = np.asarray(g.y, np.float64)
    return PackedGain(tables=ft.tx.reshape(ft.tx.shape[0], -1),
                      xg=jnp.asarray(xg), yg=jnp.asarray(yg), meta=ft.meta,
                      nch=ft.nch, ny_cells=ft.ny_cells,
                      nonuniform=not fs.is_uniform(gains))


def _geom_array(meta: tuple) -> np.ndarray:
    """[N, 12] f32 per-segment geometry, rounded exactly as
    fast_stepper.seg_geom rounds the XLA path's constants."""
    out = np.zeros((len(meta), _GEOM_COLS), np.float32)
    for s, (x0, dxc, y0, dyc, nx, ny, _absy, r4) in enumerate(meta):
        out[s] = [x0, dxc, np.float32(1.0) / np.float32(dxc),
                  y0, dyc, np.float32(1.0) / np.float32(dyc),
                  *r4, nx, ny]
    return out


def _bisect(row_ref, seg, q, n, rounds: int):
    """The reference's findindex (RayTraceImageHelper.h:131-143): upper in
    [1, n-1] with X[upper] >= q, comparing in f64 against the f64 row.
    ``rounds`` covers the widest grid; converged lanes no-op."""
    q64 = q.astype(jnp.float64)
    lower = jnp.zeros(q.shape, jnp.int32)
    upper = jnp.zeros(q.shape, jnp.int32) + (n - jnp.int32(1))
    for _ in range(rounds):
        active = (upper - lower) > jnp.int32(1)
        mid = jax.lax.shift_right_logical(upper + lower, jnp.int32(1))
        ge = row_ref[seg, mid] >= q64
        upper = jnp.where(active & ge, mid, upper)
        lower = jnp.where(active & ~ge, mid, lower)
    return upper


def _bisect_cell(xg_ref, yg_ref, seg, g: fs.SegGeom, rounds: int):
    """cell_fn for non-uniform grids: bisection indices and the per-cell
    geometry from the f64 rows (widths differenced in f64, rounded once)."""

    def cell_fn(p_x, y_eff):
        k1m1 = _bisect(xg_ref, seg, p_x, g.nx, rounds) - jnp.int32(1)
        k2m1 = _bisect(yg_ref, seg, y_eff, g.ny, rounds) - jnp.int32(1)
        x_lo = xg_ref[seg, k1m1]
        y_lo = yg_ref[seg, k2m1]
        dxc = (xg_ref[seg, k1m1 + jnp.int32(1)] - x_lo).astype(f32)
        dyc = (yg_ref[seg, k2m1 + jnp.int32(1)] - y_lo).astype(f32)
        return fs.Cell(k1m1, k2m1, x_lo.astype(f32), y_lo.astype(f32),
                       dxc, dyc, f32(1.0) / dxc, f32(1.0) / dyc)

    return cell_fn


def _kernel(geom_ref, px_ref, py_ref, sx_ref, sy_ref, sz_ref, tab_ref,
            xg_ref, yg_ref, gvl_ref, evl_ref, ivl_ref, ex_ref, ey_ref,
            esx_ref, esy_ref, esz_ref, esc_ref, *cnt_ref, N, dz0, c, method,
            use_emis, absy, nonuniform, nch, row, rounds):
    """Full multi-segment trace of one block of rays (one lane per ray)."""
    counting = bool(cnt_ref)
    zs_c = fs.stop_distances(dz0)
    px = px_ref[...]

    def seg_body(i, carry):
        px, py, sx, sy, sz, esc, nst = carry
        ii = (jnp.int32(N - 1) - i) if method == 1 else (i + jnp.int32(1))
        m = [geom_ref[ii, k] for k in range(_GEOM_COLS)]
        g = fs.SegGeom(x0=m[0], dxc=m[1], inv_dx=m[2], y0=m[3], dyc=m[4],
                       inv_dy=m[5], r0=m[6], r1=m[7], r2=m[8], r3=m[9],
                       nx=m[10].astype(jnp.int32), ny=m[11].astype(jnp.int32))
        seg = ii - jnp.int32(1)
        if nonuniform:
            cell_fn = _bisect_cell(xg_ref, yg_ref, ii, g, rounds)
        else:
            cell_fn = functools.partial(fs.uniform_cell, g)

        def fetch(k1m1, k2m1):
            base = k1m1 * jnp.int32(row) + k2m1 * jnp.int32(nch)
            return [tab_ref[seg, base + jnp.int32(ch)] for ch in range(nch)]

        st = fs.segment_walk(
            g, cell_fn, fetch,
            fs.segment_state(px, py, sx, sy, sz, esc,
                             nst if counting else None),
            zs_c, c=c, use_emis=use_emis, method=method, absy=absy)
        for s in range(N_SUB):
            gvl_ref[seg, s, :] = st["out_g"][s]
            evl_ref[seg, s, :] = st["out_e"][s]
            ivl_ref[seg, s, :] = st["out_i"][s]
        return (st["px"], st["py"], st["sx"], st["sy"], st["sz"], st["esc"],
                st["n_steps"] if counting else nst)

    init = (px, py_ref[...], sx_ref[...], sy_ref[...], sz_ref[...],
            jnp.zeros(px.shape, jnp.bool_), jnp.zeros(px.shape, jnp.int32))
    px, py, sx, sy, sz, esc, nst = jax.lax.fori_loop(
        jnp.int32(0), jnp.int32(N - 1), seg_body, init)
    ex_ref[...] = px
    ey_ref[...] = py
    esx_ref[...] = sx
    esy_ref[...] = sy
    esz_ref[...] = sz
    esc_ref[...] = esc.astype(jnp.int32)
    if counting:
        cnt_ref[0][...] = nst


def interpret_default() -> bool:
    """Interpret mode is the CPU test mode; the GPU compiles the kernel
    through Triton. Decided here only."""
    platform = jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"the pallas trace kernel has no lowering for platform {platform!r}")


#: rays padded onto the end of a batch start outside every gain grid, so
#: they escape in the first round of the first segment
_PAD_X = 3.0e38


@functools.partial(jax.jit, static_argnames=(
    "meta", "nch", "nyc", "nonuniform", "N", "dz0", "c", "method",
    "use_emis", "counts", "block", "interpret"))
def _trace_jit(x, y, a, b, tables, xg, yg, *, meta, nch, nyc, nonuniform, N,
               dz0, c, method, use_emis, counts, block, interpret):
    B = x.shape[0]
    Bp = -(-B // block) * block
    pad = Bp - B
    px = jnp.pad(x.astype(f32), (0, pad), constant_values=_PAD_X)
    py = jnp.pad(y.astype(f32), (0, pad))
    sx, sy, sz = fs.initial_direction(jnp.pad(a, (0, pad)),
                                      jnp.pad(b, (0, pad)), method)
    nseg = N - 1
    absy = {bool(m[6]) for m in meta[1:]}.pop()
    row = nyc * nch
    rounds = max(1, math.ceil(math.log2(max(xg.shape[1], yg.shape[1]))))
    geom = jnp.asarray(_geom_array(meta))

    full = lambda arr: pl.BlockSpec(  # noqa: E731
        arr.shape, lambda i: (0,) * arr.ndim)
    lanes = pl.BlockSpec((block,), lambda i: (i,))
    per_seg = pl.BlockSpec((nseg, N_SUB, block), lambda i: (0, 0, i))
    seg_f32 = jax.ShapeDtypeStruct((nseg, N_SUB, Bp), jnp.float32)
    lane_f32 = jax.ShapeDtypeStruct((Bp,), jnp.float32)
    lane_i32 = jax.ShapeDtypeStruct((Bp,), jnp.int32)
    out_shape = [seg_f32, seg_f32, jax.ShapeDtypeStruct((nseg, N_SUB, Bp),
                                                        jnp.int32),
                 lane_f32, lane_f32, lane_f32, lane_f32, lane_f32, lane_i32]
    out_specs = [per_seg, per_seg, per_seg] + [lanes] * 6
    if counts:
        out_shape.append(lane_i32)
        out_specs.append(lanes)
    kernel = functools.partial(
        _kernel, N=N, dz0=dz0, c=c, method=method, use_emis=use_emis,
        absy=absy, nonuniform=nonuniform, nch=nch, row=row, rounds=rounds)
    outs = pl.pallas_call(
        kernel,
        grid=(Bp // block,),
        in_specs=[full(geom), lanes, lanes, lanes, lanes, lanes,
                  full(tables), full(xg), full(yg)],
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="raytrace_trace",
    )(geom, px, py, sx, sy, sz, tables, xg, yg)
    gvl, evl, ivl, ex, ey, esx, esy, esz, esc = (o for o in outs[:9])
    cut = lambda t: t[..., :B]  # noqa: E731
    to_rays = lambda t: jnp.transpose(cut(t), (2, 0, 1))  # noqa: E731
    esx, esy, esz = cut(esx), cut(esy), cut(esz)
    exit_a, exit_b = fs.exit_angles(esx, esy, esz)
    res = TraceResult(gvl=to_rays(gvl), evl=to_rays(evl), ivl=to_rays(ivl),
                      exit_x=cut(ex), exit_y=cut(ey), exit_a=exit_a,
                      exit_b=exit_b, escaped=cut(esc) != 0,
                      perp=esz * esz < f32(0.01))
    if counts:
        return res, cut(outs[9])
    return res


def trace_rays(rays, N: int, dz0: float, pg: PackedGain, method: int,
               c: float = 0.5, counts: bool = False,
               interpret: bool | None = None, block: int | None = None):
    """Trace a batch of rays through the kernel.

    ``rays``: dict of [B] arrays x/y/a/b (any B: the batch is padded to
    whole blocks with rays that escape at once, and cut back). Returns the
    TraceResult, plus the per-lane micro-step counts [B] i32 with
    ``counts`` (the cost-feedback reorder signal; a separately compiled
    variant, so the default carries nothing extra).

    ``interpret`` defaults to :func:`interpret_default`; ``block`` to
    BLOCK when compiled and INTERPRET_BLOCK (capped at the batch's power
    of two) when interpreted.
    """
    if N < 2:
        raise ValueError("the pallas kernel needs N >= 2 segments")
    if interpret is None:
        interpret = interpret_default()
    B = rays["x"].shape[0]
    if block is None:
        block = (min(INTERPRET_BLOCK, 1 << max(B - 1, 1).bit_length())
                 if interpret else BLOCK)
    return _trace_jit(rays["x"], rays["y"], rays["a"], rays["b"], pg.tables,
                      pg.xg, pg.yg, meta=pg.meta, nch=pg.nch,
                      nyc=pg.ny_cells, nonuniform=pg.nonuniform, N=N,
                      dz0=float(dz0), c=float(c), method=method,
                      use_emis=pg.use_emis, counts=bool(counts),
                      block=int(block), interpret=bool(interpret))

