"""Flattened cell-walk stepper shared by the XLA path and the trace kernel.

One step function, two batches. :func:`segment_walk` advances a batch of
rays through one gain segment; its callers differ only in the batch and in
how a ray's cell channels are fetched:

* :func:`trace_batch_fast` (the ``lax`` backend) walks a whole chunk of
  rays as one XLA batch and fetches the channels with a one-hot matrix
  product against an x-major channel table (exact at
  ``Precision.HIGHEST``);
* the Pallas-Triton kernel (:mod:`raytrace_tpu.ops.pallas_kernel`, the
  ``pallas`` backend) walks one block of rays per program and fetches the
  same channels with gathers.

Keeping one step function keeps the two from drifting apart: per-lane
micro-step sequences are identical, which the lockstep tests check.

This stepper is numerically equivalent to :mod:`raytrace_tpu.ops.stepper`
(the exact-table variant) up to float32 ulp-level differences: cell indices
come from uniform-grid arithmetic instead of bisection and grid coordinates
are reconstructed as ``x0 + k*dx`` in f32. Those perturbations are the same
class as the compiler's FMA contraction and wash out under the reference's
norm-based 5e-6 golden gate (validated against the reference binary's
computed images).

The one-hot fetch needs uniform gain grids with Nx-1 <= XPAD cells
(:func:`fits_fast`); :mod:`raytrace_tpu.ops.stepper` handles the general
case, and the kernel handles any width and non-uniform spacings.

Channel layout in ``tx[N-1, W, ny_cells * NCH]`` (host f64 -> f32, x-major,
``W`` = XPAD for the one-hot fetch, the widest grid's cell count for the
gather fetch):
  0-3   bilinear coefficients of n:  a, b, c, d  with
        n0 = a + b*dxi + c*dyi + d*dxi*dyi   (expanded corner form)
  4-5   gx1, gxd   (d n/dx edge gradients: dndx = gx1 + dyi*gxd)
  6-7   gy1, gyd
  8-11  g0 corner values g1, g2, g3, g4 (bilinear like the reference)
  12-15 E0 corners (ASE only)
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.ops.stepper import TraceResult, N_SUB
from raytrace_tpu.structures import RayGain

__all__ = ["FastTables", "SegGeom", "Cell", "pack_fast_tables", "pack_tables",
           "trace_batch_fast", "segment_walk", "uniform_cell",
           "initial_direction", "stop_distances", "is_uniform", "fits_fast"]

#: micro-steps executed per inner while round (see fl_body)
FL_UNROLL = 2

#: when True, trace_batch_fast returns (result, {"l0": .., "fl": ..,
#: "steps": ..}) with the executed outer (cell-fetch) and inner (micro-step)
#: loop round counts plus the per-lane total micro-step counts [B] -- a
#: tuning diagnostic, not used in production paths (tools/steps_analysis.py)
DEBUG_COUNTERS = False

#: when additionally True, the counters include "rec": a list (per segment)
#: of [B, DEBUG_RMAX] i32 arrays with the per-lane micro-step count of each
#: outer (l0) round -- column r is l0 round r, so columns align across lanes.
#: This is the input for the cell-boundary-sync cost model
#: (tools/steps_analysis.py --cellsync): the inner while syncs the batch at
#: EVERY cell walk, so true batch rounds are sum-over-l0-rounds of per-round
#: maxima, not the per-segment max of totals. Rounds past DEBUG_RMAX
#: accumulate into the last column.
DEBUG_RECORD = False
DEBUG_RMAX = 96

f32 = jnp.float32
XPAD = 128  # one-hot width; requires Nx-1 <= 128 x-cells


class FastTables(NamedTuple):
    """Device tables + hashable static geometry for the fast stepper."""

    # channel tables for segments 1..N-1 (index seg-1); segment 0 is never
    # read (the walk always uses the high-energy-side segment)
    tx: jax.Array        # [N-1, W, ny_cells*NCH] f32 (x-major)
    meta: tuple          # static: per-seg (x0, dxc, y0, dyc, nx, ny, absy, r4)
    nch: int
    ny_cells: int


class SegGeom(NamedTuple):
    """Per-segment scalars of the walk: constants on the XLA path, values
    loaded from the segment-geometry array inside the kernel."""

    x0: Any
    dxc: Any
    inv_dx: Any
    y0: Any
    dyc: Any
    inv_dy: Any
    r0: Any      # escape range x0, x1, y0 (mirrored), y1
    r1: Any
    r2: Any
    r3: Any
    nx: Any      # i32 grid sizes
    ny: Any


class Cell(NamedTuple):
    """A ray's gain cell: interval indices and the cell's geometry."""

    k1m1: Any
    k2m1: Any
    xlo: Any
    ylo: Any
    dxc: Any
    dyc: Any
    inv_dx: Any
    inv_dy: Any


def is_uniform(gains: list[RayGain], tol: float = 1e-9) -> bool:
    """Uniform x/y grid spacings on every segment (any width)."""
    for g in gains:
        for grid in (np.asarray(g.x), np.asarray(g.y)):
            d = np.diff(grid)
            if np.ptp(d) > tol * np.abs(d).mean():
                return False
    return True


def fits_fast(gains: list[RayGain], tol: float = 1e-9) -> bool:
    """True when the one-hot fetch applies: uniform grids AND
    Nx-1 <= XPAD cells."""
    return is_uniform(gains, tol) and all(g.Nx - 1 <= XPAD for g in gains)


def pack_tables(gains: list[RayGain], use_emis: bool, width: int
                ) -> FastTables:
    """Host-precompute the channel tables (f64 -> one f32 rounding) with
    ``width`` x-cells per row. ``meta`` holds each segment's uniform-grid
    geometry (mean spacings on non-uniform grids, where only the escape
    range and the grid sizes are read)."""
    N = len(gains)
    nch = 16 if use_emis else 12
    nyc = max(g.Ny - 1 for g in gains)
    tx = np.zeros((max(N - 1, 1), width, nyc * nch), dtype=np.float32)
    meta = []
    for s, g in enumerate(gains):
        Nx, Ny = g.Nx, g.Ny
        x = np.asarray(g.x, np.float64)
        y = np.asarray(g.y, np.float64)
        dxc = float(np.diff(x).mean())
        dyc = float(np.diff(y).mean())
        n = np.asarray(g.n, np.float64).reshape(Ny, Nx)
        g0 = np.asarray(g.g0, np.float64).reshape(Ny, Nx)
        E0 = (np.asarray(g.E0, np.float64).reshape(Ny, Nx)
              if g.E0 is not None else np.zeros((Ny, Nx)))
        gx = (n[:, 1:] - n[:, :-1]) / np.diff(x)[None, :]
        gy = (n[1:, :] - n[:-1, :]) / np.diff(y)[:, None]

        def corners(t):
            return t[:-1, :-1], t[:-1, 1:], t[1:, :-1], t[1:, 1:]

        n1, n2, n3, n4 = corners(n)
        chans = [
            n1,                       # a
            n2 - n1,                  # b
            n3 - n1,                  # c
            n4 - n3 - n2 + n1,        # d
            gx[:-1, :], gx[1:, :] - gx[:-1, :],
            gy[:, :-1], gy[:, 1:] - gy[:, :-1],
        ]
        chans += list(corners(g0))
        if use_emis:
            chans += list(corners(E0))
        if s >= 1:
            for c, t in enumerate(chans):
                # t: [Ny-1, Nx-1] -> tx[s-1, x, j*nch + c]
                tx[s - 1, : Nx - 1, c::nch][:, : Ny - 1] = t.T.astype(np.float32)
        r0, r1 = np.float32(x[0]), np.float32(x[-1])
        r2, r3 = np.float32(y[0]), np.float32(y[-1])
        absy = bool(r2 >= 0)
        if absy:
            r2 = np.float32(-r3)
        meta.append((float(x[0]), dxc, float(y[0]), dyc, Nx, Ny, absy,
                     (float(r0), float(r1), float(r2), float(r3))))
    return FastTables(tx=jnp.asarray(tx), meta=tuple(meta), nch=nch,
                      ny_cells=nyc)


def pack_fast_tables(gains: list[RayGain], use_emis: bool) -> FastTables:
    """Channel tables for the one-hot fetch (XPAD x-cells per row)."""
    if not fits_fast(gains):
        raise ValueError("fast stepper requires uniform gain grids with "
                         f"Nx-1 <= {XPAD}; use the exact (lax-exact) backend")
    return pack_tables(gains, use_emis, XPAD)


def seg_geom(meta_s) -> SegGeom:
    """SegGeom constants of one segment's static ``FastTables.meta`` entry,
    f32-rounded exactly as the kernel's segment-geometry array."""
    x0_, dxc_, y0_, dyc_, nx_t, ny_t, _absy, r4 = meta_s
    c = lambda v: f32(np.float32(v))  # noqa: E731
    return SegGeom(
        x0=c(x0_), dxc=c(dxc_), inv_dx=c(np.float32(1.0) / np.float32(dxc_)),
        y0=c(y0_), dyc=c(dyc_), inv_dy=c(np.float32(1.0) / np.float32(dyc_)),
        r0=c(r4[0]), r1=c(r4[1]), r2=c(r4[2]), r3=c(r4[3]),
        nx=jnp.int32(nx_t), ny=jnp.int32(ny_t))


def _clamp_index(k, hi):
    """Clamp an i32 index to [0, hi] with explicit i32 bounds (bare Python
    ints would trace as i64 under x64 mode inside the kernel)."""
    return jnp.minimum(jnp.maximum(k, jnp.int32(0)), hi)


def uniform_cell(g: SegGeom, p_x, y_eff) -> Cell:
    """Uniform-grid interval index (== findindex on these grids) and the
    cell geometry reconstructed as ``x0 + k*dx`` in f32."""
    qx = (p_x - g.x0) * g.inv_dx
    qy = (y_eff - g.y0) * g.inv_dy
    k1m1 = _clamp_index(jnp.ceil(qx).astype(jnp.int32) - jnp.int32(1),
                        g.nx - jnp.int32(2))
    k2m1 = _clamp_index(jnp.ceil(qy).astype(jnp.int32) - jnp.int32(1),
                        g.ny - jnp.int32(2))
    xlo = g.x0 + k1m1.astype(f32) * g.dxc
    ylo = g.y0 + k2m1.astype(f32) * g.dyc
    return Cell(k1m1, k2m1, xlo, ylo, g.dxc, g.dyc, g.inv_dx, g.inv_dy)


def stop_distances(dz0: float) -> list:
    """Per-sub-length stop distances, f32-rounded exactly like the
    reference's dz0*(iz+1.0f)/N_SUB (RayTraceImageHelper.h:462)."""
    return [f32(np.float32(np.float32(dz0) * np.float32(iz + 1.0)
                           / np.float32(N_SUB))) for iz in range(N_SUB)]


def _any(mask):
    """Batch-wide any() as an i32 max (the kernel route has no boolean
    reduction)."""
    return jnp.max(mask.astype(jnp.int32)) > jnp.int32(0)


def segment_state(px, py, sx, sy, sz, esc, n_steps=None) -> dict:
    """Initial walk state of one segment for a batch of rays."""
    zf = jnp.zeros_like(px)
    zi = jnp.zeros(px.shape, jnp.int32)
    st = {"px": px, "py": py, "sx": sx, "sy": sy, "sz": sz,
          "z": zf, "esc": esc, "iz": zi, "gvl": zf, "evl": zf, "ivl": zi,
          "out_g": (zf,) * N_SUB, "out_e": (zf,) * N_SUB,
          "out_i": (zi,) * N_SUB}
    if n_steps is not None:
        st["n_steps"] = n_steps
    return st


def segment_walk(g: SegGeom, cell_fn: Callable, fetch: Callable, st0: dict,
                 zs_c: list, *, c: float, use_emis: bool, method: int,
                 absy: bool, unroll: int = FL_UNROLL, diag: bool = False):
    """Batched cell walk over one whole segment: all three sub-lengths run
    inside a single while loop with a per-lane sub-length counter ``iz``.

    ``cell_fn(p_x, y_eff) -> Cell`` locates each ray's cell;
    ``fetch(k1m1, k2m1) -> [nch arrays]`` reads its channels. ``st0`` comes
    from :func:`segment_state`; with an ``n_steps`` entry the per-lane
    micro-step counts are carried through. ``diag`` adds the loop-round
    diagnostics of DEBUG_COUNTERS (XLA path only).

    The per-sub loops share the segment's tables and constants; merging them
    means each lane advances through its sub-lengths at its own pace, so the
    loop runs ~max(total cells per lane in the segment) rounds instead of
    the sum of per-sub batch maxima.
    """
    counting = "n_steps" in st0
    one = f32(1.0)
    half = f32(0.5)

    def zs_of(iz):
        return jnp.where(iz <= jnp.int32(0), zs_c[0],
                         jnp.where(iz == jnp.int32(1), zs_c[1], zs_c[2]))

    def isub_of(iz):
        return (jnp.int32(N_SUB - 1) - iz) if method == 1 else iz

    def flush(st_out, mask, isub, cur):
        return tuple(jnp.where(mask & (isub == jnp.int32(s)), cur, st_out[s])
                     for s in range(N_SUB))

    def l0_cond(st):
        return _any(~(st["esc"] | (st["iz"] >= jnp.int32(N_SUB))))

    def l0_body(st):
        p_x, p_y = st["px"], st["py"]
        s_x, s_y, s_z = st["sx"], st["sy"], st["sz"]
        act0 = ~(st["esc"] | (st["iz"] >= jnp.int32(N_SUB)))
        # ---- sub-length advance: z passed 0.995*z_stop(iz) ---------------
        iz = st["iz"]
        adv = act0 & (st["z"] >= f32(0.995) * zs_of(iz))
        isub = isub_of(iz)
        out_g = flush(st["out_g"], adv, isub, st["gvl"])
        out_e = flush(st["out_e"], adv, isub, st["evl"])
        out_i = flush(st["out_i"], adv, isub, st["ivl"])
        gvl_cur = jnp.where(adv, f32(0.0), st["gvl"])
        evl_cur = jnp.where(adv, f32(0.0), st["evl"])
        ivl_cur = jnp.where(adv, jnp.int32(0), st["ivl"])
        iz = iz + adv.astype(jnp.int32)
        act = act0 & (iz < jnp.int32(N_SUB))
        zs = zs_of(iz)
        isub = isub_of(iz)

        esc_now = act & ((p_x < g.r0) | (p_x > g.r1) | (p_y < g.r2)
                         | (p_y > g.r3) | (s_z * s_z < f32(0.01)))
        # escaping lanes flush their partial sums for the current sub-length
        # (the reference accumulates straight into gvl[ii-1][is], so partials
        # up to the escape are kept, RayTraceImageHelper.h:501-503)
        out_g = flush(out_g, esc_now, isub, gvl_cur)
        out_e = flush(out_e, esc_now, isub, evl_cur)
        out_i = flush(out_i, esc_now, isub, ivl_cur)
        esc = st["esc"] | esc_now
        work = act & ~esc_now

        y_eff = jnp.abs(p_y) if absy else p_y
        cell = cell_fn(p_x, y_eff)
        k1m1, k2m1 = cell.k1m1, cell.k2m1
        vals = fetch(k1m1, k2m1)
        na_, nb_, nc_, nd_ = vals[0], vals[1], vals[2], vals[3]
        gx1, gxd = vals[4], vals[5]
        gy1, gyd = vals[6], vals[7]

        xlo, ylo = cell.xlo, cell.ylo
        dxc, dyc = cell.dxc, cell.dyc
        inv_dx, inv_dy = cell.inv_dx, cell.inv_dy
        dxi = (p_x - xlo) * inv_dx
        dyi = (y_eff - ylo) * inv_dy
        g0c = ((dxi * vals[9] + (one - dxi) * vals[8]) * (one - dyi)
               + (dxi * vals[11] + (one - dxi) * vals[10]) * dyi)
        if use_emis:
            E0c = ((dxi * vals[13] + (one - dxi) * vals[12]) * (one - dyi)
                   + (dxi * vals[15] + (one - dxi) * vals[14]) * dyi)
            E0c = jnp.maximum(E0c, f32(0.0))
        else:
            E0c = jnp.zeros_like(g0c)

        exlo = xlo - f32(0.1) * dxc
        exhi = xlo + dxc + f32(0.1) * dxc
        eyhi = ylo + dyc + f32(0.1) * dyc
        eylo = jnp.where(k2m1 <= jnp.int32(0), -eyhi, ylo - f32(0.1) * dyc) \
            if absy else (ylo - f32(0.1) * dyc)
        dz2 = zs - st["z"]

        # ---- flattened in-cell walk: the reference's propagate2/propagate
        # nest (one re-interpolation per multi-micro-step propagate call)
        # becomes a single while loop taking ONE micro-step per iteration,
        # with the per-propagate-call cached state (n0, gradients, the step
        # box and displacement r) carried per lane. Nesting the batched
        # loops would cost max(interp-trips) * max(micro-trips) rounds; the
        # flattened form costs max(total micro-steps), which is far smaller
        # under divergence. Per-lane step sequences are identical.
        box0 = f32(0.1) * dxc
        box1 = f32(0.1) * dyc

        def interp_cell(px_, py_, z2_):
            """propagate2's per-call re-interpolation + propagate init."""
            y2 = jnp.abs(py_) if absy else py_
            dxi2 = (px_ - xlo) * inv_dx
            dyi2 = (y2 - ylo) * inv_dy
            n0 = na_ + nb_ * dxi2 + nc_ * dyi2 + nd_ * dxi2 * dyi2
            dndx = gx1 + dyi2 * gxd
            dndy = gy1 + dxi2 * gyd
            if absy:
                dndy = jnp.where(py_ < f32(0.0), -dndy, dndy)
            box2 = dz2 - z2_
            return n0, dndx, dndy, box2

        def fl_cond(s1):
            return _any(s1["act"])

        def fl_one_step(s1):
            a1 = s1["act"]
            # one adaptive micro-step (propagate body,
            # RayTraceImageHelper.h:279-311)
            n0, dndx, dndy = s1["n0"], s1["dndx"], s1["dndy"]
            box2 = s1["box2"]
            n = n0 + s1["rx"] * dndx + s1["ry"] * dndy
            # shared reciprocal + constant-reciprocal multiplies:
            # <= 1 ulp vs the plain divides
            invn = one / n
            t = (s1["sx"] * dndx + s1["sy"] * dndy + f32(1e-12)) * invn
            fx = dndx * invn - s1["sx"] * t
            fy = dndy * invn - s1["sy"] * t
            fz = -s1["sz"] * t
            step = f32(c) * f32(0.1) / jnp.abs(t)
            step = jnp.minimum(step, f32(c) * f32(1.00001) * box2)
            step2 = f32(1.0001) * (box2 - jnp.abs(s1["rz"])) / jnp.abs(s1["sz"])
            step3 = f32(c) * f32(0.05) * (jnp.abs(s1["sx"]) + f32(5e-4)) \
                / (jnp.abs(fx) + f32(1e-8))
            step4 = f32(c) * f32(0.05) * (jnp.abs(s1["sy"]) + f32(5e-4)) \
                / (jnp.abs(fy) + f32(1e-8))
            step = jnp.minimum(jnp.minimum(step, step2),
                               jnp.minimum(step3, step4))
            st_ = step * t
            c1 = half * step * step * (one - st_ * f32(1.0 / 3.0)
                                       + (st_ * st_) * f32(1.0 / 12.0))
            rx = s1["rx"] + s1["sx"] * step + c1 * fx
            ry = s1["ry"] + s1["sy"] * step + c1 * fy
            rz = s1["rz"] + s1["sz"] * step + c1 * fz
            c2 = step * (one - half * st_ + (st_ * st_) * f32(1.0 / 6.0))
            ux = s1["sx"] + c2 * fx
            uy = s1["sy"] + c2 * fy
            uz = s1["sz"] + c2 * fz
            inv = jax.lax.rsqrt(ux * ux + uy * uy + uz * uz)
            ux, uy, uz = ux * inv, uy * inv, uz * inv
            path = s1["path"] + step
            n_lag = n

            sel = lambda p, q: jnp.where(a1, p, q)  # noqa: E731
            rx = sel(rx, s1["rx"])
            ry = sel(ry, s1["ry"])
            rz = sel(rz, s1["rz"])
            ux = sel(ux, s1["sx"])
            uy = sel(uy, s1["sy"])
            uz = sel(uz, s1["sz"])
            path = sel(path, s1["path"])
            n_lag = sel(n_lag, s1["n_lag"])

            # propagate-exit test (the lagged-n drift check matches the
            # reference's loop structure)
            l2_ok = ((jnp.abs(rx) < box0) & (jnp.abs(ry) < box1)
                     & (jnp.abs(rz) < box2)
                     & (jnp.abs(n_lag - n0) < f32(0.05)))
            commit = a1 & ~l2_ok
            # commit the propagate call: pos += r, z2 += |rz|, ds += path
            csel = lambda p, q: jnp.where(commit, p, q)  # noqa: E731
            px_ = csel(s1["px"] + rx, s1["px"])
            py_ = csel(s1["py"] + ry, s1["py"])
            pz_ = csel(s1["pz"] + rz, s1["pz"])
            z2_ = csel(s1["z2"] + jnp.abs(rz), s1["z2"])
            ds_ = csel(s1["ds"] + path, s1["ds"])
            # propagate2 loop condition on the committed state
            y2n = jnp.abs(py_) if absy else py_
            l1_ok = ((px_ > exlo) & (px_ < exhi) & (y2n > eylo)
                     & (y2n < eyhi) & (z2_ < f32(0.999) * dz2))
            reinit = commit & l1_ok
            n0n, dndxn, dndyn, box2n = interp_cell(px_, py_, z2_)
            rsel = lambda p, q: jnp.where(reinit, p, q)  # noqa: E731
            zero = jnp.zeros_like(px_)
            out = {
                "px": px_, "py": py_, "pz": pz_,
                "sx": ux, "sy": uy, "sz": uz,
                "z2": z2_, "ds": ds_,
                "rx": rsel(zero, rx), "ry": rsel(zero, ry),
                "rz": rsel(zero, rz), "path": rsel(zero, path),
                "n0": rsel(n0n, n0), "dndx": rsel(dndxn, dndx),
                "dndy": rsel(dndyn, dndy), "box2": rsel(box2n, box2),
                "n_lag": rsel(n0n, n_lag),
                "act": a1 & (l2_ok | reinit),
            }
            if counting:
                out["n_act"] = s1["n_act"] + a1.astype(jnp.int32)
            if diag:
                out["n_fl"] = s1["n_fl"]
            return out

        def fl_body(s1):
            # several micro-steps per while round: the loop is bounded by a
            # small tail of slow rays (near-axis rays with strong transverse
            # gradients take hundreds of micro-steps), so per-round overhead
            # dominates; unrolling trades masked idle work for rounds
            for _ in range(unroll):
                s1 = fl_one_step(s1)
            if diag:
                s1 = dict(s1, n_fl=s1["n_fl"] + jnp.int32(1))
            return s1

        zero = jnp.zeros_like(p_x)
        y20 = jnp.abs(p_y) if absy else p_y
        l1a0 = work & ((p_x > exlo) & (p_x < exhi) & (y20 > eylo)
                       & (y20 < eyhi) & (zero < f32(0.999) * dz2))
        n0_0, dndx_0, dndy_0, box2_0 = interp_cell(p_x, p_y, zero)
        fl_init = {
            "px": p_x, "py": p_y, "pz": zero, "sx": s_x, "sy": s_y,
            "sz": s_z, "z2": zero, "ds": zero,
            "rx": zero, "ry": zero, "rz": zero, "path": zero,
            "n0": n0_0, "dndx": dndx_0, "dndy": dndy_0, "box2": box2_0,
            "n_lag": n0_0, "act": l1a0}
        if counting:
            fl_init["n_act"] = st["n_steps"]  # per-lane, carried across segs
        if diag:
            fl_init["n_fl"] = jnp.int32(0)
        l1 = jax.lax.while_loop(fl_cond, fl_body, fl_init)

        sel = lambda p, q: jnp.where(work, p, q)  # noqa: E731
        nz = sel(st["z"] + jnp.abs(l1["pz"]), st["z"])
        i1 = k1m1 + k2m1 * g.nx
        ret = {
            "px": sel(l1["px"], p_x), "py": sel(l1["py"], p_y),
            "sx": sel(l1["sx"], s_x), "sy": sel(l1["sy"], s_y),
            "sz": sel(l1["sz"], s_z), "z": nz, "esc": esc, "iz": iz,
            "gvl": sel(gvl_cur + g0c * l1["ds"], gvl_cur),
            "evl": sel(evl_cur + E0c * l1["ds"], evl_cur),
            "ivl": jnp.where(work, i1, ivl_cur),
            "out_g": out_g, "out_e": out_e, "out_i": out_i,
        }
        if counting:
            ret["n_steps"] = l1["n_act"]
        if diag:
            ret["n_l0"] = st["n_l0"] + jnp.int32(1)
            ret["n_fl"] = st["n_fl"] + l1["n_fl"]
            if "rec" in st:
                # per-lane steps taken in THIS l0 round, scattered into
                # column r (one-hot; rounds >= RMAX fold into the last).
                # Encoded as steps+1 for participating (work) lanes so a
                # 0-step fetch-only round is distinguishable from absence:
                # decode steps = max(rec-1, 0), participated = rec > 0.
                stepped = l1["n_act"] - st["n_steps"]
                enc = jnp.where(work, stepped + 1, 0)
                col = jnp.minimum(st["n_l0"], jnp.int32(DEBUG_RMAX - 1))
                onehot = (jax.lax.broadcasted_iota(
                    jnp.int32, (1, DEBUG_RMAX), 1) == col)
                ret["rec"] = st["rec"] + onehot * enc[:, None]
        return ret

    return jax.lax.while_loop(l0_cond, l0_body, dict(st0))


def onehot_fetch(tx_seg, nyc: int, nch: int):
    """The XLA path's fetch: one-hot x row times the segment's channel
    table, then an elementwise one-hot contraction over the y rows."""

    def fetch(k1m1, k2m1):
        B = k1m1.shape[0]
        oh_x = (jax.lax.broadcasted_iota(jnp.int32, (B, tx_seg.shape[0]), 1)
                == k1m1[:, None]).astype(jnp.float32)
        # Precision.HIGHEST: a default-precision f32 product may round its
        # operands (bf16 or TF32), which would round the fetched table
        # values (~1e-3 relative); the fetch must return exact f32 values
        M = jax.lax.dot_general(oh_x, tx_seg, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
        M = M.reshape(B, nyc, nch)
        oh_y = (jax.lax.broadcasted_iota(jnp.int32, (B, nyc), 1)
                == k2m1[:, None]).astype(jnp.float32)
        vals = jnp.sum(M * oh_y[:, :, None], axis=1)  # [B, nch]
        return [vals[:, ch] for ch in range(nch)]

    return fetch


def initial_direction(a, b, method: int):
    """Unit direction from the entry angles: tan in f64 then round, like the
    reference's double tan() (RayTraceImageHelper.h:404-418); backward
    (method 1) rays walk the column in reverse."""
    sx = jnp.tan((f32(1e-3) * a.astype(jnp.float32))
                 .astype(jnp.float64)).astype(jnp.float32)
    sy = jnp.tan((f32(1e-3) * b.astype(jnp.float32))
                 .astype(jnp.float64)).astype(jnp.float32)
    sz = jnp.full(sx.shape, f32(1.0))
    if method == 1:
        sx, sy, sz = -sx, -sy, -sz
    inv = f32(1.0) / jnp.sqrt(sx * sx + sy * sy + sz * sz)
    return sx * inv, sy * inv, sz * inv


def exit_angles(sx, sy, sz):
    """Exit angles (mrad) via f64 arctan, as the reference."""
    exit_a = (jnp.arctan((sx / sz).astype(jnp.float64)).astype(jnp.float32)
              * f32(1e3))
    exit_b = (jnp.arctan((sy / sz).astype(jnp.float64)).astype(jnp.float32)
              * f32(1e3))
    return exit_a, exit_b


def trace_batch_fast(rays, N: int, dz0: float, ft: FastTables, method: int,
                     c: float = 0.5, use_emis: bool = True) -> TraceResult:
    """Drop-in replacement for stepper.trace_batch on uniform grids."""
    B = rays["x"].shape[0]
    nseg = max(N - 1, 0)
    px = rays["x"].astype(jnp.float32)
    py = rays["y"].astype(jnp.float32)
    sx, sy, sz = initial_direction(rays["a"], rays["b"], method)
    escaped = jnp.zeros((B,), dtype=bool)
    zs_c = stop_distances(dz0)

    gvl_all = jnp.zeros((B, max(nseg, 1), N_SUB), dtype=jnp.float32)
    evl_all = jnp.zeros((B, max(nseg, 1), N_SUB), dtype=jnp.float32)
    ivl_all = jnp.zeros((B, max(nseg, 1), N_SUB), dtype=jnp.int32)

    zerosi = jnp.zeros((B,), jnp.int32)
    _counters = {}
    for i in range(nseg):
        ii = N - i - 1 if method == 1 else i + 1
        st = segment_state(px, py, sx, sy, sz, escaped,
                           _counters.get("steps", zerosi)
                           if DEBUG_COUNTERS else None)
        if DEBUG_COUNTERS:
            st["n_l0"] = jnp.int32(0)
            st["n_fl"] = jnp.int32(0)
            if DEBUG_RECORD:
                st["rec"] = jnp.zeros((B, DEBUG_RMAX), jnp.int32)
        g = seg_geom(ft.meta[ii])
        st = segment_walk(
            g, lambda p_x, y_eff, g=g: uniform_cell(g, p_x, y_eff),
            onehot_fetch(ft.tx[ii - 1], ft.ny_cells, ft.nch), st, zs_c,
            c=c, use_emis=use_emis, method=method, absy=ft.meta[ii][6],
            diag=DEBUG_COUNTERS)
        if DEBUG_COUNTERS:
            _counters["l0"] = _counters.get("l0", 0) + st["n_l0"]
            _counters["fl"] = _counters.get("fl", 0) + st["n_fl"]
            _counters["steps"] = st["n_steps"]
            if DEBUG_RECORD:
                _counters.setdefault("rec", []).append(st["rec"])
            # cumulative per-lane counts after each segment: per-segment
            # counts are diffs (tools/steps_analysis.py)
            _counters.setdefault("steps_cum", []).append(st["n_steps"])
        for s in range(N_SUB):
            gvl_all = gvl_all.at[:, ii - 1, s].set(st["out_g"][s])
            evl_all = evl_all.at[:, ii - 1, s].set(st["out_e"][s])
            ivl_all = ivl_all.at[:, ii - 1, s].set(st["out_i"][s])
        px, py = st["px"], st["py"]
        sx, sy, sz = st["sx"], st["sy"], st["sz"]
        escaped = st["esc"]

    perp = sz * sz < f32(0.01)
    exit_a, exit_b = exit_angles(sx, sy, sz)
    result = TraceResult(gvl=gvl_all, evl=evl_all, ivl=ivl_all,
                         exit_x=px, exit_y=py, exit_a=exit_a, exit_b=exit_b,
                         escaped=escaped, perp=perp)
    if DEBUG_COUNTERS:
        return result, dict(_counters)
    return result
