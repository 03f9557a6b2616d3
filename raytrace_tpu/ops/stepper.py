"""Batched ray-propagation stepper (the batched equivalent of the reference's
single-ray kernel ``RayTrace_calc_ray``, src/common/RayTraceImageHelper.h:379-513).

Design (SURVEY.md section 7 "key representation decisions" #1):

The reference marches each ray through three nested data-dependent while
loops (cell walk -> per-cell re-interpolation -> adaptive micro-step). Here
the whole batch advances together through the *same* three-level loop nest,
expressed as ``lax.while_loop`` with ``any(active)`` conditions and per-lane
masks -- the hand-written equivalent of what ``vmap`` would synthesize, but
with explicit control of the masks so the structure ports directly to a
Pallas kernel.

Key properties:

* All table lookups (``findindex`` + corner gathers) happen only at the
  outermost (cell-walk) level, ~12 times per ray on the shipped inputs; the
  two inner levels are pure VPU arithmetic on cached per-lane cell state.
* ``findindex`` bisection is reformulated as a dense compare-and-sum over the
  grid (no gathers, no divergence) -- see :func:`raytrace_tpu.ops.interp.find_index`.
* Gradients of the refraction index use host-precomputed float64-accurate
  edge tables (``Gx``/``Gy``), preserving the reference's double-precision
  gradient rule while keeping the device loop in float32.
* Stepping arithmetic is float32 throughout, matching the reference's
  precision placement (floats for pos/dir/steps, RayTraceImageHelper.h:372).

Trip counts measured on ASE_small: avg 12 cell steps, 24 interpolation
steps, 33 micro-steps per ray (max 20/73/167) -- shallow enough that the
batched any-active iteration converges quickly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.models.problem import DeviceGain
from raytrace_tpu.ops.interp import bilinear, find_index

__all__ = ["trace_batch", "TraceResult", "N_SUB"]

N_SUB = 3  # sub-lengths per segment (RayTraceImageHelper.h:31)

f32 = jnp.float32


class TraceResult(NamedTuple):
    gvl: jax.Array      # [B, NSEG, N_SUB] f32 path-integrated gain
    evl: jax.Array      # [B, NSEG, N_SUB] f32 path-integrated emissivity
    ivl: jax.Array      # [B, NSEG, N_SUB] i32 lineshape cell of last visit
    exit_x: jax.Array   # [B] f32
    exit_y: jax.Array   # [B] f32
    exit_a: jax.Array   # [B] f32 output angle (mrad)
    exit_b: jax.Array   # [B] f32
    escaped: jax.Array  # [B] bool ray left the plasma column
    perp: jax.Array     # [B] bool s_z^2 < 0.01 at exit (error -1)


class _Ray(NamedTuple):
    """Per-lane propagation state carried across segments."""
    px: jax.Array
    py: jax.Array
    sx: jax.Array
    sy: jax.Array
    sz: jax.Array
    escaped: jax.Array


class _L0(NamedTuple):
    """State of the batched cell-walk loop for one (segment, sub-length)."""
    ray: _Ray
    z: jax.Array         # [B] progress along the segment
    gvl: jax.Array       # [B] gain accumulator for this (seg, sub)
    evl: jax.Array       # [B] emissivity accumulator
    ivl: jax.Array       # [B] i32 cell index of the last visited cell
    finished: jax.Array  # [B] bool


class _L1(NamedTuple):
    """State of the batched per-cell interpolation loop (propagate2)."""
    px: jax.Array
    py: jax.Array
    pz: jax.Array        # displacement accumulated within the cell
    sx: jax.Array
    sy: jax.Array
    sz: jax.Array
    z2: jax.Array        # |z| progress within the cell walk
    ds: jax.Array        # path length accumulated within the cell
    act: jax.Array


class _L2(NamedTuple):
    """State of the batched adaptive micro-step loop (propagate)."""
    rx: jax.Array
    ry: jax.Array
    rz: jax.Array
    sx: jax.Array
    sy: jax.Array
    sz: jax.Array
    n_lag: jax.Array     # n evaluated at the *previous* body's displacement
    path: jax.Array
    act: jax.Array


def _normalize(sx, sy, sz):
    """Renormalize a near-unit direction (normalize_s,
    RayTraceImageHelper.h:73-89): sum of squares in f32, rsqrt, scale."""
    tmp = sx * sx + sy * sy + sz * sz
    inv = (f32(1.0) / jnp.sqrt(tmp)).astype(jnp.float32)
    return sx * inv, sy * inv, sz * inv


def _propagate_loop(l1act, sx, sy, sz, n0, dndx, dndy, box0, box1, box2, c):
    """Batched ``propagate`` (RayTraceImageHelper.h:270-313): adaptive
    sub-stepping in a locally-linear index field until the displacement
    leaves the |r| < box region or n drifts 0.05."""
    zero = jnp.zeros_like(sx)
    dz_max = f32(c) * f32(1.00001) * box2

    def cond(st: _L2):
        return jnp.any(st.act)

    def body(st: _L2):
        act = st.act
        n = n0 + st.rx * dndx + st.ry * dndy
        t = (st.sx * dndx + st.sy * dndy + f32(1e-12)) / n
        fx = dndx / n - st.sx * t
        fy = dndy / n - st.sy * t
        fz = -st.sz * t
        step = f32(c) * f32(0.1) / jnp.abs(t)
        step = jnp.minimum(step, dz_max)
        step2 = f32(1.0001) * (box2 - jnp.abs(st.rz)) / jnp.abs(st.sz)
        step3 = f32(c) * f32(0.05) * (jnp.abs(st.sx) + f32(5e-4)) / (jnp.abs(fx) + f32(1e-8))
        step4 = f32(c) * f32(0.05) * (jnp.abs(st.sy) + f32(5e-4)) / (jnp.abs(fy) + f32(1e-8))
        step = jnp.minimum(jnp.minimum(step, step2), jnp.minimum(step3, step4))
        st_ = step * t
        c1 = f32(0.5) * step * step * (f32(1.0) - st_ / f32(3.0) + st_ * st_ / f32(12.0))
        rx = st.rx + st.sx * step + c1 * fx
        ry = st.ry + st.sy * step + c1 * fy
        rz = st.rz + st.sz * step + c1 * fz
        c2 = step * (f32(1.0) - f32(0.5) * st_ + st_ * st_ / f32(6.0))
        nsx, nsy, nsz = _normalize(st.sx + c2 * fx, st.sy + c2 * fy, st.sz + c2 * fz)
        path = st.path + step

        sel = lambda a, b: jnp.where(act, a, b)
        new = _L2(
            rx=sel(rx, st.rx), ry=sel(ry, st.ry), rz=sel(rz, st.rz),
            sx=sel(nsx, st.sx), sy=sel(nsy, st.sy), sz=sel(nsz, st.sz),
            n_lag=sel(n, st.n_lag), path=sel(path, st.path), act=act,
        )
        # loop-exit test with the lagged n (the reference checks the n
        # computed in the previous body execution, RayTraceImageHelper.h:279)
        still = (
            (jnp.abs(new.rx) < box0) & (jnp.abs(new.ry) < box1)
            & (jnp.abs(new.rz) < box2) & (jnp.abs(new.n_lag - n0) < f32(0.05))
        )
        return new._replace(act=act & still)

    init = _L2(rx=zero, ry=zero, rz=zero, sx=sx, sy=sy, sz=sz,
               n_lag=n0, path=zero, act=l1act)
    # entry condition: r = 0 and n_lag = n0 make it true whenever boxes > 0
    init_ok = (box0 > 0) & (box1 > 0) & (box2 > 0)
    init = init._replace(act=init._replace(act=l1act).act & init_ok)
    out = jax.lax.while_loop(cond, body, init)
    return out


def _cell_walk(seg_idx: int, gain: DeviceGain, st0: _L0, z_stop: float,
               c: float, use_emis: bool, nx_pad: int):
    """Batched cell-walk for one (segment, sub-length): the innermost-but-one
    structure of RayTrace_calc_ray (RayTraceImageHelper.h:460-512)."""
    xg = gain.x[seg_idx]
    yg = gain.y[seg_idx]
    cdxg = gain.cdx[seg_idx]
    cdyg = gain.cdy[seg_idx]
    n4t = gain.n4[seg_idx]
    g0t = gain.g0[seg_idx]
    E0t = gain.E0[seg_idx]
    Gxt = gain.Gx[seg_idx]
    Gyt = gain.Gy[seg_idx]
    r4 = gain.range4[seg_idx]
    absy = gain.abs_y[seg_idx]
    nx_true = gain.nx[seg_idx]
    ny_true = gain.ny[seg_idx]
    z_stop995 = f32(np.float32(0.995) * np.float32(z_stop))

    def l0_cond(st: _L0):
        return jnp.any(~st.finished)

    def l0_body(st: _L0):
        ray = st.ray
        act = ~st.finished
        # escape test (RayTraceImageHelper.h:465-469)
        esc_now = act & (
            (ray.px < r4[0]) | (ray.px > r4[1]) | (ray.py < r4[2])
            | (ray.py > r4[3]) | (ray.sz * ray.sz < f32(0.01))
        )
        escaped = ray.escaped | esc_now
        work = act & ~esc_now

        # ---- cell entry: index search + corner gathers --------------------
        y_eff = jnp.where(absy, jnp.abs(ray.py), ray.py)
        k1 = jnp.minimum(find_index(xg, ray.px), nx_true - 1)
        k2 = jnp.minimum(find_index(yg, y_eff), ny_true - 1)
        i1 = (k1 - 1) + (k2 - 1) * nx_pad
        i2 = k1 + (k2 - 1) * nx_pad
        i3 = (k1 - 1) + k2 * nx_pad
        i4 = k1 + k2 * nx_pad
        n1, n2, n3, n4 = n4t[i1], n4t[i2], n4t[i3], n4t[i4]
        # f64 cell edges (the grids stay double like the reference's
        # ray_gain_struct); interpolation fractions computed in f64 and
        # cast f32 ONCE, exactly like the oracle's
        # dxi = f32((pos - x2[0]) / (x2[1] - x2[0]))
        xlo = xg[k1 - 1]
        xhi = xg[k1]
        ylo = yg[k2 - 1]
        yhi = yg[k2]
        cdx = cdxg[k1 - 1]
        cdy = cdyg[k2 - 1]
        dxi = ((ray.px - xlo) / (xhi - xlo)).astype(jnp.float32)
        dyi = ((y_eff - ylo) / (yhi - ylo)).astype(jnp.float32)
        g0c = bilinear(dxi, dyi, g0t[i1], g0t[i2], g0t[i3], g0t[i4])
        if use_emis:
            E0c = bilinear(dxi, dyi, E0t[i1], E0t[i2], E0t[i3], E0t[i4])
            E0c = jnp.maximum(E0c, f32(0.0))
        else:
            E0c = jnp.zeros_like(g0c)
        # n gradients per edge, interpolated transversely (propagate2's
        # in-cell re-interpolation reuses these cached values)
        gx1 = Gxt[(k1 - 1) + (k2 - 1) * (nx_pad - 1)]
        gx2 = Gxt[(k1 - 1) + k2 * (nx_pad - 1)]
        gy1 = Gyt[(k1 - 1) + (k2 - 1) * nx_pad]
        gy2 = Gyt[k1 + (k2 - 1) * nx_pad]
        # extended cell range (RayTraceImageHelper.h:492-497): f64
        # arithmetic, one f32 cast -- the oracle's
        # cell_range = [f32(x2[0] - 0.1*(x2[1]-x2[0])), ...]
        exlo = (xlo - 0.1 * (xhi - xlo)).astype(jnp.float32)
        exhi = (xhi + 0.1 * (xhi - xlo)).astype(jnp.float32)
        eyhi = (yhi + 0.1 * (yhi - ylo)).astype(jnp.float32)
        eylo = jnp.where(absy & (k2 <= 1), -eyhi,
                         (ylo - 0.1 * (yhi - ylo)).astype(jnp.float32))
        dz2 = z_stop - st.z

        # ---- L1: walk within the cell (propagate2) ------------------------
        def l1_cond(s: _L1):
            return jnp.any(s.act)

        def l1_body(s: _L1):
            act1 = s.act
            y2 = jnp.where(absy, jnp.abs(s.py), s.py)
            dxi2 = ((s.px - xlo) / (xhi - xlo)).astype(jnp.float32)
            dyi2 = ((y2 - ylo) / (yhi - ylo)).astype(jnp.float32)
            n0 = bilinear(dxi2, dyi2, n1, n2, n3, n4)
            dndx = (f32(1.0) - dyi2) * gx1 + dyi2 * gx2
            dndy = (f32(1.0) - dxi2) * gy1 + dxi2 * gy2
            dndy = jnp.where(absy & (s.py < 0), -dndy, dndy)
            box0 = f32(0.1) * cdx
            box1 = f32(0.1) * cdy
            box2 = dz2 - s.z2
            l2 = _propagate_loop(act1, s.sx, s.sy, s.sz, n0, dndx, dndy,
                                 box0, box1, box2, c)
            sel = lambda a, b: jnp.where(act1, a, b)
            px = sel(s.px + l2.rx, s.px)
            py = sel(s.py + l2.ry, s.py)
            pz = sel(s.pz + l2.rz, s.pz)
            z2 = sel(s.z2 + jnp.abs(l2.rz), s.z2)
            ds = sel(s.ds + l2.path, s.ds)
            sx = sel(l2.sx, s.sx)
            sy = sel(l2.sy, s.sy)
            sz = sel(l2.sz, s.sz)
            y2n = jnp.where(absy, jnp.abs(py), py)
            still = (
                (px > exlo) & (px < exhi) & (y2n > eylo) & (y2n < eyhi)
                & (z2 < f32(0.999) * dz2)
            )
            return _L1(px=px, py=py, pz=pz, sx=sx, sy=sy, sz=sz,
                       z2=z2, ds=ds, act=act1 & still)

        zero = jnp.zeros_like(ray.px)
        y20 = jnp.where(absy, jnp.abs(ray.py), ray.py)
        l1_act0 = work & (
            (ray.px > exlo) & (ray.px < exhi) & (y20 > eylo) & (y20 < eyhi)
            & (zero < f32(0.999) * dz2)
        )
        l1_init = _L1(px=ray.px, py=ray.py, pz=zero, sx=ray.sx, sy=ray.sy,
                      sz=ray.sz, z2=zero, ds=zero, act=l1_act0)
        l1 = jax.lax.while_loop(l1_cond, l1_body, l1_init)

        # ---- close the cell: advance z, accumulate g*ds / E*ds ------------
        sel = lambda a, b: jnp.where(work, a, b)
        z = sel(st.z + jnp.abs(l1.pz), st.z)
        gvl = sel(st.gvl + g0c * l1.ds, st.gvl)
        evl = sel(st.evl + E0c * l1.ds, st.evl)
        ivl = jnp.where(work, i1, st.ivl)
        new_ray = _Ray(
            px=sel(l1.px, ray.px), py=sel(l1.py, ray.py),
            sx=sel(l1.sx, ray.sx), sy=sel(l1.sy, ray.sy),
            sz=sel(l1.sz, ray.sz), escaped=escaped,
        )
        finished = escaped | (z >= z_stop995)
        return _L0(ray=new_ray, z=z, gvl=gvl, evl=evl, ivl=ivl, finished=finished)

    init = st0._replace(finished=st0.finished | (st0.z >= z_stop995))
    return jax.lax.while_loop(l0_cond, l0_body, init)


def trace_batch(rays, N: int, dz0: float, gain: DeviceGain, method: int,
                c: float = 0.5, use_emis: bool = True) -> TraceResult:
    """Propagate a batch of rays through all length segments.

    ``rays``: dict with float32 arrays ``x, y, a, b`` of shape [B].
    ``method``: 1 = backward (ASE), 2 = forward (seeded); static.
    Returns per-(segment, sub-length) path-integrated gain/emissivity and the
    exit ray state, mirroring RayTrace_calc_ray's outputs.
    """
    B = rays["x"].shape[0]
    nx_pad = gain.x.shape[1]
    nseg = max(N - 1, 0)

    px = rays["x"].astype(jnp.float32)
    py = rays["y"].astype(jnp.float32)
    # direction vector from angles (RayTraceImageHelper.h:404-418):
    # tan evaluated in f64 then rounded, like C's double tan()
    sx = jnp.tan((f32(1e-3) * rays["a"].astype(jnp.float32)).astype(jnp.float64)).astype(jnp.float32)
    sy = jnp.tan((f32(1e-3) * rays["b"].astype(jnp.float32)).astype(jnp.float64)).astype(jnp.float32)
    sz = jnp.full((B,), f32(1.0))
    if method == 1:
        sx, sy, sz = -sx, -sy, -sz
    sx, sy, sz = _normalize(sx, sy, sz)

    ray = _Ray(px=px, py=py, sx=sx, sy=sy, sz=sz,
               escaped=jnp.zeros((B,), dtype=bool))

    gvl_all = jnp.zeros((B, max(nseg, 1), N_SUB), dtype=jnp.float32)
    evl_all = jnp.zeros((B, max(nseg, 1), N_SUB), dtype=jnp.float32)
    ivl_all = jnp.zeros((B, max(nseg, 1), N_SUB), dtype=jnp.int32)

    dz0_f = np.float32(dz0)
    for i in range(nseg):
        # high-energy-side segment indexing (RayTraceImageHelper.h:430-441)
        ii = N - i - 1 if method == 1 else i + 1
        z = jnp.zeros((B,), dtype=jnp.float32)
        st = _L0(ray=ray, z=z,
                 gvl=jnp.zeros((B,), jnp.float32),
                 evl=jnp.zeros((B,), jnp.float32),
                 ivl=jnp.zeros((B,), jnp.int32),
                 finished=jnp.zeros((B,), dtype=bool))
        for iz in range(N_SUB):
            isub = N_SUB - iz - 1 if method == 1 else iz
            z_stop = np.float32(dz0_f * np.float32(iz + 1.0) / np.float32(N_SUB))
            st = st._replace(gvl=jnp.zeros((B,), jnp.float32),
                             evl=jnp.zeros((B,), jnp.float32),
                             ivl=jnp.zeros((B,), jnp.int32),
                             finished=jnp.zeros((B,), dtype=bool))
            st = _cell_walk(ii, gain, st, z_stop, c, use_emis, nx_pad)
            gvl_all = gvl_all.at[:, ii - 1, isub].set(st.gvl)
            evl_all = evl_all.at[:, ii - 1, isub].set(st.evl)
            ivl_all = ivl_all.at[:, ii - 1, isub].set(st.ivl)
        ray = st.ray

    # output ray (RayTraceImageHelper.h:514-521); atan in f64 like the
    # reference's double atan()
    perp = ray.sz * ray.sz < f32(0.01)
    exit_a = (jnp.arctan((ray.sx / ray.sz).astype(jnp.float64))
              .astype(jnp.float32) * f32(1e3))
    exit_b = (jnp.arctan((ray.sy / ray.sz).astype(jnp.float64))
              .astype(jnp.float32) * f32(1e3))
    return TraceResult(
        gvl=gvl_all, evl=evl_all, ivl=ivl_all,
        exit_x=ray.px, exit_y=ray.py, exit_a=exit_a, exit_b=exit_b,
        escaped=ray.escaped, perp=perp,
    )
