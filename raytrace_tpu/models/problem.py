"""Device-side problem representation (stacked, padded, precomputed pytrees).

The reference hands the kernel an array-of-structs with raw pointers
(``ray_gain_struct*``, src/RayTraceStructures.h:218-272) and deep-copies it to
the device per call (src/RayTraceImageCuda.cu:225-289). This design
instead builds a struct-of-arrays pytree once per call:

* per-segment gain tables stacked to ``[N, ...]`` with padding to the max
  (Nx, Ny) so shapes are static under jit (ragged per-segment grids are
  allowed by the reference wire format, SURVEY.md section 7.4);
* gradient tables ``Gx``/``Gy`` precomputed in float64 on the host and stored
  float32, preserving the reference's "n stays double because gradients need
  the precision" rule (RayTraceStructures.h:215-217) while keeping the device
  hot loop pure float32;
* the separable seed factors pre-tabulated with pchip coefficients.

Host->device transfer of these tables is part of the timed region in the
benchmark protocol, matching the reference's per-call re-upload semantics
(Readme.txt:43, SURVEY.md section 3.3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional  # noqa: F401 (Optional in annotations)

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.ops import interp
from raytrace_tpu.structures import RayGain, RaySeed

__all__ = ["DeviceGain", "DeviceSeed", "DeviceBeam", "prepare_gain", "prepare_seed",
           "prepare_beam"]


class DeviceGain(NamedTuple):
    """Stacked per-segment gain tables, ready for the batched stepper.

    All leading dims are the segment index 0..N-1. 2-D tables are flattened
    row-major with cell index ``i + j*Nx`` like the reference.
    """

    x: jax.Array        # [N, Nx]  f64 grid (reference keeps x/y double;
                        # findindex + cell edges must compare in f64)
    y: jax.Array        # [N, Ny]  f64
    cdx: jax.Array      # [N, Nx-1] f32 cell widths x[k]-x[k-1] (f32 cast
                        # of the f64 difference -- propagate2's dxc)
    cdy: jax.Array      # [N, Ny-1] f32
    n4: jax.Array       # [N, Nx*Ny] f32 index of refraction (f32 cast of n)
    g0: jax.Array       # [N, Nx*Ny] f32 gain at line center
    E0: jax.Array       # [N, Nx*Ny] f32 emissivity (zeros if absent)
    Gx: jax.Array       # [N, (Nx-1)*Ny] f32 d n/dx per x-edge, f64-accurate
    Gy: jax.Array       # [N, Nx*(Ny-1)] f32 d n/dy per y-edge, f64-accurate
    gv: jax.Array       # [N, Nx*Ny, K] f32 lineshape (cell-major rows)
    gv0: jax.Array      # [N, Nx*Ny] f32 lineshape at line center
    range4: jax.Array   # [N, 4] f32 plasma extents (x0, x1, y0_mirrored, y1)
    abs_y: jax.Array    # [N] bool half-plane mirror symmetry flag
    nx: jax.Array       # [N] i32 true Nx per segment (<= padded)
    ny: jax.Array       # [N] i32


class DeviceSeed(NamedTuple):
    """Separable seed tables with pchip coefficients (ray_seed_struct)."""

    xs: tuple           # 4x [dim_i] f64 grids (x, y, a, b)
    fs: tuple           # 4x [dim_i] f64 factors
    g1s: tuple          # 4x [dim_i - 1] f64 pchip start-gradients
    g2s: tuple          # 4x [dim_i - 1] f64 pchip end-gradients
    fv: jax.Array       # [K] f64 frequency profile f[4]
    f0: jax.Array       # scalar f64
    lo: jax.Array       # [4] f64 grid lower bounds
    hi: jax.Array       # [4] f64 grid upper bounds


class DeviceBeam(NamedTuple):
    """EUV output-beam grids needed on device for binning."""

    x: jax.Array   # [nx] f64
    y: jax.Array   # [ny] f64
    a: jax.Array   # [na] f64
    b: jax.Array   # [nb] f64
    dv: jax.Array  # [nv] f64
    dx: jax.Array  # scalars f64
    dy: jax.Array
    da: jax.Array
    db: jax.Array
    y0_nonneg: jax.Array  # bool: beam.y[0] >= 0 (mirror rule for binning)


def _pad1(a: np.ndarray, n: int, edge: bool = False) -> np.ndarray:
    """Pad a 1-D array to length n (repeat-edge or zeros)."""
    if len(a) == n:
        return a
    mode = "edge" if edge else "constant"
    return np.pad(a, (0, n - len(a)), mode=mode)


def prepare_gain(gains: list[RayGain], as_numpy: bool = False) -> DeviceGain:
    """Build the stacked DeviceGain pytree from host gain structs.

    Padded grids extend monotonically past the true extent; the range4/nx/ny
    fields keep the physics confined to the true grid, so padding never
    changes results (escape tests use range4, searches clamp to nx-1).
    """
    N = len(gains)
    nx_max = max(g.Nx for g in gains)
    ny_max = max(g.Ny for g in gains)
    K = gains[0].Nv

    xs, ys, cdxs, cdys, n4s, g0s, E0s, Gxs, Gys, gvs, gv0s = ([] for _ in range(11))
    r4s, absys, nxs, nys = [], [], [], []
    for g in gains:
        Nx, Ny = g.Nx, g.Ny
        x64 = np.asarray(g.x, dtype=np.float64)
        y64 = np.asarray(g.y, dtype=np.float64)
        n64 = np.asarray(g.n, dtype=np.float64).reshape(Ny, Nx)  # [j, i]
        # plasma extents: mirror y if the grid is a half-plane (y[0] >= 0)
        r0, r1 = np.float32(x64[0]), np.float32(x64[-1])
        r2, r3 = np.float32(y64[0]), np.float32(y64[-1])
        abs_y = bool(r2 >= 0)
        if abs_y:
            r2 = np.float32(-r3)
        r4s.append(np.array([r0, r1, r2, r3], dtype=np.float32))
        absys.append(abs_y)
        nxs.append(Nx)
        nys.append(Ny)

        # grids padded so that padded entries keep increasing (searches clamp
        # below nx anyway, but monotonicity keeps compare-sums sane)
        def grow(arr, n_to):
            if len(arr) == n_to:
                return arr
            step = arr[-1] - arr[-2] if len(arr) > 1 else 1.0
            extra = arr[-1] + step * np.arange(1, n_to - len(arr) + 1)
            return np.concatenate([arr, extra])

        xp = grow(x64, nx_max)
        yp = grow(y64, ny_max)
        # x/y stay FLOAT64 like the reference's ray_gain_struct
        # (RayTraceStructures.h:215-217): the findindex compares and the
        # cell-edge coordinates must use the f64 grid, or a ray sitting
        # exactly on a grid line can resolve the tie to the OTHER cell
        # than the reference/oracle does (caught by the round-5 fuzz:
        # seeded full-plane rays entering on a shared grid line diverged
        # 20% through N=7 chaos). cdx/cdy keep the f32-of-f64-difference
        # form the oracle's propagate2 uses for its step boxes.
        xs.append(xp)
        ys.append(yp)
        cdxs.append(np.diff(xp).astype(np.float32))
        cdys.append(np.diff(yp).astype(np.float32))

        # f64-accurate edge gradients of n, stored f32
        # Gx[j, i] = (n[j, i+1] - n[j, i]) / (x[i+1] - x[i]); Gy analogous
        Gx = (n64[:, 1:] - n64[:, :-1]) / (x64[None, 1:] - x64[None, :-1])
        Gy = (n64[1:, :] - n64[:-1, :]) / (y64[1:, None] - y64[:-1, None])

        def pad2(t, ny_t, nx_t):
            out = np.zeros((ny_t, nx_t), dtype=np.float32)
            out[: t.shape[0], : t.shape[1]] = t
            return out

        n4s.append(pad2(n64.astype(np.float32), ny_max, nx_max).reshape(-1))
        g0s.append(pad2(np.asarray(g.g0, np.float32).reshape(Ny, Nx), ny_max, nx_max).reshape(-1))
        E0 = g.E0 if g.E0 is not None else np.zeros(Nx * Ny, np.float32)
        E0s.append(pad2(np.asarray(E0, np.float32).reshape(Ny, Nx), ny_max, nx_max).reshape(-1))
        Gxs.append(pad2(Gx.astype(np.float32), ny_max, nx_max - 1).reshape(-1))
        Gys.append(pad2(Gy.astype(np.float32), ny_max - 1, nx_max).reshape(-1))
        gv = np.asarray(g.gv, np.float32).reshape(Ny, Nx, K)
        gvp = np.zeros((ny_max, nx_max, K), dtype=np.float32)
        gvp[:Ny, :Nx] = gv
        gvs.append(gvp.reshape(-1, K))
        gv0s.append(pad2(np.asarray(g.gv0, np.float32).reshape(Ny, Nx), ny_max, nx_max).reshape(-1))

    conv = np.asarray if as_numpy else jnp.asarray
    return DeviceGain(
        x=conv(np.stack(xs)), y=conv(np.stack(ys)),
        cdx=conv(np.stack(cdxs)), cdy=conv(np.stack(cdys)),
        n4=conv(np.stack(n4s)), g0=conv(np.stack(g0s)), E0=conv(np.stack(E0s)),
        Gx=conv(np.stack(Gxs)), Gy=conv(np.stack(Gys)),
        gv=conv(np.stack(gvs)), gv0=conv(np.stack(gv0s)),
        range4=conv(np.stack(r4s)), abs_y=conv(np.asarray(absys)),
        nx=conv(np.asarray(nxs, np.int32)), ny=conv(np.asarray(nys, np.int32)),
    )


def prepare_seed(seed: RaySeed, as_numpy: bool = False) -> DeviceSeed:
    """Build DeviceSeed with host-precomputed pchip gradients."""
    conv = np.asarray if as_numpy else jnp.asarray
    xs, fs, g1s, g2s = [], [], [], []
    for axis in range(4):
        xi = np.asarray(seed.x[axis], np.float64)
        fi = np.asarray(seed.f[axis], np.float64)
        g1, g2 = interp.pchip_coefficients(xi, fi)
        xs.append(conv(xi))
        fs.append(conv(fi))
        g1s.append(conv(g1))
        g2s.append(conv(g2))
    lo = np.array([seed.x[i][0] for i in range(4)])
    hi = np.array([seed.x[i][-1] for i in range(4)])
    return DeviceSeed(
        xs=tuple(xs), fs=tuple(fs), g1s=tuple(g1s), g2s=tuple(g2s),
        fv=conv(np.asarray(seed.f[4], np.float64)),
        f0=conv(np.float64(seed.f0)),
        lo=conv(lo), hi=conv(hi),
    )


def prepare_beam(beam, as_numpy: bool = False) -> DeviceBeam:
    conv = np.asarray if as_numpy else jnp.asarray
    return DeviceBeam(
        x=conv(np.asarray(beam.x, np.float64)),
        y=conv(np.asarray(beam.y, np.float64)),
        a=conv(np.asarray(beam.a, np.float64)),
        b=conv(np.asarray(beam.b, np.float64)),
        dv=conv(np.asarray(beam.dv, np.float64)),
        dx=conv(np.float64(beam.dx)), dy=conv(np.float64(beam.dy)),
        da=conv(np.float64(beam.da)), db=conv(np.float64(beam.db)),
        y0_nonneg=conv(bool(beam.y[0] >= 0.0)),
    )
