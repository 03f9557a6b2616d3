"""Image binning: deposit per-ray spectra into the near-field image and the
far-field angular image.

Rebuild of the scatter-add accumulation in ``RayTraceImageCPULoop``
(src/RayTraceImageCPU.cpp:37-68):

* backward (ASE, method 1) rays bin at their *entry* coordinates;
* forward (seeded, method 2) rays bin at their *exit* coordinates with the
  angle sign flipped and y mirrored onto a half-plane beam grid;
* ``getIndex`` = half-cell-shifted first-greater search, -1 (reject) outside
  the half-cell-padded extent (src/RayTraceImageCPU.cpp:11-16);
* image[nv*(i1 + i2*nx) + iv] += Iv*scale, I_ang[i3 + i4*na] += sum 2 dv Iv.

The deposit is a ``segment_sum`` over computed flat bin ids (invalid/failed
rays go to a trash bin) or, on request, a one-hot matrix product:
``image[c, k] = sum_b onehot[b, c] * Iv[b, k]`` with the one-hot in
bfloat16 (0/1 are exact) and ``Iv`` split into three bfloat16 planes whose
f32-accumulated partial products recover f32-quality sums (~2^-26 relative
per element). Both stand in for the reference threads backend's privatized
buffers + merge (src/RayTraceImage.cpp:100-133). Per-chunk partials
accumulate across chunks in float64 like the reference's double image
buffers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytrace_tpu.models.problem import DeviceBeam
from raytrace_tpu.ops.interp import find_first_single

__all__ = ["get_index", "bin_images", "bin_images_dense"]


def bin_images_dense(Iv, beam: DeviceBeam, ok):
    """Dense binning for full-grid backward (ASE) chunks.

    When the ray list enumerates the complete (x, y, a, b) grid in natural
    order (N_start=0, N_parallel=1, method 1), every ray bins at its *entry*
    coordinates, so ``getIndex`` is the identity: the near-field deposit is a
    pure reduction over the angular block and the far-field deposit a
    reduction over the spatial block -- no scatter at all. The chunk must
    cover whole (na x nb) blocks.

    Returns (img_rows [cells_chunk, K] f64 in i-major cell order,
    i_ang_part [na*nb] f64 in reference k + m*na order).
    """
    na = beam.a.shape[0]
    nb = beam.b.shape[0]
    B, K = Iv.shape
    blk = na * nb
    cells = B // blk
    contrib = jnp.where(ok[:, None], Iv, 0.0).astype(jnp.float64)
    img_rows = contrib.reshape(cells, blk, K).sum(axis=1)
    tmp = jnp.sum(contrib * (2.0 * beam.dv), axis=1)      # [B]
    ang_km = tmp.reshape(cells, na, nb).sum(axis=0)       # [k, m]
    i_ang_part = ang_km.T.reshape(-1)                     # flat k + m*na
    return img_rows, i_ang_part


def get_index(grid, d, y):
    """Vectorized ``getIndex`` (RayTraceImageCPU.cpp:11-16): nearest-cell
    index via findfirstsingle(grid, y - d/2); -1 outside the padded extent."""
    y = jnp.asarray(y, jnp.float64)
    n = grid.shape[0]
    idx = find_first_single(grid, y - 0.5 * d)
    bad = (y < grid[0] - 0.5 * d) | (y > grid[n - 1] + 0.5 * d)
    return jnp.where(bad, -1, idx)


def split_bf16x3(x):
    """Exact bfloat16 triple of a float32 array: hi + mid + lo == x.

    Split by bit-masking (truncation): the top 16 bits of an f32 ARE its
    truncated bfloat16, so each plane is exact and the residual subtraction
    cannot be algebraically simplified away (XLA folds the rounding-based
    split ``x - f32(bf16(x))`` to zero).
    """
    def trunc(v):
        t = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(v, jnp.uint32)
            & jnp.uint32(0xFFFF0000), jnp.float32)
        return t, t.astype(jnp.bfloat16)

    hi32, hi = trunc(x)
    r1 = x - hi32
    mid32, mid = trunc(r1)
    lo = (r1 - mid32).astype(jnp.bfloat16)
    return hi, mid, lo


def _deposit_matmul(contrib, bins, C: int):
    """Scatter-free deposit as a matrix product: out[c, :] =
    sum_{b: bins[b]==c} contrib[b, :].

    The one-hot LHS is exact in bfloat16; ``contrib`` is split into three
    bfloat16 planes (hi + mid + lo recover the f32 value to ~2^-26 relative)
    concatenated along K so the one-hot is read once, and the three f32
    partial sums are re-added. Accumulation is f32; adding the one-hot's
    exact zeros costs no rounding, so the effective accumulation depth is
    rays-per-cell, same as the scatter.
    """
    B, K = contrib.shape
    oh = (bins[:, None] == jax.lax.broadcasted_iota(jnp.int32, (B, C), 1)
          ).astype(jnp.bfloat16)
    hi, mid, lo = split_bf16x3(contrib.astype(jnp.float32))
    rhs = jnp.concatenate([hi, mid, lo], axis=1)          # [B, 3K]
    out = jax.lax.dot_general(oh, rhs, (((0,), (0,)), ((), ())),
                              preferred_element_type=jnp.float32)
    return out[:, :K] + out[:, K:2 * K] + out[:, 2 * K:]


def bin_images(Iv, res, rays, beam: DeviceBeam, method: int, scale, valid,
               deposit: str = "scatter"):
    """Deposit a batch into (image, I_ang) partial sums.

    ``Iv``: [B, K]; ``res``: TraceResult; ``rays``: dict of [B] entry coords;
    ``valid``: [B] bool (failed rays are excluded, the reference ``continue``s
    on error); ``deposit``: "scatter" (segment_sum) or "matmul" (one-hot
    matrix product).
    Returns (image [nx*ny, K] f64, I_ang [na*nb] f64) partials in
    cell-major layout; the orchestrator transposes to the reference layout.
    """
    nx, ny = beam.x.shape[0], beam.y.shape[0]
    na, nb = beam.a.shape[0], beam.b.shape[0]

    if method == 1:
        # backward: bin at the entry coordinates
        bx, by = rays["x"], rays["y"]
        ba, bb = rays["a"], rays["b"]
    else:
        # forward: bin at exit, angles negated, y mirrored for half-plane beams
        bx = res.exit_x
        by = res.exit_y
        ba = -res.exit_a
        bb = -res.exit_b
        by = jnp.where(beam.y0_nonneg & (by < 0), -by, by)

    i1 = get_index(beam.x, beam.dx, bx)
    i2 = get_index(beam.y, beam.dy, by)
    i3 = get_index(beam.a, beam.da, ba)
    i4 = get_index(beam.b, beam.db, bb)

    # near-field image: cell id i1 + i2*nx, trash bin for invalid. The
    # deposit runs in ~f32 precision (per-chunk partial sums; ~3e-7
    # relative at 500k rays/chunk) and accumulates across chunks in the
    # caller's float64 buffers.
    def _dep(x2d, dep_bins, C):
        """One deposit, strategy-dispatched: the one-hot matrix product or
        the segment_sum scatter."""
        if deposit == "matmul":
            return _deposit_matmul(x2d, dep_bins, C)
        return jax.ops.segment_sum(x2d, dep_bins, num_segments=C)

    img_ok = valid & (i1 >= 0) & (i2 >= 0)
    img_bin = jnp.where(img_ok, i1 + i2 * nx, nx * ny)
    contrib = Iv * jnp.asarray(scale, Iv.dtype)
    image = _dep(contrib, img_bin, nx * ny + 1)[:-1]

    # far-field: sum_v 2 dv Iv then scatter into i3 + i4*na. The sum is an
    # explicit multiply-and-sum: a default-precision f32 matrix-vector
    # product may run in TF32 on the GPU (~1e-3 relative).
    ang_ok = valid & (i3 >= 0) & (i4 >= 0)
    ang_bin = jnp.where(ang_ok, i3 + i4 * na, na * nb)
    tmp = jnp.sum(Iv * (2.0 * beam.dv).astype(Iv.dtype), axis=1)
    i_ang = _dep(tmp[:, None], ang_bin, na * nb + 1)[:-1, 0]
    return image.astype(jnp.float64), i_ang.astype(jnp.float64)
