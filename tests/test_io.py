"""Serialization tests: byte-exact parsing of the shipped snapshots +
pack/unpack round-trips (SURVEY.md section 4 test plan (a))."""

import os

import numpy as np
import pytest

import raytrace_tpu  # noqa: F401  (enables x64)
from raytrace_tpu.io import compression as zc
from raytrace_tpu.io import serialization as ser
from raytrace_tpu.io.loader import load_input, save_input, scale_problem
from raytrace_tpu.structures import approx_equal
from raytrace_tpu.testing import (ASE_SNAPSHOT as ASE, SEED_SNAPSHOT as SEED,
                                  synthetic_problem)

HAVE_DATA = os.path.exists(ASE) and os.path.exists(SEED)


@pytest.mark.skipif(not HAVE_DATA, reason="reference inputs not present")
def test_parse_ase_small():
    p, img0, iang0 = load_input(ASE)
    b = p.euv_beam
    assert (b.nx, b.ny, b.nz, b.na, b.nb, b.nv) == (60, 25, 8, 19, 14, 52)
    assert p.N == 3 and p.seed is None and p.seed_beam is None
    assert b.dz == pytest.approx(0.05)
    for g in p.gain:
        assert (g.Nx, g.Ny, g.Nv) == (106, 26, 52)
        assert g.E0 is not None and np.all(np.isfinite(g.n))
    assert img0.shape == (60 * 25 * 52,)
    assert iang0.shape == (19 * 14,)
    assert np.linalg.norm(img0) == pytest.approx(221.21691392, rel=1e-9)


@pytest.mark.skipif(not HAVE_DATA, reason="reference inputs not present")
def test_parse_seed_small():
    p, img0, iang0 = load_input(SEED)
    assert p.euv_beam.nv == 82
    assert p.seed is not None and list(p.seed.dim) == [251] * 4 + [82]
    assert p.seed_beam is not None and p.seed_beam.nx == 120
    assert not p.seed.is_zero(p.euv_beam)


@pytest.mark.skipif(not HAVE_DATA, reason="reference inputs not present")
def test_roundtrip_shipped_files():
    """unpack(pack(unpack(file))) must reproduce every field (semantic
    round-trip; byte-exactness is not required because the original files'
    seed-shape compression level is not recorded outside the blobs)."""
    for path in (ASE, SEED):
        with open(path, "rb") as f:
            f.read(8)
            original = f.read()
        p = ser.unpack_create_image(original)
        q = ser.unpack_create_image(ser.pack_create_image(p))
        assert q.euv_beam == p.euv_beam
        assert (q.seed_beam is None) == (p.seed_beam is None)
        if p.seed_beam is not None:
            assert q.seed_beam == p.seed_beam
        for a, b in zip(q.gain, p.gain):
            assert np.array_equal(a.n, b.n)
            assert np.array_equal(a.g0, b.g0)
            assert np.array_equal(a.gv, b.gv)
        if p.seed is not None:
            assert np.array_equal(q.seed.f[4], p.seed.f[4])
            assert q.seed.f0 == p.seed.f0
        assert np.array_equal(q.image, p.image)
        assert np.array_equal(q.I_ang, p.I_ang)


def test_roundtrip_synthetic(tmp_path):
    p = synthetic_problem(seeded=True)
    path = tmp_path / "syn.dat"
    save_input(path, p)
    q, img0, iang0 = load_input(path)
    assert q.euv_beam == p.euv_beam
    assert q.seed_beam == p.seed_beam
    assert approx_equal(q.seed.f0, p.seed.f0)
    for a, b in zip(q.gain, p.gain):
        assert np.array_equal(a.n, b.n)
        assert np.array_equal(a.gv, b.gv)


def test_header_roundtrip():
    h = ser.ByteArrayHeader(version=2, type=3, n_bytes=123456789,
                            flags=b"\x02\x00\x00\x00")
    data = h.dump()
    assert len(data) == 16 and data[0] == 237
    h2, off = ser.ByteArrayHeader.load(data)
    assert off == 16
    assert (h2.version, h2.type, h2.n_bytes, h2.flags[0]) == (2, 3, 123456789, 2)


def test_headerless_detection():
    data = b"\x01\x02\x03\x04" * 8
    h, off = ser.ByteArrayHeader.load(data)
    assert off == 0 and h.version == 0


@pytest.mark.parametrize("method", [0, 1, 2])
def test_compression_roundtrip(method):
    rng = np.random.default_rng(0)
    data = rng.normal(size=257)
    data[rng.random(257) < 0.6] = 0.0
    blob = zc.compress_array(data, method)
    out = zc.decompress_array(257, blob, method, np.float64)
    if method == 2:
        assert np.allclose(out, data.astype(np.float32))
    else:
        assert np.array_equal(out, data)


def test_compression_all_zero():
    blob = zc.compress_array(np.zeros(100), 1)
    assert blob == bytes([7])
    out = zc.decompress_array(100, blob, 1, np.float64)
    assert np.array_equal(out, np.zeros(100))


def test_compression_bool():
    rng = np.random.default_rng(1)
    data = rng.random(77) < 0.5
    assert np.array_equal(zc.decompress_bool(77, zc.compress_bool(data)), data)


def test_seed_beam_shape_compressed_roundtrip():
    from raytrace_tpu.structures import SeedBeamShape
    rng = np.random.default_rng(2)
    s = SeedBeamShape().initialize(11, 4)
    s.T[:] = np.sort(rng.random(11))
    s.It[:] = rng.random(33) * (rng.random(33) < 0.5)
    s.Ivt[:] = rng.random(132) * (rng.random(132) < 0.3)
    for comp in (0, 1, 2):
        blob = ser.pack_seed_beam_shape(s, comp)
        s2 = ser.unpack_seed_beam_shape(blob)
        if comp == 2:  # lossy f32 mode
            assert np.allclose(s2.T, s.T, rtol=1e-7)
            assert np.allclose(s2.It, s.It, rtol=1e-7)
            assert np.allclose(s2.Ivt, s.Ivt, rtol=1e-7)
        else:  # modes 0/1 are bit-lossless: exact equality, no atol slack
            assert np.array_equal(s2.T, s.T)
            assert np.array_equal(s2.It, s.It)
            assert np.array_equal(s2.Ivt, s.Ivt)


def test_scale_problem():
    p = synthetic_problem()
    nx0 = p.euv_beam.nx
    lo = p.euv_beam.x[0] - 0.5 * p.euv_beam.dx
    scale_problem(p, 2.0)
    assert p.euv_beam.nx == int(nx0 * 2 ** 0.25)
    assert p.euv_beam.x[0] - 0.5 * p.euv_beam.dx == pytest.approx(lo)


@pytest.mark.skipif(not HAVE_DATA, reason="reference snapshots not present")
def test_truncated_snapshot_raises_cleanly(tmp_path):
    """Short reads must raise (the fread2 contract: the reference prints and
    hard-exits on a short read, CreateImageHelpers.cpp:35-42; we raise) --
    never segfault or return garbage, through both the native parser and
    the pure-Python fallback."""
    import numpy as np

    data = open(ASE, "rb").read()
    rng = np.random.default_rng(0)
    for cut in sorted(int(c) for c in rng.integers(1, len(data), 12)):
        p = tmp_path / f"cut_{cut}.dat"
        p.write_bytes(data[:cut])
        with pytest.raises((OSError, ValueError, EOFError)):
            load_input(str(p))


def test_native_decompress_matches_python():
    """The native decompressor (wired into decompress_array for float
    dtypes) must be byte-identical to the numpy reference path across all
    modes and special cases (all-zero collapse, dense no-win storage)."""
    native = pytest.importorskip("raytrace_native")
    rng = np.random.default_rng(9)
    cases = [
        np.zeros(64),                                   # all-zero byte 7
        rng.random(257) * (rng.random(257) < 0.3),      # sparse
        rng.random(100),                                # dense no-win
        rng.random(8) * (rng.random(8) < 0.5),
    ]
    def both(n, blob, method, dt):
        got = native.decompress_array(n, blob, method, dt == np.float32)
        # bypass the delegation to reach the numpy reference path
        zc_native, zc._native = zc._native, None
        try:
            want = zc.decompress_array(n, blob, method, dt)
        finally:
            zc._native = zc_native
        assert got.dtype == np.dtype(dt)
        assert np.array_equal(got, want), (method, dt)

    for data in cases:
        # modes 0/1: the payload dtype must match the requested dtype
        for dt in (np.float64, np.float32):
            src = data.astype(dt)
            for method in (0, 1):
                both(src.size, zc.compress_array(src, method), method, dt)
        # mode 2 stores f32; decompress to either width
        blob2 = zc.compress_array(data.astype(np.float64), 2)
        both(data.size, blob2, 2, np.float64)
        both(data.size, blob2, 2, np.float32)


def test_native_parse_views_own_their_buffer():
    """parse_create_image returns memoryview slices of the input; they must
    keep the underlying bytes alive after the caller drops its reference
    (regression: raw FromMemory views aliased freed memory)."""
    native = pytest.importorskip("raytrace_native")
    import gc

    p = synthetic_problem(nx=3, ny=2, na=2, nb=2, nv=3)
    d = native.parse_create_image(bytes(ser.pack_create_image(p)))
    gc.collect()  # the temporary bytes object must stay pinned by the views
    assert bytes(d["euv_blob"])  # reads through the view
