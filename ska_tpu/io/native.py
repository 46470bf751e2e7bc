"""ctypes loader for the C++ host-I/O accelerator (csrc/skanative.cpp).

The shared object is never committed: it is built from csrc/ with g++
on first import, and rebuilt whenever a source is newer than it
(nativebuild.py). Import fails cleanly (callers fall back to pure
Python) when no toolchain exists.
"""

import ctypes
import os

from . import nativebuild

# SKA_NATIVE_SO points at an alternative build of the native library
# (e.g. an ASan/UBSan-instrumented one for sanitizer runs); the default
# is the in-tree artifact, rebuilt automatically when csrc/ is newer.
_SO = os.environ.get("SKA_NATIVE_SO") or nativebuild.LIBRARY

if not os.environ.get("SKA_NATIVE_SO"):
    # never auto-overwrite a user-supplied library
    if not all(os.path.exists(s) for s in nativebuild.LIBRARY_SRCS):
        if not os.path.exists(_SO):
            raise ImportError("skanative source not found")
    else:
        nativebuild.library()

_lib = ctypes.CDLL(_SO)
_lib.ska_crc32c.restype = ctypes.c_uint32
_lib.ska_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
_lib.ska_snappy_uncompressed_length.restype = ctypes.c_longlong
_lib.ska_snappy_uncompressed_length.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
_lib.ska_snappy_uncompress.restype = ctypes.c_longlong
_lib.ska_snappy_uncompress.argtypes = [
    ctypes.c_char_p,
    ctypes.c_size_t,
    ctypes.c_char_p,
    ctypes.c_size_t,
]
_lib.ska_snappy_compress.restype = ctypes.c_longlong
_lib.ska_snappy_compress.argtypes = [
    ctypes.c_char_p,
    ctypes.c_size_t,
    ctypes.c_char_p,
    ctypes.c_size_t,
]


import numpy as _np

_lib.ska_aln_write.restype = ctypes.c_int  # 0 ok, -2 allocation failure
_lib.ska_aln_write.argtypes = [
    ctypes.c_char_p,  # ref_seq
    ctypes.POINTER(ctypes.c_int64),  # chrom_len
    ctypes.c_int64,  # n_chrom
    ctypes.POINTER(ctypes.c_int32),  # m_chrom
    ctypes.POINTER(ctypes.c_int64),  # m_pos
    ctypes.c_char_p,  # bases
    ctypes.c_int64,  # n_hits
    ctypes.c_int64,  # half
    ctypes.c_char_p,  # is_ambig
    ctypes.c_int,  # mask_ambig
    ctypes.POINTER(ctypes.c_int64),  # repeat_coors
    ctypes.c_int64,  # n_repeats
    ctypes.c_char_p,  # out
]


def aln_write(ref_concat, chrom_len, m_chrom, m_pos, bases, half, is_ambig_tbl,
              mask_ambig, repeat_coors):
    """One sample's pseudoalignment (exact AlnWriter semantics) in C++."""
    total = len(ref_concat)
    out = _np.full(total, ord("-"), dtype=_np.uint8)
    chrom_len = _np.ascontiguousarray(chrom_len, dtype=_np.int64)
    m_chrom = _np.ascontiguousarray(m_chrom, dtype=_np.int32)
    m_pos = _np.ascontiguousarray(m_pos, dtype=_np.int64)
    bases = _np.ascontiguousarray(bases, dtype=_np.uint8)
    reps = _np.ascontiguousarray(repeat_coors, dtype=_np.int64)
    rc = _lib.ska_aln_write(
        ref_concat.ctypes.data_as(ctypes.c_char_p),
        chrom_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(chrom_len),
        m_chrom.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        m_pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bases.ctypes.data_as(ctypes.c_char_p),
        len(bases),
        half,
        is_ambig_tbl.ctypes.data_as(ctypes.c_char_p),
        1 if mask_ambig else 0,
        reps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(reps),
        out.ctypes.data_as(ctypes.c_char_p),
    )
    if rc == -2:
        raise MemoryError(
            "ska map: pseudoalignment buffers exceeded available memory"
        )
    return out


_u64p = ctypes.POINTER(ctypes.c_uint64)
_lib.ska_cbor_encode_uints.restype = ctypes.c_longlong
_lib.ska_cbor_encode_uints.argtypes = [_u64p, ctypes.c_longlong, ctypes.c_char_p]
_lib.ska_cbor_encode_u128.restype = ctypes.c_longlong
_lib.ska_cbor_encode_u128.argtypes = [_u64p, _u64p, ctypes.c_longlong, ctypes.c_char_p]
_lib.ska_cbor_decode_uints.restype = ctypes.c_longlong
_lib.ska_cbor_decode_uints.argtypes = [
    ctypes.c_char_p,
    ctypes.c_longlong,
    ctypes.c_longlong,
    _u64p,
    _u64p,
    ctypes.POINTER(ctypes.c_longlong),
]
_u8p = ctypes.POINTER(ctypes.c_uint8)
_lib.ska_cbor_encode_u8.restype = ctypes.c_longlong
_lib.ska_cbor_encode_u8.argtypes = [_u8p, ctypes.c_longlong, ctypes.c_char_p]
_lib.ska_cbor_decode_u8.restype = ctypes.c_longlong
_lib.ska_cbor_decode_u8.argtypes = [
    ctypes.c_char_p,
    ctypes.c_longlong,
    ctypes.c_longlong,
    _u8p,
    ctypes.POINTER(ctypes.c_longlong),
]


def cbor_encode_uints(vals) -> bytes:
    """Consecutive CBOR unsigned ints (minimal heads) for a uint64 array.

    uint8 input takes the byte-narrow encoder — same output bytes, none
    of the 8x-wider u64 staging copy (the variant matrix is the bulk of
    every `.skf` write)."""
    v = _np.asarray(vals)
    if v.dtype == _np.uint8:
        v = _np.ascontiguousarray(v)
        out = ctypes.create_string_buffer(2 * len(v) or 1)
        n = _lib.ska_cbor_encode_u8(v.ctypes.data_as(_u8p), len(v), out)
        return out.raw[:n]
    v = _np.ascontiguousarray(v, dtype=_np.uint64)
    out = ctypes.create_string_buffer(9 * len(v) or 1)
    n = _lib.ska_cbor_encode_uints(v.ctypes.data_as(_u64p), len(v), out)
    return out.raw[:n]


def cbor_encode_u128(hi, lo) -> bytes:
    """CBOR items for u128 values (hi, lo limbs): plain uints or tag-2
    bignums, ciborium-style."""
    h = _np.ascontiguousarray(hi, dtype=_np.uint64)
    l = _np.ascontiguousarray(lo, dtype=_np.uint64)
    out = ctypes.create_string_buffer(19 * len(h) or 1)
    n = _lib.ska_cbor_encode_u128(
        h.ctypes.data_as(_u64p), l.ctypes.data_as(_u64p), len(h), out
    )
    return out.raw[:n]


def cbor_decode_uints(buf, pos: int, n: int):
    """Decode up to n CBOR uints/bignums starting at buf[pos].

    Returns (count, consumed_bytes, hi, lo) — count < n means a non-uint
    item was hit and the caller must fall back element-wise from there.
    hi is None when every decoded value fits u64 (the common case: k<=31
    keys, counts, variant bytes) — skipping the hi limb halves the output
    pages touched, which dominates bulk decode cost on fault-slow hosts.
    """
    lo = _np.empty(n, dtype=_np.uint64)
    consumed = ctypes.c_longlong(0)
    # zero-copy: pass base pointer + offset instead of copying the tail
    # of the file buffer on every bulk array decode
    base = _np.frombuffer(buf, dtype=_np.uint8)
    cnt = int(
        _lib.ska_cbor_decode_uints(
            ctypes.c_char_p(base.ctypes.data + pos),
            len(buf) - pos,
            n,
            None,
            lo.ctypes.data_as(_u64p),
            ctypes.byref(consumed),
        )
    )
    used = int(consumed.value)
    # stopped at a tag-2 bignum? re-enter from there with both limbs
    if cnt < n and pos + used < len(buf) and buf[pos + used] == 0xC2:
        hi = _np.zeros(n, dtype=_np.uint64)
        consumed2 = ctypes.c_longlong(0)
        cnt2 = int(
            _lib.ska_cbor_decode_uints(
                ctypes.c_char_p(base.ctypes.data + pos + used),
                len(buf) - pos - used,
                n - cnt,
                hi[cnt:].ctypes.data_as(_u64p),
                lo[cnt:].ctypes.data_as(_u64p),
                ctypes.byref(consumed2),
            )
        )
        cnt += cnt2
        used += int(consumed2.value)
        return cnt, used, hi[:cnt], lo[:cnt]
    return cnt, used, None, lo[:cnt]


def cbor_decode_u8(buf, pos: int, n: int):
    """Decode up to n CBOR uints that all fit a byte into a uint8 array.

    Returns (count, consumed_bytes, out). count < n means some item was
    > 255 / not a uint — the caller should redo the array with
    cbor_decode_uints. The narrow output touches 1/8th the pages of the
    u64 decoder, which is the dominant cost for the `.skf` variant matrix
    (one base byte per cell) on fault-slow hosts."""
    out = _np.empty(n, dtype=_np.uint8)
    consumed = ctypes.c_longlong(0)
    base = _np.frombuffer(buf, dtype=_np.uint8)
    cnt = int(
        _lib.ska_cbor_decode_u8(
            ctypes.c_char_p(base.ctypes.data + pos),
            len(buf) - pos,
            n,
            out.ctypes.data_as(_u8p),
            ctypes.byref(consumed),
        )
    )
    return cnt, int(consumed.value), out


def crc32c(data: bytes) -> int:
    return _lib.ska_crc32c(bytes(data), len(data))


def snappy_uncompress(data: bytes) -> bytes:
    n = _lib.ska_snappy_uncompressed_length(data, len(data))
    if n < 0:
        raise ValueError("snappy: bad varint header")
    out = ctypes.create_string_buffer(n)
    got = _lib.ska_snappy_uncompress(data, len(data), out, n)
    if got != n:
        raise ValueError(f"snappy: corrupt block (got {got}, want {n})")
    return out.raw


_lib.ska_snappy_frame_decompress.restype = ctypes.c_longlong
_lib.ska_snappy_frame_decompress.argtypes = [
    ctypes.c_char_p,
    ctypes.c_size_t,
    _u8p,
    ctypes.c_size_t,
]


def snappy_frame_decompress(data: bytes):
    """Whole-frame decode: sizes with a header-only pass, then CRC-checks
    and decompresses every chunk into one numpy buffer. Returns a
    read-only memoryview (content-comparable with bytes), or None on a
    malformed frame (callers re-run the python loop for its exact error
    message). Raises ValueError on a stored-checksum mismatch, matching
    the python loop's message."""
    total = _lib.ska_snappy_frame_decompress(data, len(data), None, 0)
    if total < 0:
        return None
    out = _np.empty(int(total), dtype=_np.uint8)
    got = _lib.ska_snappy_frame_decompress(
        data, len(data), out.ctypes.data_as(_u8p), int(total)
    )
    if got == -2:
        raise ValueError(
            "snappy: corrupt chunk (stored checksum mismatch) - "
            "could not parse skf file"
        )
    if got != total:
        return None
    out.flags.writeable = False
    return memoryview(out)


def snappy_compress(data: bytes) -> bytes:
    cap = 32 + len(data) + len(data) // 6
    out = ctypes.create_string_buffer(cap)
    got = _lib.ska_snappy_compress(data, len(data), out, cap)
    if got < 0:
        raise ValueError("snappy: compress failed")
    return out.raw[:got]


_lib.ska_merge_batches.restype = ctypes.c_longlong
_lib.ska_merge_batches.argtypes = [
    _u64p, ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int64),
    ctypes.c_longlong, ctypes.c_longlong,
    _u64p, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_longlong,
]


_lib.ska_host_build.restype = ctypes.c_longlong
_lib.ska_host_build.argtypes = [
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_void_p),  # NOT c_char_p: batches contain 0x00
    ctypes.POINTER(ctypes.c_longlong),
    ctypes.c_int,
    ctypes.c_int,
]
_lib.ska_host_build_keys.argtypes = [_u64p]
_lib.ska_host_build_variants.argtypes = [_u8p]
_lib.ska_host_build_counts.argtypes = [ctypes.POINTER(ctypes.c_int64)]


def host_build(sample_seqs, k: int, rc: bool):
    """Native host-mode FASTA build+merge (csrc/host_build.cpp): one flat
    0x00-separated record batch per sample in, the merged array out —
    byte-identical to the device pipeline (sorted keys (n, W), ASCII
    variants (n, S), counts)."""
    S = len(sample_seqs)
    bufs = [_np.ascontiguousarray(s, dtype=_np.uint8) for s in sample_seqs]
    # raw addresses: a c_char_p round-trip would COPY each buffer and
    # truncate it at the first 0x00 record separator
    ptrs = (ctypes.c_void_p * S)(*[b.ctypes.data for b in bufs])
    lens = (ctypes.c_longlong * S)(*[len(b) for b in bufs])
    n = int(_lib.ska_host_build(S, ptrs, lens, int(k), 1 if rc else 0))
    if n == -2:
        raise MemoryError("ska build: native host build exceeded memory")
    if n < 0:
        raise ValueError("ska build: invalid native host build arguments")
    try:
        W = 1 if k <= 31 else 2
        keys = _np.zeros((n, W), dtype=_np.uint64)
        variants = _np.zeros((n, S), dtype=_np.uint8)
        counts = _np.zeros(n, dtype=_np.int64)
        if n:
            _lib.ska_host_build_keys(keys.ctypes.data_as(_u64p))
            _lib.ska_host_build_variants(variants.ctypes.data_as(_u8p))
            _lib.ska_host_build_counts(
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            )
    finally:
        # always free the C++-side result (it can be hundreds of MB);
        # a MemoryError on the numpy allocations above must not leak it
        _lib.ska_host_build_release()
    return keys, variants, counts


_lib.ska_host_cov_hist.restype = ctypes.c_longlong
_lib.ska_host_cov_hist.argtypes = [
    _u8p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.POINTER(ctypes.c_int64),
]


def cov_hist(seq, k: int, rc: bool, max_count: int):
    """Per-split-key occurrence-count histogram of one flat record batch
    (ska cov counting phase, coverage.rs:104-135): bins[c-1] = distinct
    keys seen exactly c times, c <= max_count. None on engine failure."""
    buf = np.ascontiguousarray(seq, dtype=np.uint8)
    out = np.zeros(max_count, dtype=np.int64)
    n = _lib.ska_host_cov_hist(
        buf.ctypes.data_as(_u8p), len(buf), int(k), int(bool(rc)),
        int(max_count), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if n < 0:
        return None
    return out


_lib.ska_host_ref_scan.restype = ctypes.c_longlong
_lib.ska_host_ref_scan.argtypes = [
    ctypes.c_void_p,
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_int,
]
_lib.ska_host_ref_scan_keys.argtypes = [_u64p]
_lib.ska_host_ref_scan_pos.argtypes = [ctypes.POINTER(ctypes.c_int64)]
_lib.ska_host_ref_scan_rc.argtypes = [_u8p]


def host_ref_scan(seq, k: int, rc: bool):
    """Native positional split k-mer scan of a flat 0x00-separated record
    batch (the RefSka indexing pass): returns (keys (n, W), window start
    indices (n,) int64, rc flags (n,) bool) in positional order."""
    buf = _np.ascontiguousarray(seq, dtype=_np.uint8)
    n = int(_lib.ska_host_ref_scan(buf.ctypes.data, len(buf), int(k),
                                   1 if rc else 0))
    if n == -2:
        raise MemoryError("ska map: native reference scan exceeded memory")
    if n < 0:
        raise ValueError("ska map: invalid native reference scan arguments")
    try:
        W = 1 if k <= 31 else 2
        keys = _np.zeros((n, W), dtype=_np.uint64)
        pos = _np.zeros(n, dtype=_np.int64)
        rcf = _np.zeros(n, dtype=_np.uint8)
        if n:
            _lib.ska_host_ref_scan_keys(keys.ctypes.data_as(_u64p))
            _lib.ska_host_ref_scan_pos(
                pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            )
            _lib.ska_host_ref_scan_rc(rcf.ctypes.data_as(_u8p))
    finally:
        _lib.ska_host_ref_scan_release()
    return keys, pos, rcf.astype(bool)


def merge_batches(keys_list, var_list):
    """B-way merge of per-batch (sorted keys (n_b, W), variants (n_b, S_b))
    into (union keys, variants, counts) — csrc/merge_batches.cpp."""
    B = len(keys_list)
    W = keys_list[0].shape[1]
    i64 = ctypes.POINTER(ctypes.c_int64)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    keys_cat = _np.ascontiguousarray(
        _np.concatenate(keys_list, axis=0), dtype=_np.uint64
    )
    n_off = _np.zeros(B + 1, _np.int64)
    v_off = _np.zeros(B + 1, _np.int64)
    col_off = _np.zeros(B + 1, _np.int64)
    flat = []
    for b in range(B):
        n_off[b + 1] = n_off[b] + len(keys_list[b])
        v_off[b + 1] = v_off[b] + var_list[b].size
        col_off[b + 1] = col_off[b] + var_list[b].shape[1]
        flat.append(_np.ascontiguousarray(var_list[b], dtype=_np.uint8).reshape(-1))
    var_cat = (
        _np.concatenate(flat) if flat else _np.zeros(0, _np.uint8)
    )
    s_total = int(col_off[-1])
    cap = int(n_off[-1])
    out_keys = _np.zeros((max(cap, 1), W), _np.uint64)
    out_var = _np.full((max(cap, 1), max(s_total, 1)), ord("-"), _np.uint8)
    out_counts = _np.zeros(max(cap, 1), _np.int64)
    r = _lib.ska_merge_batches(
        keys_cat.ctypes.data_as(_u64p),
        n_off.ctypes.data_as(i64),
        var_cat.ctypes.data_as(u8),
        v_off.ctypes.data_as(i64),
        col_off.ctypes.data_as(i64),
        B, W,
        out_keys.ctypes.data_as(_u64p),
        out_var.ctypes.data_as(u8),
        out_counts.ctypes.data_as(i64),
        s_total,
    )
    if r == -2:
        raise MemoryError("ska merge: union buffers exceeded available memory")
    return out_keys[:r], out_var[:r], out_counts[:r]


_lib.ska_map_lookup.restype = None
_lib.ska_map_lookup.argtypes = [
    _u64p,
    ctypes.c_longlong,
    _u64p,
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.POINTER(ctypes.c_int64),
    _u8p,
]


_lib.ska_map_gather.restype = ctypes.c_longlong
_lib.ska_map_gather.argtypes = [
    _u64p,
    ctypes.c_longlong,
    _u64p,
    ctypes.c_longlong,
    ctypes.c_int,
    _u8p,
    ctypes.POINTER(ctypes.c_int64),
    _u8p,
    ctypes.c_int,
    _u8p,
    ctypes.POINTER(ctypes.c_int64),
    _u8p,
]


def map_gather(sorted_keys, needles, krc, variants, rc_tab, perm=None):
    """Fused `ska map` host lookup (ska_ref.rs:508-533): prefix-bucketed
    binary search of (m, W) needle keys in the lex-sorted (n, W) table,
    plus in-pass gather of the matching variants rows with reverse-
    strand hits translated through RC_IUPAC (ska_ref.rs:520-526).
    Returns (hit_idx int64[h] — needle index per hit, ascending,
    rows uint8[h, S]) or None when n exceeds the kernel's int32 scratch
    (callers fall back to map_lookup)."""
    sk = _np.ascontiguousarray(sorted_keys, dtype=_np.uint64)
    nd = _np.ascontiguousarray(needles, dtype=_np.uint64)
    if sk.ndim == 1:
        sk = sk[:, None]
    if nd.ndim == 1:
        nd = nd[:, None]
    W = sk.shape[1]
    if nd.shape[1] != W or W not in (1, 2):
        raise ValueError("map_gather: limb width mismatch")
    if sk.shape[0] > 0x7FFFFFFF:
        return None
    var = _np.ascontiguousarray(variants, dtype=_np.uint8)
    n, S = var.shape
    if n != sk.shape[0]:
        raise ValueError("map_gather: variants/keys row mismatch")
    m = nd.shape[0]
    krc_u8 = _np.ascontiguousarray(krc, dtype=_np.uint8)
    if krc_u8.shape[0] != m:
        raise ValueError("map_gather: krc length mismatch")
    tab = _np.ascontiguousarray(rc_tab, dtype=_np.uint8)
    if tab.shape[0] < 256:
        raise ValueError("map_gather: rc_tab must have 256 entries")
    if perm is not None:
        perm = _np.ascontiguousarray(perm, dtype=_np.int64)
        if perm.shape[0] != n:
            raise ValueError("map_gather: perm length mismatch")
    out_hit = _np.empty(m, dtype=_np.int64)
    out_rows = _np.empty((m, S), dtype=_np.uint8)
    h = _lib.ska_map_gather(
        sk.ctypes.data_as(_u64p),
        n,
        nd.ctypes.data_as(_u64p),
        m,
        W,
        krc_u8.ctypes.data_as(_u8p),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        if perm is not None
        else None,
        var.ctypes.data_as(_u8p),
        S,
        tab.ctypes.data_as(_u8p),
        out_hit.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_rows.ctypes.data_as(_u8p),
    )
    if h < 0:
        return None
    return out_hit[:h], out_rows[:h]


_lib.ska_filter_keep.restype = None
_lib.ska_filter_keep.argtypes = [
    _u8p,
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_void_p,
    ctypes.c_int,
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_int,
    _u8p,
    _u8p,
]
_lib.ska_update_counts.restype = None
_lib.ska_update_counts.argtypes = [
    _u8p,
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_int,
    _u8p,
    ctypes.POINTER(ctypes.c_int64),
]

_FILTER_MODE = {"no-filter": 0, "no-const": 1, "no-ambig": 2,
                "no-ambig-or-const": 3}


def filter_keep(variants, counts, min_count, filter_type,
                ignore_const_gaps, is_ambig):
    """Single-pass site-filter keep mask (merge_ska_array.rs:289-402):
    keep[i] = counts[i] >= min_count and the filter_type predicate on
    row i. Returns a bool (n,) array, or None for an unknown filter
    (callers fall back to the numpy chain)."""
    mode = _FILTER_MODE.get(filter_type)
    if mode is None:
        return None
    var = _np.ascontiguousarray(variants, dtype=_np.uint8)
    n, S = var.shape
    c = _np.ascontiguousarray(counts)
    if c.dtype == _np.uint8:
        c_is64 = 0
    else:
        if c.dtype != _np.int64:
            c = c.astype(_np.int64)
        c_is64 = 1
    if c.shape[0] != n:
        raise ValueError("filter_keep: counts length mismatch")
    tab = _np.ascontiguousarray(is_ambig, dtype=_np.uint8)
    keep = _np.empty(n, dtype=_np.uint8)
    _lib.ska_filter_keep(
        var.ctypes.data_as(_u8p),
        n,
        S,
        c.ctypes.data_as(ctypes.c_void_p),
        c_is64,
        int(min_count),
        mode,
        1 if ignore_const_gaps else 0,
        tab.ctypes.data_as(_u8p),
        keep.ctypes.data_as(_u8p),
    )
    return keep.view(bool)


def update_counts(variants, drop_ambig, is_ambig):
    """Single-pass per-row non-missing recount
    (merge_ska_array.rs:139-163). Returns int64 (n,)."""
    var = _np.ascontiguousarray(variants, dtype=_np.uint8)
    n, S = var.shape
    tab = _np.ascontiguousarray(is_ambig, dtype=_np.uint8)
    out = _np.empty(n, dtype=_np.int64)
    _lib.ska_update_counts(
        var.ctypes.data_as(_u8p),
        n,
        S,
        1 if drop_ambig else 0,
        tab.ctypes.data_as(_u8p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def map_lookup(sorted_keys, needles):
    """Binary search of (m, W) needle keys in a lex-sorted (n, W) table
    (the `ska map` dict lookup, ska_ref.rs:508-533): returns
    (found (m,) bool, idx (m,) int64 row of the exact match — only
    meaningful where found)."""
    sk = _np.ascontiguousarray(sorted_keys, dtype=_np.uint64)
    nd = _np.ascontiguousarray(needles, dtype=_np.uint64)
    if sk.ndim == 1:
        sk = sk[:, None]
    if nd.ndim == 1:
        nd = nd[:, None]
    W = sk.shape[1]
    if nd.shape[1] != W or W not in (1, 2):
        raise ValueError("map_lookup: limb width mismatch")
    m = nd.shape[0]
    idx = _np.zeros(m, dtype=_np.int64)
    found = _np.zeros(m, dtype=_np.uint8)
    _lib.ska_map_lookup(
        sk.ctypes.data_as(_u64p),
        sk.shape[0],
        nd.ctypes.data_as(_u64p),
        m,
        W,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        found.ctypes.data_as(_u8p),
    )
    return found.astype(bool), idx


_lib.ska_host_save.restype = ctypes.c_longlong
_lib.ska_host_save.argtypes = [
    ctypes.c_char_p,
    _u64p,
    ctypes.c_longlong,
    ctypes.c_int,
    _u8p,
    ctypes.c_longlong,
    _u64p,
    ctypes.c_char_p,   # NUL-separated names blob
    ctypes.c_longlong,
    ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_int,
    ctypes.c_char_p,   # version text
    ctypes.c_longlong,
]


def skf_save(path, keys, variants, counts, names, k, rc, ska_version) -> bool:
    """One-pass native `.skf` writer (csrc/host_modes.cpp ska_host_save):
    CBOR encode + snappy framing byte-identical to the python encoder
    (io/skf.py + io/snappy.py; equality pinned by tests). Returns False
    when the native writer declined (caller runs the python encoder)."""
    keys_np = _np.ascontiguousarray(keys, dtype=_np.uint64)
    if keys_np.ndim == 1:
        keys_np = keys_np[:, None]
    n, W = keys_np.shape
    if W not in (1, 2):
        return False
    var = _np.ascontiguousarray(variants, dtype=_np.uint8)
    if var.ndim != 2 or var.shape[0] != n:
        return False
    counts_np = _np.ascontiguousarray(counts, dtype=_np.uint64)
    if counts_np.shape[0] != n:
        return False
    blob = b"\x00".join(str(nm).encode("utf-8") for nm in names)
    ver = str(ska_version).encode("utf-8")
    rcv = _lib.ska_host_save(
        path.encode(),
        keys_np.ctypes.data_as(_u64p),
        n,
        int(W),
        var.ctypes.data_as(_u8p),
        var.shape[1],
        counts_np.ctypes.data_as(_u64p),
        blob,
        len(blob),
        len(names),
        int(k),
        1 if rc else 0,
        ver,
        len(ver),
    )
    return rcv == 0
