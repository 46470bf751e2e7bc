"""Fully-fused per-sample build pipeline (one jit dispatch per sample).

extract -> (middle-qual gate) -> (count filter) -> pack set into key ->
sort -> segment boundaries -> segmented union, all in a single compiled
program with no scatters: segment reductions use lax.cummax of start
indices plus log2(L) masked shift/OR doubling passes. Occurrence sets
ride in the 4 spare low bits of the packed key (2*(k-1) <= 60 bits for
k <= 31, <= 124 for k <= 63), so the dedup sort is single-operand for
the u64 case.

Replaces reference hot loops #1-#2 (split_kmer.rs:159-217 rolling +
ska_dict.rs:76-113 hashmap inserts) and the KmerFilter
(bloom_filter.rs:116-148).
"""

from functools import partial

from ..jaxinit import jax, jnp
import numpy as np

from . import extract as X
from . import keys as K

U64 = jnp.uint64
_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _pack_key_set(keys, sets, W):
    """(key << 4) | set in W uint64 limbs (key bits < 64*W - 4).
    Works on (..., W) keys with matching (...) sets."""
    if W == 1:
        return ((keys[..., 0] << U64(4)) | sets.astype(U64))[..., None]
    hi, lo = keys[..., 0], keys[..., 1]
    nhi = (hi << U64(4)) | (lo >> U64(60))
    nlo = (lo << U64(4)) | sets.astype(U64)
    return jnp.stack([nhi, nlo], axis=-1)


def _seg_start_idx(first):
    i32 = jnp.arange(first.shape[0], dtype=jnp.int32)
    return jax.lax.cummax(jnp.where(first, i32, -1))


def _seg_union(vals, ssi):
    """OR within each sorted segment via masked doubling (log2 L passes)."""
    L = vals.shape[0]
    i32 = jnp.arange(L, dtype=jnp.int32)
    v = vals
    d = 1
    while d < L:
        shifted = jnp.concatenate([jnp.zeros(d, v.dtype), v[:-d]])
        v = jnp.where((i32 - d) >= ssi, v | shifted, v)
        d <<= 1
    return v


def _seg_union_rows(vals, ssi):
    """Row-wise _seg_union over (S, L) values (segments never cross rows)."""
    S, L = vals.shape
    i32 = jnp.arange(L, dtype=jnp.int32)[None]
    v = vals
    d = 1
    while d < L:
        shifted = jnp.concatenate([jnp.zeros((S, d), v.dtype), v[:, :-d]], axis=1)
        v = jnp.where((i32 - d) >= ssi, v | shifted, v)
        d <<= 1
    return v


@partial(
    jax.jit,
    static_argnames=("k", "rc", "W", "is_reads", "use_mid_qual", "min_count"),
)
def sample_pipeline(
    seq,
    valid,
    qual_ok,
    rec_last,
    k: int,
    rc: bool,
    W: int,
    is_reads: bool,
    use_mid_qual: bool,
    min_count: int,
):
    """One sample's dictionary build on device.

    Returns (packed (L, W) sorted with sentinels last, union uint8[L],
    is_end bool[L], n_unique int32). Row i of the final dictionary is
    the i-th True of (is_end & non-sentinel); its key is packed >> 4 and
    its IUPAC set is union at that row.
    """
    L = seq.shape[0]
    h = (k - 1) // 2
    want_whole = bool(is_reads and min_count > 1)
    res = X.extract_windows(seq, valid, rec_last, k, rc, W, want_whole)
    emit = res["emit"]

    if is_reads and use_mid_qual:
        # middle-base quality gate (ska_dict.rs:156-157)
        mid_ok = jnp.concatenate([qual_ok[h:], jnp.zeros(h, bool)])
        emit = emit & mid_ok

    mid = res["mid"]
    sets = (
        jnp.left_shift(jnp.uint8(1), mid)
        | jnp.where(res["pal"], jnp.left_shift(jnp.uint8(1), mid ^ 2), 0)
    ).astype(jnp.uint8)
    packed = _pack_key_set(res["key"], sets, W)

    if want_whole:
        # per-occurrence min-count rank filter over whole k-mers
        # (bloom_filter.rs:116-148 semantics; see ops/segment.py docs)
        pos = jnp.arange(L, dtype=jnp.int32)
        wkeys = jnp.where(
            emit[:, None], res["whole"], jnp.full_like(res["whole"], _SENT)
        )
        ops = tuple(wkeys[:, i] for i in range(W)) + (pos,) + tuple(
            packed[:, i] for i in range(W)
        ) + (emit,)
        sres = K.lax_sort_fast(ops, num_keys=W + 1)
        swk = jnp.stack(sres[:W], axis=-1)
        spacked = jnp.stack(sres[W + 1 : W + 1 + W], axis=-1)
        semit = sres[W + 1 + W]
        first = jnp.concatenate(
            [jnp.ones(1, bool), jnp.any(swk[1:] != swk[:-1], axis=-1)]
        )
        rank = jnp.arange(L, dtype=jnp.int32) - _seg_start_idx(first) + 1
        if min_count == 2:
            ok = rank >= 2
        else:
            ok = rank == min_count
        keep = ok & semit
        packed = jnp.where(keep[:, None], spacked, jnp.full_like(spacked, _SENT))
    else:
        packed = jnp.where(emit[:, None], packed, jnp.full_like(packed, _SENT))

    # dedup + union: unstable is sound (operands are the packed values
    # themselves — equal rows are interchangeable) and ~19% cheaper
    sres = K.lax_sort_fast(
        tuple(packed[:, i] for i in range(W)), num_keys=W, is_stable=False
    )
    sp = jnp.stack(sres, axis=-1)
    kp = K.shr(sp, 4)  # key part only (drop the set bits)
    first = jnp.concatenate([jnp.ones(1, bool), jnp.any(kp[1:] != kp[:-1], axis=-1)])
    ssi = _seg_start_idx(first)
    union = _seg_union((sp[:, W - 1] & U64(15)).astype(jnp.uint8), ssi)
    is_end = jnp.concatenate([first[1:], jnp.ones(1, bool)])
    nonsent = jnp.any(sp != U64(_SENT), axis=-1)
    n_unique = jnp.sum((first & nonsent).astype(jnp.int32))
    return sp, union, is_end, n_unique


@partial(
    jax.jit,
    static_argnames=("k", "rc", "W", "is_reads", "use_mid_qual", "min_count"),
)
def batched_pipeline(
    seqs,
    valid,
    qual_ok,
    rec_last,
    k: int,
    rc: bool,
    W: int,
    is_reads: bool,
    use_mid_qual: bool,
    min_count: int,
):
    """sample_pipeline over a leading samples axis: one dispatch for a
    whole batch of genomes. Implemented with 2-D row-wise sorts
    (dimension=-1), NOT vmap: K.lax_sort_fast's rare-tie fallback is a
    lax.cond, and a vmapped cond would execute both branches for the
    whole batch. Only the extraction kernel is vmapped (no control
    flow inside). Output contract identical to vmap(sample_pipeline)."""
    S, L = seqs.shape
    h = (k - 1) // 2
    want_whole = bool(is_reads and min_count > 1)
    res = jax.vmap(
        lambda s, v, r: X.extract_windows.__wrapped__(s, v, r, k, rc, W, want_whole)
    )(seqs, valid, rec_last)
    emit = res["emit"]

    if is_reads and use_mid_qual:
        mid_ok = jnp.concatenate(
            [qual_ok[:, h:], jnp.zeros((S, h), bool)], axis=1
        )
        emit = emit & mid_ok

    mid = res["mid"]
    sets = (
        jnp.left_shift(jnp.uint8(1), mid)
        | jnp.where(res["pal"], jnp.left_shift(jnp.uint8(1), mid ^ 2), 0)
    ).astype(jnp.uint8)
    packed = _pack_key_set(res["key"], sets, W)  # (S, L, W)
    i32row = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None], (S, L))

    if want_whole:
        # per-occurrence min-count rank filter over whole k-mers
        # (bloom_filter.rs:116-148 semantics; see ops/segment.py docs)
        wkeys = jnp.where(
            emit[..., None], res["whole"], jnp.full_like(res["whole"], _SENT)
        )
        ops = tuple(wkeys[..., i] for i in range(W)) + (i32row,) + tuple(
            packed[..., i] for i in range(W)
        ) + (emit,)
        sres = K.lax_sort_fast(ops, num_keys=W + 1, dimension=-1)
        swk = jnp.stack(sres[:W], axis=-1)
        spacked = jnp.stack(sres[W + 1 : W + 1 + W], axis=-1)
        semit = sres[W + 1 + W]
        first = jnp.concatenate(
            [jnp.ones((S, 1), bool), jnp.any(swk[:, 1:] != swk[:, :-1], axis=-1)],
            axis=1,
        )
        ssi = jax.lax.cummax(jnp.where(first, i32row, -1), axis=1)
        rank = i32row - ssi + 1
        if min_count == 2:
            ok = rank >= 2
        else:
            ok = rank == min_count
        keep = ok & semit
        packed = jnp.where(keep[..., None], spacked, jnp.full_like(spacked, _SENT))
    else:
        packed = jnp.where(emit[..., None], packed, jnp.full_like(packed, _SENT))

    # dedup + union (row-wise): unstable is sound (operands are the
    # packed values themselves) and ~19% cheaper
    sres = K.lax_sort_fast(
        tuple(packed[..., i] for i in range(W)), num_keys=W, dimension=-1,
        is_stable=False,
    )
    sp = jnp.stack(sres, axis=-1)
    kp = K.shr(sp, 4)  # key part only (drop the set bits)
    first = jnp.concatenate(
        [jnp.ones((S, 1), bool), jnp.any(kp[:, 1:] != kp[:, :-1], axis=-1)], axis=1
    )
    ssi = jax.lax.cummax(jnp.where(first, i32row, -1), axis=1)
    union = _seg_union_rows((sp[..., W - 1] & U64(15)).astype(jnp.uint8), ssi)
    is_end = jnp.concatenate([first[:, 1:], jnp.ones((S, 1), bool)], axis=1)
    nonsent = jnp.any(sp != U64(_SENT), axis=-1)
    n_unique = jnp.sum((first & nonsent).astype(jnp.int32), axis=1)
    return sp, union, is_end, n_unique


def _merged_impl(
    seqs,
    valid,
    qual_ok,
    rec_last,
    k: int,
    rc: bool,
    W: int,
    is_reads: bool,
    use_mid_qual: bool,
    min_count: int,
    from_codes: bool = False,
    pack_variants: bool = False,
):
    """Whole-batch build + merge in ONE device program (trace body).

    Replaces {per-sample sort + host lexsort merge + host matrix build}
    (reference merge_ska_dict.rs:77-151,354-417 + merge_ska_array.rs:166-186)
    with a single global sort by (split k-mer key, sample id) over all S
    samples, a segmented IUPAC union per (key, sample) group, and
    device-side scatters into the final variants matrix. Only the compact
    merged array ever crosses device->host.

    seqs/valid/qual_ok/rec_last: (S, L); seqs is ASCII bytes, or 2-bit
    codes when from_codes (the packed-transfer path). Returns
      ukeys    (S*L, W) uint64 — merged keys, rows [0, n_rows) valid
      variants (S*L, S) uint8 ASCII IUPAC / '-' matrix, or — when
               pack_variants — (S*L, ceil(S/2)) uint8 with two 4-bit
               IUPAC set codes per byte (gap = 0): the device->host
               transfer is the build's dominant link cost, and the set
               codes fit in half the bytes ASCII needs
      counts   (S*L,) int32    — samples present per row
      n_rows   int32 scalar
    """
    S, L = seqs.shape
    N = S * L
    if N * S + 1 > 0x7FFFFFFF:
        # the variants scatter below addresses an (N, S) buffer with
        # int32 indices (rows * S + sample), and the buffer itself is
        # N*S bytes — S^2 * L. _auto_max_batch caps the product; an
        # explicit SKA_MAX_BATCH / max_batch override can still exceed
        # it, so fail with the remedy instead of an indexing overflow
        raise ValueError(
            f"merged build batch too large: {S} samples x {L} padded "
            f"bases needs a {N}x{S} variants scatter (> int32 index "
            f"space); lower SKA_MAX_BATCH so that S*S*L <= 2^31"
        )
    h = (k - 1) // 2
    want_whole = bool(is_reads and min_count > 1)

    res = jax.vmap(
        lambda s, v, r: X.extract_windows.__wrapped__(
            s, v, r, k, rc, W, want_whole, from_codes
        )
    )(seqs, valid, rec_last)
    emit = res["emit"]
    if is_reads and use_mid_qual:
        mid_ok = jnp.concatenate(
            [qual_ok[:, h:], jnp.zeros((S, h), bool)], axis=1
        )
        emit = emit & mid_ok

    mid = res["mid"]
    sets = (
        jnp.left_shift(jnp.uint8(1), mid)
        | jnp.where(res["pal"], jnp.left_shift(jnp.uint8(1), mid ^ 2), 0)
    ).astype(jnp.uint8)
    keys = res["key"]  # (S, L, W)

    if want_whole:
        # per-sample min-count rank filter over whole k-mers
        # (bloom_filter.rs:116-148 semantics); lax.sort on (S, L) operands
        # sorts each sample row independently
        pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None], (S, L))
        wkeys = jnp.where(
            emit[:, :, None], res["whole"], jnp.full_like(res["whole"], _SENT)
        )
        ops = tuple(wkeys[..., i] for i in range(W)) + (pos,) + tuple(
            keys[..., i] for i in range(W)
        ) + (sets, emit)
        sres = K.lax_sort_fast(ops, num_keys=W + 1, dimension=-1)
        swk = jnp.stack(sres[:W], axis=-1)
        keys = jnp.stack(sres[W + 1 : W + 1 + W], axis=-1)
        sets = sres[W + 1 + W]
        semit = sres[W + 2 + W]
        first = jnp.concatenate(
            [jnp.ones((S, 1), bool), jnp.any(swk[:, 1:] != swk[:, :-1], axis=-1)],
            axis=1,
        )
        i32row = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None], (S, L))
        ssi = jax.lax.cummax(jnp.where(first, i32row, -1), axis=1)
        rank = i32row - ssi + 1
        if min_count == 2:
            ok = rank >= 2
        else:
            ok = rank == min_count
        emit = ok & semit

    # ---- global merge across samples: one sort by (key, sample id) ----
    sid = jnp.broadcast_to(
        jnp.arange(S, dtype=jnp.int32)[:, None], (S, L)
    ).reshape(N)
    kf = keys.reshape(N, W)
    kf = jnp.where(emit.reshape(N)[:, None], kf, jnp.full_like(kf, _SENT))
    sf = jnp.where(emit.reshape(N), sets.reshape(N), 0)

    # (key, sample id) sort. Plain UNSTABLE full sort: equal keys across
    # samples are routine, so a single-key fast path would scramble sid
    # under is_stable=False and fire its fallback every time; and the
    # sets payload of equal (key, sid) rows feeds a commutative OR, so
    # instability cannot change any output byte, and an unstable sort
    # does less work than a stable one.
    ops = tuple(kf[:, i] for i in range(W)) + (sid, sf)
    gres = jax.lax.sort(ops, num_keys=W + 1, dimension=-1, is_stable=False)
    gk = jnp.stack(gres[:W], axis=-1)
    gsid, gsets = gres[W], gres[W + 1]

    live = jnp.any(gk != U64(_SENT), axis=-1)
    diff_key = jnp.concatenate(
        [jnp.ones(1, bool), jnp.any(gk[1:] != gk[:-1], axis=-1)]
    )
    first_pair = diff_key | jnp.concatenate(
        [jnp.ones(1, bool), gsid[1:] != gsid[:-1]]
    )

    # IUPAC union within each (key, sample) group
    ssi = _seg_start_idx(first_pair)
    union = _seg_union(gsets, ssi)
    pair_end = jnp.concatenate([first_pair[1:], jnp.ones(1, bool)])

    newrow = diff_key & live
    rowcum = jnp.cumsum(newrow.astype(jnp.int32))
    rows = rowcum - 1
    n_rows = rowcum[-1]

    if pack_variants:
        vals = union  # 4-bit IUPAC set codes; 0 = gap (SET_TO_ASCII[0]='-')
        gap = jnp.uint8(0)
    else:
        from ..encoding import SET_TO_ASCII

        vals = jnp.asarray(SET_TO_ASCII)[union]
        gap = jnp.uint8(ord("-"))

    sel = pair_end & live
    pos = jnp.where(sel, rows * S + gsid, N * S)
    variants = (
        jnp.full(N * S + 1, gap, jnp.uint8)
        .at[pos]
        .set(jnp.where(sel, vals, gap))[: N * S]
        .reshape(N, S)
    )
    if pack_variants:
        if S % 2:
            variants = jnp.pad(variants, ((0, 0), (0, 1)))
        variants = (variants[:, 0::2] << jnp.uint8(4)) | variants[:, 1::2]

    krows = jnp.where(newrow, rows, N)
    ukeys = (
        jnp.zeros((N + 1, W), U64)
        .at[krows]
        .set(jnp.where(newrow[:, None], gk, U64(0)))[:N]
    )
    counts = (
        jnp.zeros(N + 1, jnp.int32)
        .at[jnp.where(sel, rows, N)]
        .add(sel.astype(jnp.int32))[:N]
    )
    return ukeys, variants, counts, n_rows


@partial(
    jax.jit,
    static_argnames=("k", "rc", "W", "is_reads", "use_mid_qual", "min_count"),
)
def merged_build_pipeline(
    seqs, valid, qual_ok, rec_last,
    k: int, rc: bool, W: int, is_reads: bool, use_mid_qual: bool,
    min_count: int,
):
    """Whole-batch build + merge, ASCII-byte inputs/outputs (see
    _merged_impl for the algorithm and the packed-transfer variant)."""
    return _merged_impl(
        seqs, valid, qual_ok, rec_last, k, rc, W, is_reads, use_mid_qual,
        min_count,
    )


def unpack_codes(seq2):
    """(S, ceil(L/4)) uint8 of 2-bit codes (4/byte, first base in bits
    7-6) -> (S, 4*ceil(L/4)) uint8 code array. Device-side inverse of
    sample._stage_packed's host packing."""
    S = seq2.shape[0]
    shifts = jnp.arange(3, -1, -1, dtype=jnp.uint8) * jnp.uint8(2)
    c = (seq2[:, :, None] >> shifts) & jnp.uint8(3)
    return c.reshape(S, -1)


def _unpack_bits(bits, L):
    """(S, ceil(L/8)) packed bools (np.packbits order) -> (S, L) bool."""
    S = bits.shape[0]
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    b = (bits[:, :, None] >> shifts) & jnp.uint8(1)
    return b.reshape(S, -1)[:, :L].astype(bool)


@partial(
    jax.jit,
    static_argnames=(
        "k", "rc", "W", "is_reads", "use_mid_qual", "min_count",
        "strict_valid", "has_qual",
    ),
)
def merged_build_from_packed(
    seq2, valid_bits, qual_bits, rec_ends,
    k: int, rc: bool, W: int, is_reads: bool, use_mid_qual: bool,
    min_count: int, strict_valid: bool, has_qual: bool,
):
    """merged_build_pipeline fed by PACKED link bytes, emitting PACKED
    variants: 2-bit base codes (4/byte) + 1 validity bit/base cross
    host->device (0.375 bytes/base vs 1 raw), and the variants matrix
    returns as two 4-bit IUPAC set codes per byte (half of ASCII).
    Fewer bytes cross the link and less host staging memory is touched,
    so this is the product build path; the raw-bytes entry points remain
    for tests and the virtual-mesh path.

    seq2 (S, Lp/4) uint8; valid_bits (S, Lp/8) uint8 (host-computed
    base validity: not-N and not-padding, bit_encoding.rs:52-54);
    qual_bits as in device_masks; rec_ends (S, E) int32. Lp must be a
    multiple of 8 (the power-of-two staging buckets always are).

    Returns (ukeys, variants_packed4 (N, ceil(S/2)), counts, n_rows).
    """
    codes = unpack_codes(seq2)
    L = codes.shape[1]
    base_ok = _unpack_bits(valid_bits, L)
    if has_qual:
        qual_ok = _unpack_bits(qual_bits, L)
    else:
        qual_ok = jnp.ones_like(base_ok)
    valid = base_ok & qual_ok if strict_valid else base_ok
    S = seq2.shape[0]
    row = jnp.broadcast_to(
        jnp.arange(S, dtype=jnp.int32)[:, None], rec_ends.shape
    )
    rec_last = (
        jnp.zeros((S, L + 1), bool)
        .at[row, jnp.minimum(rec_ends, L)]
        .set(True)[:, :L]
    )
    return _merged_impl(
        codes, valid, qual_ok, rec_last, k, rc, W, is_reads, use_mid_qual,
        min_count, from_codes=True, pack_variants=True,
    )


def unpack_variants4(vp: np.ndarray, n_cols: int) -> np.ndarray:
    """Host-side inverse of the pack_variants transfer layout:
    (n, ceil(S/2)) two-4-bit-codes-per-byte -> (n, n_cols) ASCII."""
    from ..encoding import SET_TO_ASCII

    n = vp.shape[0]
    v = np.empty((n, vp.shape[1] * 2), np.uint8)
    v[:, 0::2] = vp >> 4
    v[:, 1::2] = vp & 15
    return np.asarray(SET_TO_ASCII)[v[:, :n_cols]]


def device_masks(seqs, qual_bits, rec_ends, strict_valid: bool,
                 has_qual: bool):
    """Compute the validity/quality/record-end masks ON DEVICE from raw
    bytes, so the host ships 1 byte/base (FASTA) or 1.125 (FASTQ)
    instead of 4 — decisive through a ~25MB/s remote-attached link, and
    a 4x staging-memcpy cut on PCIe hosts.

    seqs (S, L) uint8 (0 = padding). qual_bits (S, ceil(L/8)) uint8:
    np.packbits of the HOST-thresholded per-base quality pass
    ((q-33) > min_qual, with the reference's `qual: None => true`
    0xFF rule, split_kmer.rs:66-71) — quality is only ever consumed as
    this bool, so 1 bit/base crosses the link instead of the raw PHRED
    byte; (S, 1) dummy when has_qual=False. rec_ends (S, E) int32
    record-final positions (>= L = padding).
    Returns (valid, qual_ok, rec_last) (S, L) bool.
    """
    S, L = seqs.shape
    base_ok = ((seqs & jnp.uint8(0xF)) != 14) & (seqs != 0)
    if has_qual:
        # unpack big-endian bit order (np.packbits default)
        shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
        bits = (qual_bits[:, :, None] >> shifts) & jnp.uint8(1)
        qual_ok = bits.reshape(S, -1)[:, :L].astype(bool)
    else:
        qual_ok = jnp.ones_like(base_ok)
    valid = base_ok & qual_ok if strict_valid else base_ok
    row = jnp.broadcast_to(
        jnp.arange(S, dtype=jnp.int32)[:, None], rec_ends.shape
    )
    rec_last = (
        jnp.zeros((S, L + 1), bool)
        .at[row, jnp.minimum(rec_ends, L)]
        .set(True)[:, :L]
    )
    return valid, qual_ok, rec_last


@partial(
    jax.jit,
    static_argnames=(
        "k", "rc", "W", "is_reads", "use_mid_qual", "min_count",
        "strict_valid", "has_qual",
    ),
)
def merged_build_from_raw(
    seqs, qual_bits, rec_ends,
    k: int, rc: bool, W: int, is_reads: bool, use_mid_qual: bool,
    min_count: int, strict_valid: bool, has_qual: bool,
):
    """merged_build_pipeline fed by raw bytes: masks are derived on
    device (device_masks) inside the same dispatch."""
    valid, qual_ok, rec_last = device_masks(
        seqs, qual_bits, rec_ends, strict_valid, has_qual
    )
    return merged_build_pipeline.__wrapped__(
        seqs, valid, qual_ok, rec_last, k, rc, W, is_reads, use_mid_qual,
        min_count,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "rc", "W", "is_reads", "use_mid_qual", "min_count",
        "strict_valid", "has_qual",
    ),
)
def sample_from_raw(
    seq, qual_bits, rec_ends,
    k: int, rc: bool, W: int, is_reads: bool, use_mid_qual: bool,
    min_count: int, strict_valid: bool, has_qual: bool,
):
    """sample_pipeline fed by raw bytes (device_masks in-dispatch)."""
    valid, qual_ok, rec_last = device_masks(
        seq[None], qual_bits[None], rec_ends[None], strict_valid,
        has_qual,
    )
    return sample_pipeline.__wrapped__(
        seq, valid[0], qual_ok[0], rec_last[0],
        k, rc, W, is_reads, use_mid_qual, min_count,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "rc", "W", "is_reads", "use_mid_qual", "min_count",
        "strict_valid", "has_qual",
    ),
)
def batched_from_raw(
    seqs, qual_bits, rec_ends,
    k: int, rc: bool, W: int, is_reads: bool, use_mid_qual: bool,
    min_count: int, strict_valid: bool, has_qual: bool,
):
    """batched_pipeline fed by raw bytes (device_masks in-dispatch)."""
    valid, qual_ok, rec_last = device_masks(
        seqs, qual_bits, rec_ends, strict_valid, has_qual
    )
    return batched_pipeline.__wrapped__(
        seqs, valid, qual_ok, rec_last,
        k, rc, W, is_reads, use_mid_qual, min_count,
    )


@partial(
    jax.jit,
    static_argnames=("k", "rc", "W", "use_mid_qual",
                     "strict_valid", "has_qual"),
)
def chunk_count_from_raw(
    seq, qual_bits, rec_ends,
    k: int, rc: bool, W: int, use_mid_qual: bool,
    strict_valid: bool, has_qual: bool,
):
    """chunk_count_pipeline fed by raw bytes (device_masks in-dispatch)."""
    valid, qual_ok, rec_last = device_masks(
        seq[None], qual_bits[None], rec_ends[None], strict_valid,
        has_qual,
    )
    return chunk_count_pipeline.__wrapped__(
        seq, valid[0], qual_ok[0], rec_last[0], k, rc, W, use_mid_qual
    )


def unpack_host(sp_np, union_np, end_np, W):
    """Host-side compaction of the pipeline output into (keys (n, W), sets)."""
    sp_np = np.asarray(sp_np)
    nonsent = (sp_np != _SENT).any(axis=-1)
    sel = np.asarray(end_np) & nonsent
    rows = sp_np[sel]
    sets = np.asarray(union_np)[sel]
    if W == 1:
        keys = rows >> np.uint64(4)
    else:
        hi, lo = rows[:, 0], rows[:, 1]
        keys = np.stack(
            [hi >> np.uint64(4), (lo >> np.uint64(4)) | (hi << np.uint64(60))], axis=-1
        )
    return keys.reshape(-1, W).astype(np.uint64), sets.astype(np.uint8)


@partial(jax.jit, static_argnames=("k", "rc", "W", "use_mid_qual"))
def chunk_count_pipeline(seq, valid, qual_ok, rec_last, k, rc, W, use_mid_qual):
    """Per-chunk stage of the chunked FASTQ count-filtered build.

    Every occurrence of a given canonical whole k-mer yields the SAME
    split (key, middle-base-set) pair — the split canonicalization,
    middle base and palindrome W/S bits are all functions of the whole
    k-mer. The min-count rank rule (bloom_filter.rs:116-148: contribute
    iff the occurrence count reaches min_count) therefore reduces to a
    pure per-whole-k-mer count threshold, which distributes over chunks
    by summing per-chunk counts.

    Returns (sorted whole keys (L, W), is_start bool[L], counts int32[L]
    valid at segment starts, packed split (key<<4|set) at segment starts
    (L, W), n_unique).
    """
    L = seq.shape[0]
    h = (k - 1) // 2
    res = X.extract_windows(seq, valid, rec_last, k, rc, W, True)
    emit = res["emit"]
    if use_mid_qual:
        mid_ok = jnp.concatenate([qual_ok[h:], jnp.zeros(h, bool)])
        emit = emit & mid_ok

    mid = res["mid"]
    sets = (
        jnp.left_shift(jnp.uint8(1), mid)
        | jnp.where(res["pal"], jnp.left_shift(jnp.uint8(1), mid ^ 2), 0)
    ).astype(jnp.uint8)
    packed = _pack_key_set(res["key"], sets, W)
    wkeys = jnp.where(
        emit[:, None], res["whole"], jnp.full_like(res["whole"], _SENT)
    )
    packed = jnp.where(emit[:, None], packed, jnp.full_like(packed, _SENT))

    # unstable is sound: the packed split pair is a pure function of the
    # whole k-mer, so payloads of equal keys are identical by construction
    ops = tuple(wkeys[:, i] for i in range(W)) + tuple(
        packed[:, i] for i in range(W)
    )
    sres = K.lax_sort_fast(ops, num_keys=W, is_stable=False)
    swk = jnp.stack(sres[:W], axis=-1)
    spacked = jnp.stack(sres[W : 2 * W], axis=-1)

    first = jnp.concatenate(
        [jnp.ones(1, bool), jnp.any(swk[1:] != swk[:-1], axis=-1)]
    )
    idx = jnp.arange(L, dtype=jnp.int32)
    # per-segment length, stored at the segment START via the end trick:
    # length = end_idx - start_idx + 1; propagate from end backwards is
    # awkward, so compute at ends then align: counts[start] of segment i
    # = (next start) - start
    next_start = jnp.concatenate(
        [jnp.where(first[1:], idx[1:], L + 1), jnp.full(1, L, jnp.int32)]
    )
    # cumulative-min from the right gives each row its segment's end+1
    rev_cummin = jnp.flip(jax.lax.cummin(jnp.flip(next_start)))
    counts = jnp.where(first, rev_cummin - idx, 0)
    live = jnp.any(swk != U64(_SENT), axis=-1)
    n_unique = jnp.sum((first & live).astype(jnp.int32))
    return swk, first & live, counts, spacked, n_unique


def unpack_chunk_counts(swk, is_start, counts, spacked, W):
    """Host-side compaction of chunk_count_pipeline outputs."""
    sel = np.asarray(is_start)
    return (
        np.asarray(swk)[sel],
        np.asarray(counts)[sel].astype(np.int64),
        np.asarray(spacked)[sel],
    )


@partial(jax.jit, static_argnames=("k", "rc", "W"))
def chunk_key_counts_from_raw(seq, rec_ends, k, rc, W):
    """chunk_key_counts fed by raw sequence bytes (`ska cov` ignores
    quality, coverage.rs:102): validity and record ends derive on device,
    so only 1 byte/base crosses the link."""
    valid, _, rec_last = device_masks(
        seq[None], jnp.zeros((1, 1), jnp.uint8), rec_ends[None], False,
        False,
    )
    return chunk_key_counts.__wrapped__(seq, valid[0], rec_last[0], k, rc, W)


@partial(jax.jit, static_argnames=("k", "rc", "W"))
def chunk_key_counts(seq, valid, rec_last, k, rc, W):
    """Per-chunk split-key occurrence counts for chunked `ska cov`
    (coverage.rs:104-135 counts split k-mer keys, qualities ignored).
    Returns (sorted keys (L, W), is_start, counts at starts)."""
    L = seq.shape[0]
    res = X.extract_windows(seq, valid, rec_last, k, rc, W)
    emit = res["emit"]
    keys = jnp.where(
        emit[:, None], res["key"], jnp.full_like(res["key"], _SENT)
    )
    skeys, _, _ = K.sort_with(keys, ())
    first = jnp.concatenate(
        [jnp.ones(1, bool), jnp.any(skeys[1:] != skeys[:-1], axis=-1)]
    )
    idx = jnp.arange(L, dtype=jnp.int32)
    next_start = jnp.concatenate(
        [jnp.where(first[1:], idx[1:], L + 1), jnp.full(1, L, jnp.int32)]
    )
    rev_cummin = jnp.flip(jax.lax.cummin(jnp.flip(next_start)))
    counts = jnp.where(first, rev_cummin - idx, 0)
    live = jnp.any(skeys != U64(_SENT), axis=-1)
    return skeys, first & live, counts
