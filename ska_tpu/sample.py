"""Per-sample split k-mer dictionary build.

Equivalent of reference SkaDict (src/ska_dict.rs:333-378): one sample's
FASTA/FASTQ input becomes a sorted packed-key array plus a 4-bit
middle-base-set column, produced on device by
extract -> (count filter for reads) -> sort -> segmented union.
"""

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .constants import QUAL_MIDDLE, QUAL_STRICT, check_k
from .io import fastx
from .sampletypes import QualOpts, SampleDict  # noqa: F401 - canonical home
# numpy-only key helpers: importing this module must stay jax-free so the
# host-native build route (csrc/host_build.cpp via _native_host_build)
# never pays the ~2 s accelerator-runtime import; the device pipelines
# import ska_tpu.ops.pipeline (and jnp) lazily inside each function
from .ops import npkeys as K



def _bucket(n: int) -> int:
    """Pad lengths to power-of-two buckets to bound jit recompilation."""
    b = 1024
    while b < n:
        b *= 2
    return b


def _bucket_min(n: int, lo: int) -> int:
    """Power-of-two bucket with a custom floor (record-end arrays are
    tiny for FASTA, read-count sized for FASTQ)."""
    b = lo
    while b < n:
        b *= 2
    return b


def _subsample_reads(ff: fastx.FastxFile, proportion_reads):
    """Keep every step-th record, step = round(1/proportion); the counter
    restarts per file, as the reference resets iter_reads per file
    (src/ska_dict.rs:125-141)."""
    if proportion_reads is None:
        return ff
    # Rust f64::round = half away from zero (ska_dict.rs:128)
    step = int(np.floor(1.0 / proportion_reads + 0.5))
    if step <= 1:
        return ff
    out = fastx.FastxFile(is_fastq=ff.is_fastq)
    for i in range(len(ff.seqs)):
        if i % step == 0:
            out.ids.append(ff.ids[i])
            out.seqs.append(ff.seqs[i])
            out.quals.append(ff.quals[i])
    return out


def _masks(batch: fastx.SeqBatch, qual: QualOpts, is_reads: bool):
    """Base validity and middle-quality masks (host precompute)."""
    seq = batch.seq
    base_ok = ((seq & 0xF) != 14) & (seq != 0)
    if batch.has_qual:
        # 0xFF marks a record with no quality scores in a mixed batch
        # (fastx.build_batch): always passes, like the reference's
        # `qual: None => true` (split_kmer.rs:66-71)
        qual_ok = ((batch.qual.astype(np.int16) - 33) > qual.min_qual) | (
            batch.qual == 0xFF
        )
    else:
        qual_ok = np.ones(len(seq), dtype=bool)
    if is_reads and batch.has_qual and qual.qual_filter == QUAL_STRICT:
        valid = base_ok & qual_ok
    else:
        valid = base_ok
    return valid, qual_ok


def prepare_sample(
    files: Tuple[str, Optional[str]],
    proportion_reads: Optional[float] = None,
) -> Tuple[fastx.SeqBatch, bool]:
    """Host parse: FASTA/FASTQ files -> flat SeqBatch + is_reads flag.

    Mirrors SkaDict::new (ska_dict.rs:333-378): format detected by peeking
    the first record of the first file; both files share the format flag.
    """
    is_reads = fastx.peek_format(files[0]) == "fastq"
    parts = [fastx.read_fastx(files[0])]
    if files[1] is not None:
        parts.append(fastx.read_fastx(files[1]))

    seqs: List[bytes] = []
    quals: List[Optional[bytes]] = []
    for ff in parts:
        ff = _subsample_reads(ff, proportion_reads)
        seqs.extend(ff.seqs)
        quals.extend(ff.quals)
    return fastx.build_batch(seqs, quals), is_reads


def build_sample(
    name: str,
    k: int,
    files: Tuple[str, Optional[str]],
    rc: bool,
    qual: QualOpts,
    proportion_reads: Optional[float] = None,
) -> SampleDict:
    """Build one sample's dictionary from FASTA or paired FASTQ input."""
    check_k(k)
    batch, is_reads = prepare_sample(files, proportion_reads)
    keys_np, sets_np = dict_from_batch(batch, k, rc, qual, is_reads)
    if len(keys_np) == 0:
        raise ValueError(f"{files[0]} has no valid sequence")
    return SampleDict(name=name, k=k, rc=rc, keys=keys_np, sets=sets_np)


def build_samples(
    input_files,
    k: int,
    rc: bool,
    qual: QualOpts,
    proportion_reads: Optional[float] = None,
    max_batch: int = 8,
) -> List[SampleDict]:
    """Build many samples, batching same-shape pipelines into single
    device dispatches (2-D row-wise pipelines over the samples axis;
    see ops.pipeline.batched_pipeline on why this is not a vmap).

    Replaces the reference's rayon sample parallelism
    (merge_ska_dict.rs:354-417) with device batching; host parsing runs
    on a thread pool.
    """
    import concurrent.futures as cf

    check_k(k)
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        prepared = list(
            pool.map(
                lambda t: prepare_sample((t[1], t[2]), proportion_reads), input_files
            )
        )

    # group by (padded length, config) for batched dispatch
    groups = {}
    for i, (batch, is_reads) in enumerate(prepared):
        Lp = _bucket(len(batch.seq) + k + 1)
        use_mq = bool(
            is_reads
            and batch.has_qual
            and qual.qual_filter in (QUAL_MIDDLE, QUAL_STRICT)
        )
        key = (Lp, is_reads, use_mq, bool(batch.has_qual))
        groups.setdefault(key, []).append(i)

    results: List[Optional[SampleDict]] = [None] * len(prepared)
    for (Lp, is_reads, use_mq, _hq), idxs in groups.items():
        for c0 in range(0, len(idxs), max_batch):
            chunk = idxs[c0 : c0 + max_batch]
            keys_list = _run_batch(
                [prepared[i][0] for i in chunk], Lp, k, rc, qual, is_reads, use_mq
            )
            for i, (keys_np, sets_np) in zip(chunk, keys_list):
                name = input_files[i][0]
                if len(keys_np) == 0:
                    raise ValueError(f"{input_files[i][1]} has no valid sequence")
                results[i] = SampleDict(
                    name=name, k=k, rc=rc, keys=keys_np, sets=sets_np
                )
    return results


def _auto_max_batch(Lp: int) -> int:
    """Samples per merged dispatch: scale inversely with the padded
    length under a ~128M-base budget (at most 32 samples; the knee on
    the GPU is not measured yet). SKA_MAX_BATCH overrides."""
    env = os.environ.get("SKA_MAX_BATCH")
    if env:
        return max(1, int(env))
    eff = max(1, min(32, (1 << 27) // max(Lp, 1)))
    # The dispatch pads the batch axis up to the next power of two, so a
    # non-power-of-two here would silently double the device work (e.g.
    # 17 samples padded to 32 rows). Round down to a power of two.
    eff = 1 << (eff.bit_length() - 1)
    # The merged pipeline's variants scatter is an (S*Lp, S) buffer —
    # an S^2 * Lp term the per-sample bench kernel (which tuned the
    # 32-sample knee) never pays. Cap it at 1 GB, which also keeps the
    # scatter's int32 index space (rows * S + sample < 2^31) safe:
    # 32 x 4 Mb genomes would otherwise demand a 4.3 GB buffer and
    # overflow the indices (measured: OverflowError at trace time).
    while eff > 1 and Lp * eff * eff > (1 << 30):
        eff //= 2
    return eff


def build_samples_merged(
    input_files,
    k: int,
    rc: bool,
    qual: QualOpts,
    proportion_reads: Optional[float] = None,
    max_batch: Optional[int] = None,
):
    """Build + merge many samples with device-side merging.

    Each same-shape batch runs ops.pipeline.merged_build_pipeline (one
    global sort by (key, sample) + scatters) and only the compact merged
    sub-array is transferred. Returns a list of (names, keys, variants,
    counts) batch results in input order of columns within each batch;
    api.build unions them and restores the global input column order.
    """
    import concurrent.futures as cf

    check_k(k)
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        prepared = list(
            pool.map(
                lambda t: prepare_sample((t[1], t[2]), proportion_reads), input_files
            )
        )

    native = _native_host_build(prepared, input_files, k, rc)
    if native is not None:
        return native  # jax-free: the native engine served the build

    from .ops import pipeline as P
    from .jaxinit import jnp

    cap = _max_chunk_bases()
    groups = {}
    big = []
    for i, (batch, is_reads) in enumerate(prepared):
        if len(batch.seq) + k + 1 > cap:
            big.append(i)  # oversized sample: chunked per-sample build
            continue
        Lp = _bucket(len(batch.seq) + k + 1)
        use_mq = bool(
            is_reads
            and batch.has_qual
            and qual.qual_filter in (QUAL_MIDDLE, QUAL_STRICT)
        )
        key = (Lp, is_reads, use_mq, bool(batch.has_qual))
        groups.setdefault(key, []).append(i)

    from .progress import Bar

    W = K.width_for_k(k)
    out = []
    bar = Bar(len(prepared), "samples")  # merge_ska_dict.rs:403 analog
    if big:
        from .encoding import SET_TO_ASCII

        for i in big:
            batch, is_reads = prepared[i]
            keys_np, sets_np = dict_from_batch_chunked(
                batch, k, rc, qual, is_reads, cap
            )
            if len(keys_np) == 0:
                raise ValueError(f"{input_files[i][1]} has no valid sequence")
            var = np.asarray(SET_TO_ASCII)[sets_np][:, None]
            counts_np = np.ones(len(keys_np), np.int64)
            out.append(([i], [input_files[i][0]], keys_np, var, counts_np))
            bar.update(1)
    for (Lp, is_reads, use_mq, has_qual), idxs in groups.items():
        eff_batch = max_batch or _auto_max_batch(Lp)
        for c0 in range(0, len(idxs), eff_batch):
            chunk = idxs[c0 : c0 + eff_batch]
            # pad the batch axis to a power of two: jit shapes must not
            # depend on the dataset (each new shape is a fresh compile);
            # pad rows are all-zero bytes and produce no k-mers
            S = 1
            while S < len(chunk):
                S *= 2
            # ship PACKED bytes only — 2-bit base codes (4/byte) plus 1
            # validity bit/base (0.375 bytes/base; FASTQ adds 1 packed
            # quality-pass bit/base), masks and codes unpack on device
            # (ops.pipeline.merged_build_from_packed): fewer bytes over
            # PCIe and a smaller host staging copy.
            seq2_b, valid_b, qual_bits, rec_ends, _hq2 = _stage_packed(
                [prepared[i][0] for i in chunk], Lp, int(qual.min_qual)
            )
            seq2 = np.zeros((S, seq2_b.shape[1]), np.uint8)
            seq2[: len(chunk)] = seq2_b
            vb = np.zeros((S, valid_b.shape[1]), np.uint8)
            vb[: len(chunk)] = valid_b
            qb = np.zeros((S, qual_bits.shape[1]), np.uint8)
            qb[: len(chunk)] = qual_bits
            re_ = np.full((S, rec_ends.shape[1]), Lp, np.int32)
            re_[: len(chunk)] = rec_ends
            strict_valid = bool(
                is_reads and has_qual and qual.qual_filter == QUAL_STRICT
            )
            ukeys, variants4, counts, n_rows = P.merged_build_from_packed(
                jnp.asarray(seq2),
                jnp.asarray(vb),
                jnp.asarray(qb),
                jnp.asarray(re_),
                k, rc, W, is_reads, use_mq, int(qual.min_count),
                strict_valid, has_qual,
            )
            n = int(np.asarray(n_rows))
            names = [input_files[i][0] for i in chunk]
            keys_np = np.asarray(ukeys[:n])
            # 4-bit packed transfer -> ASCII, dropping batch pad columns
            var_np = P.unpack_variants4(np.asarray(variants4[:n]), len(chunk))
            # recount on host (one vectorized pass) instead of pulling the
            # device counts column across the link
            counts_np = (var_np != ord("-")).sum(axis=1).astype(np.int64)
            del counts
            _check_all_present(var_np, n, [input_files[i][1] for i in chunk])
            out.append((chunk, names, keys_np, var_np, counts_np))
            bar.update(len(chunk))
    bar.finish()
    return out


def _check_all_present(var_np, n_rows, paths):
    """A sample with zero k-mers panics in the reference
    (ska_dict.rs:374-376): column col of the variants matrix must carry
    at least one non-gap base; paths[col] names the offending input."""
    present = (
        (var_np != ord("-")).any(axis=0)
        if n_rows
        else np.zeros(len(paths), bool)
    )
    for col, path in enumerate(paths):
        if not present[col]:
            raise ValueError(f"{path} has no valid sequence")


def _stage_raw(batches, Lp, min_qual=0):
    """Host staging for the raw-bytes device path: seq bytes, PACKED
    per-base quality-pass bits (quality is only ever consumed as the
    thresholded bool, so 1 bit/base crosses the link instead of the raw
    PHRED byte) and record-end indices — masks derive on device
    (ops.pipeline.device_masks)."""
    S = len(batches)
    has_qual = all(bool(b.has_qual) for b in batches)
    seqs = np.zeros((S, Lp), np.uint8)
    qual_bits = np.zeros((S, (Lp + 7) // 8 if has_qual else 1), np.uint8)
    Eb = _bucket_min(max(int(b.rec_last.sum()) for b in batches), 16)
    rec_ends = np.full((S, Eb), Lp, np.int32)
    for i, b in enumerate(batches):
        L = len(b.seq)
        seqs[i, :L] = b.seq
        if has_qual:
            # host threshold incl. the reference's `qual: None => true`
            # 0xFF rule (split_kmer.rs:66-71); padding packs to 0
            ok = np.zeros(Lp, bool)
            ok[:L] = ((b.qual.astype(np.int16) - 33) > min_qual) | (
                b.qual == 0xFF
            )
            qual_bits[i] = np.packbits(ok)
        ends = np.flatnonzero(b.rec_last).astype(np.int32)
        rec_ends[i, : len(ends)] = ends
    return seqs, qual_bits, rec_ends, has_qual


def _stage_packed(batches, Lp, min_qual=0):
    """Host staging for the packed-transfer device path: 2-bit base
    codes (4 per byte, first base in bits 7-6), packed per-base validity
    bits (not-N and not-padding, the reference's valid_base rule
    bit_encoding.rs:52-54 — other IUPAC letters 2-bit-project, quirk
    preserved), packed quality-pass bits, and record-end indices.
    0.375 bytes/base crosses the link for FASTA (vs 1 raw byte), 0.5
    for FASTQ. Lp must be a multiple of 8 (pow2 buckets are).
    """
    S = len(batches)
    has_qual = all(bool(b.has_qual) for b in batches)
    seq2 = np.zeros((S, Lp // 4), np.uint8)
    valid_bits = np.zeros((S, Lp // 8), np.uint8)
    qual_bits = np.zeros((S, Lp // 8 if has_qual else 1), np.uint8)
    Eb = _bucket_min(max(int(b.rec_last.sum()) for b in batches), 16)
    rec_ends = np.full((S, Eb), Lp, np.int32)
    for i, b in enumerate(batches):
        L = len(b.seq)
        seq = np.zeros(Lp, np.uint8)
        seq[:L] = b.seq
        codes = (seq >> 1) & 3
        seq2[i] = (
            (codes[0::4] << 6) | (codes[1::4] << 4)
            | (codes[2::4] << 2) | codes[3::4]
        )
        valid_bits[i] = np.packbits(((seq & 0xF) != 14) & (seq != 0))
        if has_qual:
            ok = np.zeros(Lp, bool)
            ok[:L] = ((b.qual.astype(np.int16) - 33) > min_qual) | (
                b.qual == 0xFF
            )
            qual_bits[i] = np.packbits(ok)
        ends = np.flatnonzero(b.rec_last).astype(np.int32)
        rec_ends[i, : len(ends)] = ends
    return seq2, valid_bits, qual_bits, rec_ends, has_qual


def _native_host_build(prepared, input_files, k, rc):
    """Host-mode native build dispatch (csrc/host_build.cpp).

    The product path is the device pipeline; this gives the host-only
    fallback the reference's own data-structure class (rolling extract +
    flat hashmaps) instead of running comparator-network sorts on a
    CPU, where they lose to hashing. Gated to
    FASTA cohorts and to explicit host operation (SKA_PLATFORM=cpu) or
    SKA_NATIVE_BUILD=1, so the JAX pipelines keep their full CPU-backend
    test coverage (tests pin the cpu platform via jax.config, not the
    env var). Output is byte-identical to the device path (asserted by
    tests/test_native_build.py). Returns the build_samples_merged batch
    list, or None when ineligible.
    """
    from .constants import host_native_enabled

    if not host_native_enabled():
        return None
    if any(is_reads for (_b, is_reads) in prepared):
        return None  # FASTQ paths (quality/count filters) stay as-is
    try:
        from .io.native import host_build
    except Exception:  # noqa: BLE001 - no toolchain: JAX path works fine
        return None

    keys_np, var_np, counts_np = host_build(
        [b.seq for (b, _ir) in prepared], k, rc
    )
    _check_all_present(var_np, len(keys_np), [t[1] for t in input_files])
    names = [t[0] for t in input_files]
    # the reference's serial build ticks a per-sample progress bar
    # (merge_ska_dict.rs:403); the native engine is one call, so show a
    # completed bar rather than none
    from .progress import Bar

    bar = Bar(len(prepared), "samples")
    bar.update(len(prepared))
    bar.finish()
    return [(list(range(len(prepared))), names, keys_np, var_np, counts_np)]


def _run_batch(batches, Lp, k, rc, qual, is_reads, use_mq):
    from .ops import pipeline as P
    from .jaxinit import jnp

    W = K.width_for_k(k)
    S = len(batches)
    seqs, qual_bits, rec_ends, has_qual = _stage_raw(
        batches, Lp, int(qual.min_qual)
    )
    strict_valid = bool(
        is_reads and has_qual and qual.qual_filter == QUAL_STRICT
    )

    if S == 1:
        sp, union, is_end, n = P.sample_from_raw(
            jnp.asarray(seqs[0]),
            jnp.asarray(qual_bits[0]),
            jnp.asarray(rec_ends[0]),
            k, rc, W, is_reads, use_mq, int(qual.min_count),
            strict_valid, has_qual,
        )
        return [P.unpack_host(sp, union, is_end, W)]

    sp, union, is_end, n = P.batched_from_raw(
        jnp.asarray(seqs),
        jnp.asarray(qual_bits),
        jnp.asarray(rec_ends),
        k, rc, W, is_reads, use_mq, int(qual.min_count),
        strict_valid, has_qual,
    )
    sp_np, union_np, end_np = np.asarray(sp), np.asarray(union), np.asarray(is_end)
    return [
        P.unpack_host(sp_np[i], union_np[i], end_np[i], W) for i in range(S)
    ]


def _max_chunk_bases() -> int:
    """Device dispatch cap in bases; inputs beyond it build chunked
    (bounded HBM, like the reference's streaming reads)."""
    import os

    # default just under a pow2 so the padded chunk bucket stays 2^26
    return int(os.environ.get("SKA_MAX_CHUNK_BASES", str((1 << 26) - 128)))


def dict_from_batch(
    batch: fastx.SeqBatch, k: int, rc: bool, qual: QualOpts, is_reads: bool
):
    """Device pipeline: one fused jit dispatch (ops/pipeline.py), host unpack."""
    from .ops import pipeline as P
    from .jaxinit import jnp

    W = K.width_for_k(k)
    L = len(batch.seq)
    cap = _max_chunk_bases()
    if L + k + 1 > cap:
        return dict_from_batch_chunked(batch, k, rc, qual, is_reads, cap)
    Lp = _bucket(L + k + 1)

    seqs, qual_bits, rec_ends, has_qual = _stage_raw(
        [batch], Lp, int(qual.min_qual)
    )
    use_mid_qual = bool(
        is_reads and has_qual and qual.qual_filter in (QUAL_MIDDLE, QUAL_STRICT)
    )
    strict_valid = bool(
        is_reads and has_qual and qual.qual_filter == QUAL_STRICT
    )
    sp, union, is_end, n = P.sample_from_raw(
        jnp.asarray(seqs[0]),
        jnp.asarray(qual_bits[0]),
        jnp.asarray(rec_ends[0]),
        k, rc, W, is_reads, use_mid_qual, int(qual.min_count),
        strict_valid, has_qual,
    )
    keys_np, sets_np = P.unpack_host(sp, union, is_end, W)
    assert len(keys_np) == int(n)
    return keys_np, sets_np


def build_samples_distributed(
    input_files,
    k: int,
    rc: bool,
    qual: QualOpts,
    proportion_reads: Optional[float] = None,
    mesh=None,
):
    """Mesh-sharded build+merge over all visible devices.

    Same result contract as build_samples_merged (list of
    (chunk, names, keys, variants, counts) batch tuples for api.build),
    but samples are sharded over a jax.sharding.Mesh and the dictionary
    merge runs as a key-range-repartitioned sample sort on device
    (ska_tpu.parallel.distributed_build_multi). Samples are grouped by
    (padded-length bucket, is_reads, use_mid_qual) for the LOCAL pipeline
    dispatches only; every group's triples stay device-resident and merge
    in ONE key-range exchange, so a mixed-length cohort produces a single
    batch tuple and api.build never touches the full union on the host
    (the reference's one global merge, merge_ska_dict.rs:354-417).
    Only oversized samples (> SKA_MAX_CHUNK_BASES) fall back to serial
    chunked builds and a host union of their (tiny-count) extra tuples.
    """
    import concurrent.futures as cf

    from .parallel import build_mesh, distributed_build_multi

    check_k(k)
    if mesh is None:
        mesh = build_mesh()
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        prepared = list(
            pool.map(
                lambda t: prepare_sample((t[1], t[2]), proportion_reads), input_files
            )
        )

    cap = _max_chunk_bases()
    groups = {}
    big = []
    for i, (batch, is_reads) in enumerate(prepared):
        if len(batch.seq) + k + 1 > cap:
            big.append(i)  # oversized: chunked per-sample build
            continue
        use_mq = bool(
            is_reads
            and batch.has_qual
            and qual.qual_filter in (QUAL_MIDDLE, QUAL_STRICT)
        )
        # group by actual padded-length bucket (as the serial path does):
        # grouping only by config would pad every sample to the group max
        # and materialize the whole group on the host at once — one
        # near-cap sample among N small ones costs N x cap bytes
        Lp = _bucket(len(batch.seq) + k + 1)
        groups.setdefault(
            (Lp, is_reads, use_mq, bool(batch.has_qual)), []
        ).append(i)

    out = []
    if big:
        from .encoding import SET_TO_ASCII

        for i in big:
            batch, is_reads = prepared[i]
            keys_np, sets_np = dict_from_batch_chunked(
                batch, k, rc, qual, is_reads, cap
            )
            if len(keys_np) == 0:
                raise ValueError(f"{input_files[i][1]} has no valid sequence")
            var = np.asarray(SET_TO_ASCII)[sets_np][:, None]
            out.append(([i], [input_files[i][0]], keys_np, var,
                        np.ones(len(keys_np), np.int64)))
            prepared[i] = None  # consumed; free the raw batch
    # bound transient host staging memory per LOCAL dispatch (~1-2 bytes
    # per base: raw seq + qual bytes only, masks derive on device);
    # oversubscribed groups split into extra local dispatches — still
    # one global merge
    cap_bytes = int(os.environ.get("SKA_MAX_HOST_BATCH_BYTES", 4 << 30))
    calls = []
    call_idxs = []  # original input index per cohort column
    for (Lp, is_reads, use_mq, has_qual), gidxs in groups.items():
        per = max(1, cap_bytes // (Lp * (2 if has_qual else 1)))
        for c0 in range(0, len(gidxs), per):
            idxs = gidxs[c0 : c0 + per]
            S = len(idxs)
            seqs, qual_bits, rec_ends, _hq2 = _stage_raw(
                [prepared[i][0] for i in idxs], Lp, int(qual.min_qual)
            )
            for i in idxs:
                prepared[i] = None  # staged; free the raw batch
            calls.append(dict(
                seqs=seqs, quals=qual_bits, rec_ends=rec_ends,
                sids=np.arange(
                    len(call_idxs), len(call_idxs) + S, dtype=np.int32
                ),
                is_reads=is_reads, use_mq=use_mq,
                strict_valid=bool(
                    is_reads and has_qual
                    and qual.qual_filter == QUAL_STRICT
                ),
                has_qual=has_qual,
            ))
            call_idxs.extend(idxs)
    if calls:
        keys_np, var_np, counts_np, n_rows = distributed_build_multi(
            calls, k, rc, mesh, min_count=int(qual.min_count)
        )
        names = [input_files[i][0] for i in call_idxs]
        _check_all_present(
            var_np, n_rows, [input_files[i][1] for i in call_idxs]
        )
        out.append((call_idxs, names, keys_np, var_np, counts_np))
    return out


def _chunk_views(batch: fastx.SeqBatch, k: int, cap: int, valid=None):
    """Yield (a, b, end) slice windows of the flat batch with k-1 base
    overlap: chunk i covers window starts [a_i, a_{i+1}) exactly (its
    slice is [a_i, a_{i+1}+k-1), so the in-range check emits no start
    twice and drops none).

    A boundary may not land where the next chunk's FIRST window is a
    record-final window whose previous base is valid: that window's
    emission rule (split_kmer.rs roll-only last window) consults
    valid[a-1], which the next slice cannot see — nudge the boundary
    forward past such spots (drift is bounded by the record length;
    separators break the valid[b-1] condition)."""
    L = len(batch.seq)
    rl = batch.rec_last
    step = max(cap - (k - 1), 1)
    a = 0
    while a < L:
        b = min(a + step, L)
        if valid is not None:
            while (
                b < L
                and b + k - 1 < L
                and rl[b + k - 1]
                and b > 0
                and valid[b - 1]
            ):
                b += 1
        end = min(b + k - 1, L)
        yield a, b, end
        a = b


def dict_from_batch_chunked(
    batch: fastx.SeqBatch, k: int, rc: bool, qual: QualOpts, is_reads: bool,
    cap: int,
):
    """Chunked per-sample build for inputs larger than one device
    dispatch (the reference streams reads with bounded memory,
    ska_dict.rs:118-180; here bounded = `cap` bases per dispatch).

    Without a count filter, chunks produce per-chunk sorted unique
    (split key, set) pairs which merge by a host sort + segmented OR.
    With min_count > 1, chunks produce per-whole-k-mer counts plus the
    (identical per whole k-mer) split pair; counts sum across chunks
    and the threshold applies globally (see
    ops.pipeline.chunk_count_pipeline).
    """
    from .ops import pipeline as P
    from .jaxinit import jnp

    W = K.width_for_k(k)
    valid_full, qual_full = _masks(batch, qual, is_reads)
    use_mq = bool(
        is_reads and batch.has_qual and qual.qual_filter in (QUAL_MIDDLE, QUAL_STRICT)
    )
    want_count = bool(is_reads and qual.min_count > 1)
    Lp = _bucket(cap + k + 1)

    has_qual = bool(batch.has_qual)
    strict_valid = bool(
        is_reads and has_qual and qual.qual_filter == QUAL_STRICT
    )
    kparts, sparts = [], []
    wparts, cparts, pparts = [], [], []
    for a, b, end in _chunk_views(batch, k, cap, valid_full):
        n = end - a
        # raw-bytes staging: masks derive on device (device_masks); the
        # host-side valid_full above is only the chunk-boundary oracle
        seq = np.zeros(Lp, np.uint8)
        seq[:n] = batch.seq[a:end]
        qch = np.zeros((Lp + 7) // 8 if has_qual else 1, np.uint8)
        if has_qual:
            ok = np.zeros(Lp, bool)
            ok[:n] = qual_full[a:end]
            qch = np.packbits(ok)
        ends = np.flatnonzero(batch.rec_last[a:end]).astype(np.int32)
        rec_ends = np.full(_bucket_min(len(ends), 16), Lp, np.int32)
        rec_ends[: len(ends)] = ends
        if want_count:
            swk, is_start, counts, spacked, nu = P.chunk_count_from_raw(
                jnp.asarray(seq), jnp.asarray(qch), jnp.asarray(rec_ends),
                k, rc, W, use_mq,
                strict_valid, has_qual,
            )
            wk, cnt, pk = P.unpack_chunk_counts(swk, is_start, counts, spacked, W)
            wparts.append(wk)
            cparts.append(cnt)
            pparts.append(pk)
        else:
            sp, union, is_end, n_ = P.sample_from_raw(
                jnp.asarray(seq), jnp.asarray(qch), jnp.asarray(rec_ends),
                k, rc, W, is_reads, use_mq, 0,
                strict_valid, has_qual,
            )
            kk, ss = P.unpack_host(sp, union, is_end, W)
            kparts.append(kk)
            sparts.append(ss)

    if want_count:
        wk = np.concatenate(wparts)
        cnt = np.concatenate(cparts)
        pk = np.concatenate(pparts)
        order = K.np_lex_argsort(wk)
        wk, cnt, pk = wk[order], cnt[order], pk[order]
        first = np.ones(len(wk), bool)
        first[1:] = (wk[1:] != wk[:-1]).any(axis=-1)
        gid = np.cumsum(first) - 1
        totals = np.bincount(gid, weights=cnt).astype(np.int64)
        # contribute iff the total occurrence count reaches min_count
        # (identical split pair for every occurrence of a whole k-mer)
        keep = totals >= qual.min_count
        pk = pk[first][keep]
        keys = _shr_np(pk)
        sets = (pk[:, W - 1] & np.uint64(15)).astype(np.uint8)
    else:
        keys = np.concatenate(kparts) if kparts else np.zeros((0, W), np.uint64)
        sets = np.concatenate(sparts) if sparts else np.zeros(0, np.uint8)

    # merge across chunks / whole-kmer groups: sort by split key +
    # segmented union of the 4-bit sets
    if len(keys):
        order = K.np_lex_argsort(keys)
        keys, sets = keys[order], sets[order]
        first = np.ones(len(keys), bool)
        first[1:] = (keys[1:] != keys[:-1]).any(axis=-1)
        # segmented OR via reduceat (ufunc.at is unbuffered and ~100x
        # slower at genome scale)
        sets = np.bitwise_or.reduceat(sets, np.flatnonzero(first))
        keys = keys[first]
    return keys.astype(np.uint64), sets.astype(np.uint8)


def _shr_np(pk):
    """(n, W) uint64 >> 4 across limbs."""
    W = pk.shape[1]
    if W == 1:
        return pk >> np.uint64(4)
    hi, lo = pk[:, 0], pk[:, 1]
    return np.stack(
        [hi >> np.uint64(4), (lo >> np.uint64(4)) | (hi << np.uint64(60))], axis=-1
    )
