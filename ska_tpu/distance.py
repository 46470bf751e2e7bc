"""`ska distance`: pairwise SNP distances as one Gram matmul.

The reference walks every site per sample pair (merge_ska_array.rs:587-632,
rayon over columns :416-438). Per-site contributions depend only on the
*pair of 16 base-set classes* (gap, A, C, ..., N), so all pair statistics
are linear functionals of the class co-occurrence counts
G[i*16+a, j*16+b] = #sites(sample i class a, sample j class b) —
computed exactly as a one-hot Gram matrix product on the device.
"""

import os
from dataclasses import dataclass

import numpy as np

from .encoding import ASCII_TO_SET, BASE_PROB, SET_TO_ASCII

# jax is imported lazily (first accelerator-path Gram dispatch): the host
# path (SKA_PLATFORM=cpu) computes its weighted Gram with numpy BLAS and
# must never pay the ~2 s jax import — the reference's whole `ska
# distance` command is faster than that import (merge_ska_array.rs:416-438).

# Accelerator-path dedup ceiling: below this many (pre-dedup) sites the
# weighted f32 Gram's integer sums are exact (< 2^24), so deduplicated
# rows + Precision.HIGHEST is both exact and far cheaper to transfer.
# At or above it the undeduped int8 Gram takes over (exact at any
# scale). Module-level so tests can monkeypatch it to force either path.
DEDUP_MAX_SITES = 1 << 24

# One-hot scratch budget per Gram dispatch (bytes); both the serial
# chunking and the mesh path's per-device chunking derive their chunk
# row counts from it. Module-level so tests can shrink it to drive the
# multi-chunk loops with small data.
GRAM_SCRATCH_BYTES = 1 << 28


@dataclass
class VariantDist:
    distance: float
    mismatch_prop: float
    match_count: int
    mismatch_count: int

    def __str__(self):
        # reference Display: "{:.2}\t{:.5}\t{}\t{}" (merge_ska_array.rs:57-65)
        return (
            f"{self.distance:.2f}\t{self.mismatch_prop:.5f}"
            f"\t{self.match_count}\t{self.mismatch_count}"
        )


def _class_tables(filt_ambig: bool):
    """16x16 f64 coefficient tables for distance / match / mismatch."""
    probs = BASE_PROB[SET_TO_ASCII]  # (16, 4), class 0 = '-' (zero vector)
    overlap = probs @ probs.T  # (16, 16)
    nz = np.arange(16) > 0
    both = np.outer(nz, nz)
    one_gap = np.outer(~nz, nz) | np.outer(nz, ~nz)

    if filt_ambig:
        unamb = np.isin(np.arange(16), [1, 2, 4, 8])
        bu = np.outer(unamb, unamb)
        dist = (bu & (np.arange(16)[:, None] != np.arange(16)[None, :])).astype(np.float64)
        match = bu.astype(np.float64)
    else:
        dist = np.where(both, 1.0 - overlap, 0.0)
        match = (both & (overlap > 0.0)).astype(np.float64)
    mism = one_gap.astype(np.float64)
    return dist, match, mism


_jit_cache = {}


def _jitted(name):
    """Build (once) and return the jitted Gram kernels. Deferred so the
    host path never imports jax."""
    if name in _jit_cache:
        return _jit_cache[name]
    from functools import partial

    from .jaxinit import jax, jnp

    @partial(jax.jit, static_argnames=("n", "width"))
    def gram_chunk(classes_chunk, n: int, width: int = 16):
        C = classes_chunk.shape[0]
        onehot = jax.nn.one_hot(classes_chunk.astype(jnp.int32), width, dtype=jnp.int8)
        X = onehot.reshape(C, n * width)
        return jax.lax.dot_general(
            X, X, (((0,), (0,)), ((), ())), preferred_element_type=jnp.int32
        )

    @partial(jax.jit, static_argnames=("n", "width", "f64"))
    def gram_chunk_weighted(classes_chunk, weights, n: int, width: int, f64: bool):
        C = classes_chunk.shape[0]
        dt = jnp.float64 if f64 else jnp.float32
        onehot = jax.nn.one_hot(classes_chunk.astype(jnp.int32), width, dtype=dt)
        X = onehot.reshape(C, n * width)
        return jax.lax.dot_general(
            X * weights[:, None].astype(dt),
            X,
            (((0,), (0,)), ((), ())),
            preferred_element_type=dt,
            precision=jax.lax.Precision.HIGHEST,
        )

    _jit_cache["_gram_chunk"] = gram_chunk
    _jit_cache["_gram_chunk_weighted"] = gram_chunk_weighted
    return _jit_cache[name]


def _gram_chunk(classes_chunk, n: int, width: int = 16):
    """classes_chunk: (C, n) int8 in [0, width). Returns (n*width, n*width)
    int32 Gram, exact at any scale (int8 products, int32 accumulation).
    The accelerator path prefers the weighted kernel over deduplicated
    rows whenever its f32 sums stay exact — see class_gram."""
    return _jitted("_gram_chunk")(classes_chunk, n, width)


def _gram_chunk_weighted(classes_chunk, weights, n: int, width: int, f64: bool):
    """Weighted Gram over deduplicated rows: lhs scaled by per-row counts.

    f32 keeps integer sums exact up to 2^24; chunks whose weight total
    exceeds that use f64 (exact to 2^53; x64 is enabled package-wide).
    Precision.HIGHEST is required: at default precision a GPU may run an
    f32 matmul in TF32, whose 10-bit mantissa cannot hold the integer
    weights, and the counts come out wrong. HIGHEST keeps full f32
    products, so integer products and sums below 2^24 stay exact.
    """
    return _jitted("_gram_chunk_weighted")(classes_chunk, weights, n, width, f64)


def _np_gram_weighted(c: np.ndarray, w: np.ndarray, n: int, width: int,
                      f64: bool) -> np.ndarray:
    """Host-native weighted Gram: numpy one-hot + BLAS {s,d}gemm.

    Same exactness contract as the jitted kernel on the CPU backend
    (f32 sums are exact integers below 2^24, f64 below 2^53) without
    importing jax — the host `ska distance` path must stay jax-free, as
    the jax import alone costs more than the reference's whole command.
    No shape padding:
    there is no jit compile cache to keep warm on this path.
    """
    C = c.shape[0]
    dt = np.float64 if f64 else np.float32
    X = np.zeros((C, n * width), dtype=dt)
    cols = np.arange(n, dtype=np.int64) * width + c.astype(np.int64)
    X[np.arange(C)[:, None], cols] = 1.0
    return (X * w[:, None].astype(dt)).T @ X


def _dedupe_rows(compact: np.ndarray):
    """Exact unique-rows-with-counts over small-alphabet codes.

    Packs 16 4-bit codes per u64 word and lexsorts the ceil(n/16) words —
    orders of magnitude faster than np.unique over wide byte rows (42s ->
    ~2s at 1.15M x 128 measured), and byte-exact: no hashing involved.
    Returns (unique_rows, counts).
    """
    S, n = compact.shape
    if S == 0:
        return compact, np.zeros(0, np.int64)
    nw = -(-n // 16)
    packed = np.zeros((S, nw), np.uint64)
    for j in range(16):
        cols = np.arange(j, n, 16)
        if len(cols):
            packed[:, : len(cols)] |= compact[:, cols].astype(np.uint64) << np.uint64(4 * j)
    order = np.lexsort(tuple(packed[:, w] for w in range(nw - 1, -1, -1)))
    sp = packed[order]
    first = np.empty(S, bool)
    first[0] = True
    np.any(sp[1:] != sp[:-1], axis=1, out=first[1:])
    starts = np.flatnonzero(first)
    counts = np.diff(np.append(starts, S))
    return compact[order[starts]], counts


def compact_classes(variants: np.ndarray):
    """Shared class-compaction for the Gram kernels: map the 16 IUPAC
    classes to the ones actually present (typically 5-6), pick the
    one-hot width bucket, and choose the tail-pad class.

    Returns (compact (S, n) int8, present int8[K], K, width, pad_class).
    Both the serial path (class_gram) and the mesh path
    (parallel.postbuild.distributed_class_gram) call this, so their
    byte-equality contract cannot drift.
    """
    classes = ASCII_TO_SET[variants].astype(np.int8)
    # one linear pass (np.unique would sort all S*n elements)
    present = np.flatnonzero(
        np.bincount(classes.ravel().astype(np.int64), minlength=16)
    ).astype(np.int8)
    K = len(present)
    # pad width to a shape bucket; keep one slot > K free for tail padding
    # unless class 0 ('-', zero weight in every coefficient table) exists
    width = next(w for w in (4, 8, 16) if w >= K)
    if K == width and 0 not in present:
        width = 16 if width == 8 else 8
    lut = np.zeros(16, np.int8)
    lut[present] = np.arange(K, dtype=np.int8)
    compact = lut[classes].astype(np.int8)
    # tail padding: prefer a discarded slot (sliced off at scatter-back);
    # K == width only survives the bump when class 0 ('-', zero weight in
    # every coefficient table) is present to serve as the pad
    pad_class = K if K < width else int(lut[0])
    return compact, present, K, width, pad_class


def scatter_gram_16(Gc: np.ndarray, present: np.ndarray, K: int, width: int,
                    n: int) -> np.ndarray:
    """Scatter compact-class Gram counts back to 16-class coordinates."""
    G = np.zeros((n, 16, n, 16), dtype=np.int64)
    Gc4 = Gc.reshape(n, width, n, width)[:, :K, :, :K]
    pres = present.astype(np.int64)
    G[np.ix_(np.arange(n), pres, np.arange(n), pres)] = Gc4
    return G.reshape(n * 16, n * 16)


def class_gram(variants: np.ndarray, on_host=None) -> np.ndarray:
    """Exact int64 co-occurrence Gram over 16 classes. variants: (S, n) uint8.

    on_host: None = pick the kernel from the backend (dedup + weighted
    f32/f64 sgemm on CPU; dedup + weighted f32 on accelerators while the
    site count keeps f32 sums exact, undeduped int8 Gram past that);
    tests pass an explicit value to exercise both paths on one backend.

    The one-hot width is compacted to the classes actually present
    (typically 5-6 of 16: '-', A, C, G, T and the odd ambiguity code),
    which shrinks the Gram matmul quadratically — (K/16)^2 of the MACs —
    before scattering counts back to 16-class coordinates.

    Chunk sizes are fixed powers of two and tails are padded with a
    zero-weight class so jit shapes never depend on the dataset: a fresh
    XLA compile costs more than the padding, so shape stability matters
    more than minimal padding.
    """
    S, n = variants.shape
    if on_host is None:
        from .parallel import use_distributed

        if use_distributed():
            # site-sharded Gram + psum over the device mesh (goes beyond
            # the single-node reference; parallel/postbuild.py). Its
            # past-the-ceiling fallback calls back with on_host=False,
            # which skips this gate.
            from .parallel import build_mesh
            from .parallel.postbuild import distributed_class_gram

            return distributed_class_gram(variants, build_mesh())
    compact, present, K, width, pad_class = compact_classes(variants)
    if on_host is None:
        # env pin answers without importing jax (host CLI sets it);
        # otherwise ask the resolved backend
        if os.environ.get("SKA_PLATFORM") == "cpu":
            on_host = True
        else:
            from .jaxinit import jax

            on_host = jax.default_backend() == "cpu"
    # Related genomes repeat the same variant row constantly, and
    # distance runs after a NoConst filter so the site count is modest
    # anyway. Deduping on the host shrinks both the matmul rows and the
    # host->device transfer, so the accelerator path dedupes too whenever
    # the weighted kernel's f32 sums stay exact: partial sums are exact
    # integers below 2^24, so any dataset with < 16.7M sites qualifies.
    # Past that the undeduped int8 Gram (exact by construction) takes over
    # on the accelerator; the host keeps using f64.
    weights = None
    if on_host or S < DEDUP_MAX_SITES:
        compact, weights = _dedupe_rows(compact)
        S = len(compact)
    # bound one-hot scratch to ~256MB (host sized for the f64 worst case
    # of the weighted kernel) and keep f32 sums exact (< 2^24)
    elt = 8 if on_host else (4 if weights is not None else 1)
    # floor at 1024 rows: a fixed 16K floor used to override the scratch
    # bound at large sample counts — e.g. 1024 samples at width 8 wants
    # chunk 4096, and 16384 would be a ~1GB one-hot against the ~256MB
    # promise. Power-of-two bucketing keeps the compile cache effective
    chunk = max(
        1 << 10, min(1 << 24, GRAM_SCRATCH_BYTES // max(elt * width * n, 1))
    )
    # ... but never a chunk bigger than the pow2 bucket that holds the
    # data: otherwise ~48K real rows would be padded out to the full
    # 8.4M-row scratch-bound chunk, a 134MB transfer of padding
    chunk = min(chunk, max(1 << 10, 1 << int(np.ceil(np.log2(max(S, 1))))))
    chunk = 1 << int(np.floor(np.log2(chunk)))
    Gc = np.zeros((n * width, n * width), dtype=np.int64)
    n_chunks = -(-S // chunk)
    bar = None
    if n_chunks > 1:  # merge_ska_array.rs:421 distance progress analog
        from .progress import Bar

        bar = Bar(n_chunks, "site chunks")
    jnp = None
    if not on_host:
        from .jaxinit import jnp
    for s0 in range(0, S, chunk):
        c = compact[s0 : s0 + chunk]
        if on_host:
            # numpy BLAS kernel, no jax and no shape padding (nothing
            # jit-compiled to keep shape-stable on this path)
            w = weights[s0 : s0 + chunk]
            f64 = bool(int(w.sum()) >= (1 << 24))
            Gc += np.rint(_np_gram_weighted(c, w, n, width, f64)).astype(np.int64)
            if bar:
                bar.update()
            continue
        npad = chunk - len(c)
        if npad:
            c = np.concatenate([c, np.full((npad, n), pad_class, np.int8)])
        if weights is not None:
            w = weights[s0 : s0 + chunk]
            if npad:
                w = np.concatenate([w, np.zeros(npad, w.dtype)])
            # keep f32 sums exactly integral; the accelerator path only
            # dedupes below 2^24 total sites, past which the undeduped
            # int8 Gram takes over
            Gc += np.asarray(
                _gram_chunk_weighted(jnp.asarray(c), jnp.asarray(w), n, width, False),
                dtype=np.int64,
            )
        else:
            Gc += np.asarray(
                _gram_chunk(jnp.asarray(c), n, width), dtype=np.int64
            )
        if bar:
            bar.update()
    if bar:
        bar.finish()
    if weights is None and K == width:
        # The undeduped path's tail padding reused class 0 ('-') as the
        # pad (no discarded slot when K == width), so every padding row
        # added exactly 1 to [i, pad, j, pad] for all site pairs —
        # subtract that contribution so the Gram stays exact (the
        # weighted host path pads with weight 0 instead). Distances were
        # right either way (gap-gap coefficients are zero), but
        # class_gram's own contract is exact counts.
        total_pad = n_chunks * chunk - S
        if total_pad:
            Gv = Gc.reshape(n, width, n, width)
            Gv[:, pad_class, :, pad_class] -= total_pad
    return scatter_gram_16(Gc, present, K, width, n)


def pairwise_stats(variants: np.ndarray, constant: float, filt_ambig: bool):
    """Upper-triangle list-of-lists of VariantDist, same layout as the
    reference distance() (merge_ska_array.rs:416-438)."""
    n = variants.shape[1]
    G = class_gram(variants).reshape(n, 16, n, 16).astype(np.float64)
    dist_c, match_c, mism_c = _class_tables(filt_ambig)

    D = np.einsum("iajb,ab->ij", G, dist_c)
    M = np.einsum("iajb,ab->ij", G, match_c)
    X = np.einsum("iajb,ab->ij", G, mism_c)

    out = []
    for i in range(n):
        row = []
        for j in range(i + 1, n):
            matches = constant + M[i, j]
            mism = X[i, j]
            denom = matches + mism
            prop = (mism / denom) if denom != 0.0 else 0.0
            row.append(
                VariantDist(
                    distance=float(D[i, j]),
                    mismatch_prop=float(prop),
                    match_count=int(matches),
                    mismatch_count=int(mism),
                )
            )
        out.append(row)
    return out
