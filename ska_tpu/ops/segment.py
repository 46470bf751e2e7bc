"""Sort + segmented-reduction engine.

This is the framework's runtime layer: the reference's hashmaps
(src/ska_dict.rs:76-113 per-sample dict, src/ska_dict/bloom_filter.rs
count filter) become sorts over packed keys followed by segmented
reductions — exact and deterministic. All functions are
fixed-shape: invalid rows carry an all-ones sentinel key which sorts last,
and callers receive a valid count.
"""

from functools import partial

from ..jaxinit import jax, jnp
import numpy as np

from . import keys as K

U64 = jnp.uint64
_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


def _sentinelize(keys, emit):
    return jnp.where(emit[:, None], keys, jnp.full_like(keys, _SENT))


@partial(jax.jit, static_argnames=())
def dedup_union(keys, sets, emit):
    """Unique keys with IUPAC set-union of middle bases.

    Replaces HashMap entry().and_modify IUPAC merging (ska_dict.rs:76-113):
    sort by key, then OR middle-base bit-sets within each key segment.

    keys: (L, W); sets: uint8[L] 4-bit base sets; emit: bool[L].
    Returns (ukeys (L, W), usets uint8[L], n_unique int32): first n_unique
    rows are the sorted unique keys and their unions.
    """
    L, W = keys.shape
    skeys_in = _sentinelize(keys, emit)
    sets_in = jnp.where(emit, sets, 0).astype(jnp.uint8)
    skeys, _, (ssets,) = K.sort_with(skeys_in, (sets_in,))

    first = jnp.concatenate([jnp.ones(1, bool), jnp.any(skeys[1:] != skeys[:-1], axis=-1)])
    ids = jnp.cumsum(first.astype(jnp.int32)) - 1

    usets = jnp.zeros(L, jnp.uint8)
    for b in range(4):
        bit = (ssets >> b) & 1
        ubit = jnp.zeros(L, jnp.uint8).at[ids].max(bit)
        usets = usets | (ubit << b)

    ukeys = jnp.zeros((L, W), U64)
    for w in range(W):
        ukeys = ukeys.at[:, w].set(jnp.zeros(L, U64).at[ids].max(skeys[:, w]))

    nem = jnp.sum(emit.astype(jnp.int32))
    n_unique = jnp.where(nem > 0, ids[jnp.clip(nem - 1, 0, L - 1)] + 1, 0)
    return ukeys, usets, n_unique


@partial(jax.jit, static_argnames=("min_count",))
def count_filter(wkeys, emit, min_count: int):
    """Per-occurrence min-count filter over whole-k-mer keys.

    Reproduces KmerFilter semantics (bloom_filter.rs:116-148) exactly:
    occurrences are ranked in stream order within each key class;
    - min_count <= 1: all occurrences pass
    - min_count == 2: occurrences with rank >= 2 pass (bloom path, :123-129)
    - min_count >= 3: only the occurrence with rank == min_count passes
      (Ordering::Equal on the exact count, :131-146)

    wkeys: (L, W) canonical whole k-mers, stream order = array index.
    Returns bool[L] pass mask aligned with the input order.
    """
    L, W = wkeys.shape
    if min_count <= 1:
        return emit
    pos = jnp.arange(L, dtype=jnp.int32)
    skeys_in = _sentinelize(wkeys, emit)
    skeys, (spos,), _ = K.sort_with(skeys_in, (), extra_keys=(pos,))

    first = jnp.concatenate([jnp.ones(1, bool), jnp.any(skeys[1:] != skeys[:-1], axis=-1)])
    i32 = jnp.arange(L, dtype=jnp.int32)
    seg_start_idx = jax.lax.cummax(jnp.where(first, i32, -1))
    rank = i32 - seg_start_idx + 1

    if min_count == 2:
        ok = rank >= 2
    else:
        ok = rank == min_count

    out = jnp.zeros(L, bool).at[spos].set(ok)
    return out & emit


@partial(jax.jit, static_argnames=("max_count",))
def count_histogram(wkeys, emit, max_count: int):
    """Histogram of per-key occurrence counts (for `ska cov`).

    Replaces the counting hashmap in coverage.rs:104-135 + histogram
    :156-174: bin[c-1] = number of distinct keys seen exactly c times,
    for c-1 < max_count.
    """
    L, W = wkeys.shape
    skeys_in = _sentinelize(wkeys, emit)
    skeys, _, _ = K.sort_with(skeys_in, ())
    first = jnp.concatenate([jnp.ones(1, bool), jnp.any(skeys[1:] != skeys[:-1], axis=-1)])
    ids = jnp.cumsum(first.astype(jnp.int32)) - 1
    nem = jnp.sum(emit.astype(jnp.int32))
    counts = jnp.zeros(L, jnp.int32).at[ids].add(1)
    n_unique = jnp.where(nem > 0, ids[jnp.clip(nem - 1, 0, L - 1)] + 1, 0)
    is_real = jnp.arange(L) < n_unique
    kc = jnp.clip(counts - 1, 0, max_count)  # overflow bin = max_count (dropped)
    hist = jnp.zeros(max_count + 1, jnp.int64).at[kc].add(is_real.astype(jnp.int64))
    return hist[:max_count]
