"""Packed split k-mer key arrays (1 or 2 uint64 limbs) and their device ops.

The reference is generic over u64 (k <= 31) / u128 (k <= 63)
(src/ska_dict/bit_encoding.rs:88-303). Here a key array is a jnp/numpy
array of shape (..., W) uint64 with W = 1 (k <= 31) or 2 (hi, lo limbs);
all ops are static in W so XLA specializes.
"""

from functools import partial

import numpy as np

from ..jaxinit import jax, jnp
from .npkeys import (  # noqa: F401 - re-exported numpy helpers
    from_python_ints,
    kbits_for_k,
    np_lex_argsort,
    to_python_ints,
    width_for_k,
)

U64 = jnp.uint64




def shl(limbs, s: int):
    """Static left shift of (..., W) uint64 limbs, limbs[..., 0] is hi."""
    W = limbs.shape[-1]
    if s == 0:
        return limbs
    if W == 1:
        return (limbs << np.uint64(s)) if s < 64 else jnp.zeros_like(limbs)
    hi, lo = limbs[..., 0], limbs[..., 1]
    if s < 64:
        nhi = (hi << np.uint64(s)) | (lo >> np.uint64(64 - s)) if s else hi
        nlo = lo << np.uint64(s)
    elif s < 128:
        nhi = lo << np.uint64(s - 64) if s > 64 else lo
        nlo = jnp.zeros_like(lo)
    else:
        nhi = nlo = jnp.zeros_like(lo)
    return jnp.stack([nhi, nlo], axis=-1)


def shr(limbs, s: int):
    """Static right shift of (..., W) uint64 limbs."""
    W = limbs.shape[-1]
    if s == 0:
        return limbs
    if W == 1:
        return (limbs >> np.uint64(s)) if s < 64 else jnp.zeros_like(limbs)
    hi, lo = limbs[..., 0], limbs[..., 1]
    if s < 64:
        nlo = (lo >> np.uint64(s)) | (hi << np.uint64(64 - s)) if s else lo
        nhi = hi >> np.uint64(s)
    elif s < 128:
        nlo = hi >> np.uint64(s - 64) if s > 64 else hi
        nhi = jnp.zeros_like(hi)
    else:
        nhi = nlo = jnp.zeros_like(hi)
    return jnp.stack([nhi, nlo], axis=-1)


def bor(a, b):
    return a | b


def from_scalar(x, W):
    """Broadcastable (W,) key from a python int."""
    if W == 1:
        return jnp.array([x & 0xFFFFFFFFFFFFFFFF], dtype=U64)
    return jnp.array([(x >> 64) & 0xFFFFFFFFFFFFFFFF, x & 0xFFFFFFFFFFFFFFFF], dtype=U64)


def _rev64(x):
    """Reverse the 32 2-bit groups within each uint64 lane
    (reference rev_comp shuffle, bit_encoding.rs:182-195)."""
    m = np.uint64
    x = ((x >> m(2)) & m(0x3333333333333333)) | ((x & m(0x3333333333333333)) << m(2))
    x = ((x >> m(4)) & m(0x0F0F0F0F0F0F0F0F)) | ((x & m(0x0F0F0F0F0F0F0F0F)) << m(4))
    x = ((x >> m(8)) & m(0x00FF00FF00FF00FF)) | ((x & m(0x00FF00FF00FF00FF)) << m(8))
    x = ((x >> m(16)) & m(0x0000FFFF0000FFFF)) | ((x & m(0x0000FFFF0000FFFF)) << m(16))
    x = (x >> m(32)) | (x << m(32))
    return x


def rev_comp(limbs, n_bases: int):
    """Reverse complement of 2-bit packed bases (W-limb), value in low 2*n_bases bits."""
    W = limbs.shape[-1]
    comp = np.uint64(0xAAAAAAAAAAAAAAAA)
    if W == 1:
        r = _rev64(limbs) ^ comp
        return shr(r, 64 - 2 * n_bases)
    hi, lo = limbs[..., 0], limbs[..., 1]
    rhi = _rev64(lo) ^ comp
    rlo = _rev64(hi) ^ comp
    return shr(jnp.stack([rhi, rlo], axis=-1), 128 - 2 * n_bases)


def greater(a, b):
    """Lexicographic a > b over limbs (unsigned)."""
    W = a.shape[-1]
    if W == 1:
        return a[..., 0] > b[..., 0]
    return (a[..., 0] > b[..., 0]) | ((a[..., 0] == b[..., 0]) & (a[..., 1] > b[..., 1]))


def equal(a, b):
    return jnp.all(a == b, axis=-1)


def lax_sort_fast(ops, num_keys: int, dimension: int = -1,
                  is_stable: bool = True):
    """Drop-in jax.lax.sort with a cheaper multi-key path.

    A lexicographic multi-key comparator can cost far more than the data
    movement of its payloads, so multi-key sorts run as: stable sort by
    the FIRST key with everything else as payload, then ONE violation
    check (an adjacent pair with equal first keys whose remaining keys
    descend), and only if it fires a lax.cond re-sorts with the full
    comparator. Ties in the leading 64 bits of packed split k-mer keys
    need >= 30 identical leading flank bases, so real data almost never
    pays the fallback; when it does, output is still exact. Both paths
    produce the unique stable lexicographic order, so results are
    bit-identical either way. Whether the GPU's sort lowering gains from
    this split is not measured yet.

    Do NOT call under vmap: vmapped cond executes both branches. Batched
    callers sort 2-D operands with dimension=-1 instead (one shared flag
    for the whole batch).

    is_stable=False is cheaper but is only sound when (a) payload
    operands attached to EQUAL full keys are interchangeable (e.g.
    identical by construction, or consumed by a commutative reduction),
    and (b) ties in the first key are rare or carry equal remaining keys
    — an unstable first pass scrambles tied runs, so common first-key
    ties with ordered later keys would fire the fallback every time (use
    the stable default there).
    """
    if num_keys == 1:
        return jax.lax.sort(
            ops, num_keys=1, dimension=dimension, is_stable=is_stable
        )
    fast = jax.lax.sort(ops, num_keys=1, dimension=dimension, is_stable=is_stable)

    def roll_pair(x):
        # adjacent (i, i+1) views along `dimension`
        sl_a = [slice(None)] * x.ndim
        sl_b = [slice(None)] * x.ndim
        sl_a[dimension] = slice(None, -1)
        sl_b[dimension] = slice(1, None)
        return x[tuple(sl_a)], x[tuple(sl_b)]

    # violation: equal keys[0..j-1] and keys[j] strictly descending
    eq_prefix = None
    viol = None
    for j in range(num_keys):
        a, b = roll_pair(fast[j])
        if j == 0:
            eq_prefix = a == b
            continue
        desc = eq_prefix & (a > b)
        viol = desc if viol is None else (viol | desc)
        eq_prefix = eq_prefix & (a == b)
    flag = jnp.any(viol)

    return jax.lax.cond(
        flag,
        lambda: jax.lax.sort(
            ops, num_keys=num_keys, dimension=dimension, is_stable=is_stable
        ),
        lambda: fast,
    )


def sort_with(keys, payloads, extra_keys=()):
    """Sort rows by key limbs (then extra_keys) carrying payloads.

    keys: (N, W); extra_keys: tuple of (N,) arrays appended to the sort key;
    payloads: tuple of (N,) arrays. Returns (sorted_keys, sorted_extras, sorted_payloads).
    Uses the lax_sort_fast single-key fast path — callers must not be
    under vmap (jit/shard_map contexts are fine).
    """
    W = keys.shape[-1]
    ops = tuple(keys[:, i] for i in range(W)) + tuple(extra_keys) + tuple(payloads)
    res = lax_sort_fast(ops, num_keys=W + len(extra_keys))
    skeys = jnp.stack(res[:W], axis=-1)
    nex = len(extra_keys)
    return skeys, res[W : W + nex], res[W + nex :]


def searchsorted_via_sort(sorted_keys, queries):
    """Lower-bound lookup of (M, W) queries in (N, W) sorted keys via one
    merged sort instead of binary search.

    The fori_loop binary search below costs ~log2(N) full-array random
    gathers; sorting the concatenation with a query-first tie tag and
    reading ranks off a cumsum costs two lax.sorts instead. Which of the
    two is faster on the GPU is not measured yet. Equivalent to
    np.searchsorted(side='left').

    Inputs are padded to power-of-two buckets (table pads = all-ones max
    keys sort last and never change a lower bound; query pads are sliced
    off) so jit shapes are dataset-independent and compiled programs are
    reused across datasets.
    """
    N, W = sorted_keys.shape
    M = queries.shape[0]
    Np, Mp = _pow2(max(N, 1)), _pow2(max(M, 1))
    if Np != N:
        pad = jnp.full((Np - N, W), np.uint64(0xFFFFFFFFFFFFFFFF), jnp.uint64)
        sorted_keys = jnp.concatenate([jnp.asarray(sorted_keys), pad], axis=0)
    if Mp != M:
        pad = jnp.full((Mp - M, W), np.uint64(0xFFFFFFFFFFFFFFFF), jnp.uint64)
        queries = jnp.concatenate([jnp.asarray(queries), pad], axis=0)
    out = _searchsorted_via_sort_jit(sorted_keys, queries)
    return jnp.clip(out[:M], 0, N)


def _pow2(n: int) -> int:
    b = 1024
    while b < n:
        b *= 2
    return b


@jax.jit
def _searchsorted_via_sort_jit(sorted_keys, queries):
    N, W = sorted_keys.shape
    M = queries.shape[0]
    both = jnp.concatenate([sorted_keys, queries], axis=0)
    # tag: queries sort BEFORE equal table keys (lower bound)
    tag = jnp.concatenate(
        [jnp.ones(N, jnp.int32), jnp.zeros(M, jnp.int32)]
    )
    idx = jnp.concatenate(
        [jnp.zeros(N, jnp.int32), jnp.arange(M, dtype=jnp.int32)]
    )
    ops = tuple(both[:, i] for i in range(W)) + (tag, idx)
    res = jax.lax.sort(ops, num_keys=W + 2)
    stag, sidx = res[W], res[W + 1]
    is_q = stag == 0
    pos = jnp.arange(N + M, dtype=jnp.int32)
    rank_q = jnp.cumsum(is_q.astype(jnp.int32)) - 1
    ss = pos - rank_q  # table elements strictly before this query
    # restore original query order: queries (tag 0) sort first, by idx
    res2 = jax.lax.sort((stag, sidx, ss), num_keys=2)
    return jax.lax.dynamic_slice_in_dim(res2[2], 0, M)


def searchsorted(sorted_keys, queries):
    """Vectorized lower-bound binary search of (M, W) queries in (N, W) sorted keys.

    Returns int32 indices in [0, N]. Branchless fori_loop; O(M log N) gathers.
    """
    N = sorted_keys.shape[0]
    M = queries.shape[0]
    n_steps = max(1, int(np.ceil(np.log2(max(N, 1) + 1))))
    # derive the loop carry from the inputs so it inherits their
    # varying-manual-axes status under shard_map (a plain zeros() carry
    # is unvarying and the fori_loop type check rejects the body output)
    zero = (queries[:, 0] & np.uint64(0)).astype(jnp.int32) + (
        sorted_keys[0, 0] & np.uint64(0)
    ).astype(jnp.int32)
    lo = zero
    hi = zero + jnp.int32(N)

    def body(_, lh):
        lo, hi = lh
        mid = (lo + hi) >> 1
        midk = sorted_keys[jnp.clip(mid, 0, N - 1)]
        # lower bound: key[mid] < query -> go right
        lt = greater(queries, midk)
        lo = jnp.where(lt & (lo < hi), mid + 1, lo)
        hi = jnp.where((~lt) & (lo < hi), mid, hi)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_steps + 1, body, (lo, hi))
    return lo
