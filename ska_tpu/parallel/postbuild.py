"""Mesh-sharded post-build modes: distributed `ska map` lookup and
distributed `ska distance` Gram.

The reference is single-node for every post-build command (README.md:124
tells users to shard builds manually); these go beyond it on the
framework's multi-device axis. Both follow the build path's recipe
(parallel/build.py): shard_map over the same 'samples' mesh axis,
XLA collectives between devices, static shapes with host-side
escalation.

* distributed_lookup — the sort-merge-rank dictionary lookup at the
  heart of `ska map` (ska_ref.rs:508-533; serial device path
  ops/keys.py:searchsorted_via_sort), sharded by key range: the merged
  array's sorted keys are row-block sharded (contiguous key ranges),
  queries are routed to the owning device with one `all_to_all`, each
  device rank-merges only its own bucket, and answers ride the inverse
  `all_to_all` home. Per-device work is O((R+Q)/D log); the only
  D-scaled collective is the KB-size block-start gather.

* distributed_class_gram — the 16-class co-occurrence Gram behind
  `ska distance` (merge_ska_array.rs:416-438,587-632; serial device
  path distance.py:class_gram), sharded by sites: each device computes
  the weighted Gram of its row shard and one psum over the
  mesh yields the exact global Gram. Site rows are deduplicated on the
  host first (distance.py rationale), so each shard's f32 sums stay
  integer-exact below 2^24 total sites — same exactness policy as the
  serial path, enforced here by falling back to the serial kernel past
  the ceiling.
"""

from functools import partial

from ..jaxinit import jax, jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import keys as K
from .build import _MeshHolder, _pow2

U64 = jnp.uint64
_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)


# ---------------------------------------------------------------------------
# distributed map lookup
# ---------------------------------------------------------------------------


def _rank_lookup(keys_blk, queries):
    """Lower-bound indices of queries in this device's sorted key block
    (the merged-sort rank trick of ops/keys.py:_searchsorted_via_sort_jit,
    inlined so it runs inside shard_map with static shapes)."""
    N, W = keys_blk.shape
    M = queries.shape[0]
    both = jnp.concatenate([keys_blk, queries], axis=0)
    tag = jnp.concatenate([jnp.ones(N, jnp.int32), jnp.zeros(M, jnp.int32)])
    idx = jnp.concatenate(
        [jnp.zeros(N, jnp.int32), jnp.arange(M, dtype=jnp.int32)]
    )
    ops = tuple(both[:, i] for i in range(W)) + (tag, idx)
    res = jax.lax.sort(ops, num_keys=W + 2)
    stag, sidx = res[W], res[W + 1]
    is_q = stag == 0
    pos = jnp.arange(N + M, dtype=jnp.int32)
    ss = pos - (jnp.cumsum(is_q.astype(jnp.int32)) - 1)
    res2 = jax.lax.sort((stag, sidx, ss), num_keys=2)
    return jax.lax.dynamic_slice_in_dim(res2[2], 0, M)


def _lookup_shard(keys_blk, q_blk, n_dev, Rb, Cq):
    """Inside shard_map: route queries by key range, rank-merge locally,
    route answers home.

    keys_blk (Rb, W): this device's sorted key block (global order =
    device order; sentinel padded at the global tail).
    q_blk (Qb, W): positional query shard (sentinel keys = padding).
    Returns (rows (1, Qb) int64 global row or -1, overflow (1,) bool).
    """
    q = q_blk
    Qb, W = q.shape
    d_idx = jax.lax.axis_index("samples")

    # 1. every device's block-start key (monotone: blocks are contiguous
    #    key ranges; trailing all-sentinel blocks sort last)
    starts = jax.lax.all_gather(keys_blk[0:1], "samples", tiled=True)  # (D, W)

    # 2. destination bucket: count(starts <= q) - 1. D is small, so a
    #    dense (Qb, D) limb compare beats a gather-heavy binary search.
    ge = ~K.greater(starts[None, :, :], q[:, None, :])  # starts <= q
    live = jnp.any(q != U64(_SENT), axis=-1)
    dest = jnp.maximum(jnp.sum(ge, axis=1).astype(jnp.int32) - 1, 0)
    # park padding in bucket 0 with a sentinel key (never matches)
    dest = jnp.where(live, dest, 0)

    # 3. pack per-destination chunks: dest-major sort carrying the query
    #    limbs and its local slot, then slice one chunk per destination
    ops = (dest,) + tuple(q[:, i] for i in range(W)) + (
        jnp.arange(Qb, dtype=jnp.int32),
    )
    res = jax.lax.sort(ops, num_keys=1)
    sdest = res[0]
    sq = jnp.stack(res[1 : 1 + W], axis=-1)
    slocal = res[1 + W]  # local position of each routed query

    bnd = jnp.searchsorted(sdest, jnp.arange(n_dev, dtype=jnp.int32))
    o = jnp.concatenate([bnd.astype(jnp.int32), jnp.full(1, Qb, jnp.int32)])
    cnt = o[1:] - o[:-1]
    overflow = jnp.any(cnt > Cq)

    pk = jnp.concatenate([sq, jnp.full((Cq, W), _SENT, U64)], axis=0)
    pl = jnp.concatenate([slocal, jnp.zeros(Cq, slocal.dtype)])
    t = jnp.arange(Cq, dtype=jnp.int32)
    parts_k, parts_l = [], []
    for j in range(n_dev):
        m = t < cnt[j]
        kj = jax.lax.dynamic_slice_in_dim(pk, o[j], Cq, axis=0)
        lj = jax.lax.dynamic_slice_in_dim(pl, o[j], Cq, axis=0)
        parts_k.append(jnp.where(m[:, None], kj, U64(_SENT)))
        parts_l.append(jnp.where(m, lj, 0))
    send_k = jnp.stack(parts_k)  # (D, Cq, W)
    send_l = jnp.stack(parts_l)
    if n_dev > 1:
        recv_k = jax.lax.all_to_all(send_k, "samples", 0, 0)
    else:
        recv_k = send_k

    # 4. local rank merge over this device's bucket
    rq = recv_k.reshape(n_dev * Cq, W)
    idx = _rank_lookup(keys_blk, rq)
    idx_c = jnp.clip(idx, 0, Rb - 1)
    found = jnp.all(keys_blk[idx_c] == rq, axis=-1) & jnp.any(
        rq != U64(_SENT), axis=-1
    )
    grow = jnp.where(
        found, d_idx.astype(jnp.int64) * Rb + idx_c.astype(jnp.int64), -1
    )

    # 5. answers ride the inverse all_to_all (same (D, Cq) layout swaps
    #    back to the sender), then scatter home by the kept local slot
    ans = grow.reshape(n_dev, Cq)
    if n_dev > 1:
        back = jax.lax.all_to_all(ans, "samples", 0, 0)
    else:
        back = ans
    rows = jnp.full(Qb + 1, jnp.int64(-1))
    for j in range(n_dev):
        m = t < cnt[j]
        lj = jax.lax.dynamic_slice_in_dim(pl, o[j], Cq, axis=0)
        rows = rows.at[jnp.where(m, lj, Qb)].set(
            jnp.where(m, back[j], jnp.int64(-1))
        )
    return rows[None, :Qb], overflow[None]


@partial(jax.jit, static_argnames=("n_dev", "Rb", "Cq", "mesh_holder"))
def _jit_lookup(keys_sh, q_sh, n_dev, Rb, Cq, mesh_holder):
    fn = jax.shard_map(
        partial(_lookup_shard, n_dev=n_dev, Rb=Rb, Cq=Cq),
        mesh=mesh_holder.mesh,
        in_specs=(P("samples"), P("samples")),
        out_specs=(P("samples"), P("samples")),
    )
    return fn(keys_sh, q_sh)


def distributed_lookup(sorted_keys: np.ndarray, queries: np.ndarray, mesh):
    """Key-range-sharded lower-bound lookup of queries in a globally
    sorted key array. Returns (found bool (Q,), global_rows int64 (Q,)
    with -1 at misses). Equivalent to the serial
    searchsorted_via_sort + equality check in RefSka.map."""
    D = int(mesh.devices.size)
    holder = _MeshHolder(mesh)
    sharding = NamedSharding(mesh, P("samples"))

    sorted_keys = np.asarray(sorted_keys, dtype=np.uint64)
    queries = np.asarray(queries, dtype=np.uint64)
    if sorted_keys.ndim == 1:
        sorted_keys = sorted_keys[:, None]
    if queries.ndim == 1:
        queries = queries[:, None]
    R, W = sorted_keys.shape
    Q = queries.shape[0]

    Rb = _pow2(max(-(-R // D), 1))
    keys_pad = np.full((D * Rb, W), _SENT, np.uint64)
    keys_pad[:R] = sorted_keys
    Qb = _pow2(max(-(-Q // D), 1))
    q_pad = np.full((D * Qb, W), _SENT, np.uint64)
    q_pad[:Q] = queries

    def _put(x):
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )

    # worst case all queries of one device land in one bucket => Cq = Qb;
    # start at 2x the even share (keys are near-uniform packed k-mers)
    # and escalate on overflow — correctness never depends on the guess
    Cq = min(_pow2(max(2 * Qb // D, 1)), _pow2(Qb))
    while True:
        rows_sh, overflow = _jit_lookup(
            _put(keys_pad), _put(q_pad), D, int(Rb), int(Cq), holder,
        )
        if not bool(np.asarray(overflow).any()):
            break
        if Cq >= Qb:
            break
        Cq = min(Cq * 2, _pow2(Qb))

    rows = np.asarray(rows_sh).reshape(-1)[:Q]
    # sentinel-padded key rows at the global tail can false-match a
    # sentinel query, but real queries never carry the sentinel key (top
    # 4 bits of a packed split key are clear), and padding queries are
    # sliced off here
    found = rows >= 0
    return found, rows


# ---------------------------------------------------------------------------
# distributed distance Gram
# ---------------------------------------------------------------------------


def _gram_shard(classes_blk, weights_blk, n, width):
    """Inside shard_map: weighted f32 Gram of this device's (Sb, n) site
    shard + psum over the mesh (exactness rationale in distance.py —
    Precision.HIGHEST keeps integer products/sums exact below 2^24)."""
    c = classes_blk
    w = weights_blk
    C = c.shape[0]
    onehot = jax.nn.one_hot(c.astype(jnp.int32), width, dtype=jnp.float32)
    X = onehot.reshape(C, n * width)
    G = jax.lax.dot_general(
        X * w[:, None].astype(jnp.float32),
        X,
        (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return jax.lax.psum(G, "samples")[None]


@partial(jax.jit, static_argnames=("n", "width", "mesh_holder"))
def _jit_gram(classes_sh, weights_sh, n, width, mesh_holder):
    fn = jax.shard_map(
        partial(_gram_shard, n=n, width=width),
        mesh=mesh_holder.mesh,
        in_specs=(P("samples"), P("samples")),
        out_specs=P("samples"),
    )
    return fn(classes_sh, weights_sh)


def distributed_class_gram(variants: np.ndarray, mesh) -> np.ndarray:
    """Site-sharded exact 16-class co-occurrence Gram over the mesh.
    Byte-equal to distance.class_gram (shared compaction helpers); falls
    back to the serial kernel past the f32 exactness ceiling
    (distance.DEDUP_MAX_SITES)."""
    from ..distance import (
        DEDUP_MAX_SITES,
        _dedupe_rows,
        compact_classes,
        scatter_gram_16,
    )

    S, n = variants.shape
    if S >= DEDUP_MAX_SITES:
        # serial kernel picks its exact path per backend; the explicit
        # on_host skips class_gram's distributed gate (which would
        # recurse back here)
        from ..distance import class_gram

        return class_gram(
            variants, on_host=jax.default_backend() == "cpu"
        )

    compact, present, Kp, width, pad_class = compact_classes(variants)
    compact, weights = _dedupe_rows(compact)
    Su = len(compact)

    from .. import distance as _dist

    D = int(mesh.devices.size)
    # the serial kernel bounds one-hot scratch to ~256MB per dispatch
    # (distance.class_gram, GRAM_SCRATCH_BYTES); apply the same bound
    # PER DEVICE here — a single unchunked dispatch at Sb ~ millions of
    # rows would materialize a multi-GB f32 one-hot and OOM the chip
    chunk = max(
        1 << 10,
        min(1 << 24, _dist.GRAM_SCRATCH_BYTES // max(4 * width * n, 1)),
    )
    Sb = max(_pow2(max(-(-Su // D), 1)), 1)
    Sb = min(Sb, chunk)

    holder = _MeshHolder(mesh)
    sharding = NamedSharding(mesh, P("samples"))

    def _put(x):
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )

    Gc = np.zeros((n * width, n * width), dtype=np.int64)
    step = D * Sb
    for s0 in range(0, max(Su, 1), step):
        c_pad = np.full((step, n), pad_class, np.int8)
        w_pad = np.zeros(step, np.int64)  # zero-weight pads are inert
        blk = compact[s0 : s0 + step]
        c_pad[: len(blk)] = blk
        w_pad[: len(blk)] = weights[s0 : s0 + step]
        G_sh = _jit_gram(_put(c_pad), _put(w_pad), int(n), int(width), holder)
        # every shard row holds the identical psum result; take the first
        Gc += np.asarray(G_sh[0]).astype(np.int64)

    return scatter_gram_16(Gc, present, Kp, width, n)
