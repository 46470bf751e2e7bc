"""Mesh-sharded build: per-device sample pipelines + key-range-repartitioned
distributed merge (sample sort / PSRS over the device mesh).

Replaces the reference's rayon binary-tree hashmap merge
(merge_ska_dict.rs:354-417) with collectives, and is the path
`__graft_entry__.dryrun_multichip` exercises. Two jitted stages
(shard_map over a 'samples' mesh axis):

LOCAL stage — one dispatch per (padded-length bucket, FASTQ config)
group of samples; each device runs the FULL per-sample pipeline for its
shard (ops.pipeline.batched_pipeline: extraction, FASTQ quality gates,
min-count rank filter, per-sample 2-D row-wise sort + segmented IUPAC
union — NOT a vmap: lax_sort_fast's rare-tie fallback is a lax.cond
that vmap would degrade to both-branches execution) — identical
semantics to the serial path — and emits device-resident (key, global
sample id, set) triples. Triples of every group stay on device:
mixed-length cohorts never round-trip through the host.

MERGE stage — ONE dispatch for the whole cohort regardless of how many
length buckets it spans (the reference's one global merge,
merge_ska_dict.rs:354-417):

1. each device concatenates its local triples across all groups and
   sorts them by key
2. splitter selection: R regularly-spaced key samples per device are
   all-gathered (tiny), sorted replicated, and D-1 quantile pivots
   chosen — the classic parallel-sample-sort recipe, which bounds every
   key-range bucket by ~2x the even share
3. triples are exchanged by key range with `all_to_all`: device j
   receives exactly the triples whose keys fall in its bucket. XLA:CPU
   (the virtual-mesh test backend) has no ragged-all-to-all, so chunks
   are padded to a static per-pair capacity; a send-side overflow flag
   is returned and the host escalates the capacity (recompiling ONLY
   the merge stage — local triples are reused) in the rare skewed
   case — correctness never depends on the capacity guess.
4. each device merges ONLY its own bucket: one local sort by key, row
   assignment, and a scatter into its (rows x n_samples) shard of the
   variants matrix. Device order == key-range order, so concatenating
   the per-device row blocks yields the globally sorted array.

Per-device memory is O(total/D): nothing replicated scales with the
total k-mer count (the round-1 design all-gathered every triple and
sorted the full set on every device).
"""

from functools import partial

from ..jaxinit import jax, jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import keys as K
from ..ops import pipeline as PIPE

U64 = jnp.uint64
_SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
_R_SAMP = 128  # splitter samples per device
# flat-scatter positions stay int32 below this M * n_samples product;
# module-level so tests can shrink it to drive the int64 branch
_I32_SCATTER_LIMIT = 2**31


def build_mesh(n_devices=None, devices=None):
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.array(devices), axis_names=("samples",))


def _local_triples(
    seqs, valid, qual_ok, rec_last, sids,
    k, rc, W, is_reads, use_mq, min_count,
):
    """Inside shard_map: per-sample pipelines for this device's shard.

    Returns (keyv (1, N, W), sid (1, N) int32, setv (1, N)) where N =
    s_loc * L; dead positions carry all-ones sentinel keys. sids maps
    local rows to GLOBAL cohort columns, so triples from different
    length-bucket groups can merge in one exchange.
    """
    s_loc, L = seqs.shape
    # per-sample pipelines (count filter + qual + per-sample union),
    # exactly the serial semantics (ska_dict.rs:76-113 + bloom_filter.rs)
    sp, union, is_end, _n = PIPE.batched_pipeline.__wrapped__(
        seqs, valid, qual_ok, rec_last, k, rc, W, is_reads, use_mq, min_count
    )
    N = s_loc * L
    sp = sp.reshape(N, W)
    keyv = K.shr(sp, 4)  # drop the in-sort set bits
    live = is_end.reshape(N) & jnp.any(sp != U64(_SENT), axis=-1)
    keyv = jnp.where(live[:, None], keyv, jnp.full_like(keyv, _SENT))
    sid = jnp.broadcast_to(sids[:, None], (s_loc, L)).reshape(N)
    setv = jnp.where(live, union.reshape(N), 0)
    return keyv[None], sid[None], setv[None]


def _local_triples_raw(
    seqs, qual_bits, rec_ends, sids,
    k, rc, W, is_reads, use_mq, min_count, strict_valid, has_qual,
):
    """Raw-bytes variant of _local_triples: masks are derived on device
    (ops.pipeline.device_masks) inside the shard, so the host ships
    1-1.125 bytes/base (seq + packed quality-pass bits) instead of 4."""
    valid, qual_ok, rec_last = PIPE.device_masks(
        seqs, qual_bits, rec_ends, strict_valid, has_qual
    )
    return _local_triples(
        seqs, valid, qual_ok, rec_last, sids,
        k, rc, W, is_reads, use_mq, min_count,
    )


def _merge_shard(keyv_parts, sid_parts, set_parts, n_dev, n_samples, C_pair):
    """Inside shard_map: one global key-range exchange + bucket merge over
    the concatenation of every group's device-local triples."""
    # 1. concat this device's triples across groups, sort by key
    #    (sentinels last; real keys have the top 4 bits of the hi limb
    #    clear, so all-ones never collides with a key)
    keyv = jnp.concatenate([p[0] for p in keyv_parts], axis=0)
    sid = jnp.concatenate([p[0] for p in sid_parts], axis=0)
    setv = jnp.concatenate([p[0] for p in set_parts], axis=0)
    N, W = keyv.shape
    skeys, _, (ssid, sset) = K.sort_with(keyv, (sid, setv))
    live = jnp.any(skeys != U64(_SENT), axis=-1)
    nv = jnp.sum(live.astype(jnp.int32))

    # 2. splitters: R regular samples of the local sorted keys, gathered
    #    and sorted replicated (D*R elements — tiny), pivots at the
    #    D-quantiles
    r = jnp.arange(_R_SAMP, dtype=jnp.int64)
    # 64-bit index math: r * nv wraps int32 once a device holds more than
    # ~2^31/128 live triples — routine at genome scale — and wrapped
    # splitter indices degenerate every bucket (capacity escalation /
    # OOM), so this must not rely on the overflow flag for correctness
    samp_idx = jnp.clip((r * nv.astype(jnp.int64)) // _R_SAMP, 0, N - 1).astype(
        jnp.int32 if N < 2**31 else jnp.int64
    )
    samp = skeys[samp_idx]
    gs = jax.lax.all_gather(samp, "samples", tiled=True)  # (D*R, W)
    gss = jnp.stack(
        jax.lax.sort(tuple(gs[:, i] for i in range(W)), num_keys=W), axis=-1
    )
    pivots = gss[_R_SAMP :: _R_SAMP][: n_dev - 1]  # (D-1, W), static slice

    # bucket boundaries in the local sorted keys: lower bound, so keys
    # equal to a pivot land in the same bucket on every device
    if n_dev > 1:
        bnd = jnp.minimum(K.searchsorted(skeys, pivots), nv)
        o = jnp.concatenate([jnp.zeros(1, jnp.int32), bnd, nv[None]])
    else:
        o = jnp.concatenate([jnp.zeros(1, jnp.int32), nv[None]])
    o = jax.lax.cummax(o)  # monotonic even for degenerate pivots
    cnt = o[1:] - o[:-1]  # (D,) triples for each destination
    overflow = jnp.any(cnt > C_pair)

    # 3. pad + slice per-destination chunks, exchange by key range
    pk = jnp.concatenate([skeys, jnp.full((C_pair, W), _SENT, U64)], axis=0)
    psid = jnp.concatenate([ssid, jnp.zeros(C_pair, ssid.dtype)])
    pset = jnp.concatenate([sset, jnp.zeros(C_pair, sset.dtype)])
    t = jnp.arange(C_pair, dtype=jnp.int32)
    parts_k, parts_s, parts_t = [], [], []
    for j in range(n_dev):
        m = t < cnt[j]
        kj = jax.lax.dynamic_slice_in_dim(pk, o[j], C_pair, axis=0)
        sj = jax.lax.dynamic_slice_in_dim(psid, o[j], C_pair, axis=0)
        tj = jax.lax.dynamic_slice_in_dim(pset, o[j], C_pair, axis=0)
        parts_k.append(jnp.where(m[:, None], kj, U64(_SENT)))
        parts_s.append(jnp.where(m, sj, 0))
        parts_t.append(jnp.where(m, tj, 0))
    send_k = jnp.stack(parts_k)  # (D, C_pair, W)
    send_s = jnp.stack(parts_s)
    send_t = jnp.stack(parts_t)
    if n_dev > 1:
        recv_k = jax.lax.all_to_all(send_k, "samples", 0, 0)
        recv_s = jax.lax.all_to_all(send_s, "samples", 0, 0)
        recv_t = jax.lax.all_to_all(send_t, "samples", 0, 0)
    else:
        recv_k, recv_s, recv_t = send_k, send_s, send_t

    # 4. merge this device's bucket only: sort received triples by key,
    #    assign rows, scatter middle-base columns
    M = n_dev * C_pair
    mk, _, (msid, mset) = K.sort_with(
        recv_k.reshape(M, W), (recv_s.reshape(M), recv_t.reshape(M))
    )
    mlive = jnp.any(mk != U64(_SENT), axis=-1)
    firstk = jnp.concatenate(
        [jnp.ones(1, bool), jnp.any(mk[1:] != mk[:-1], axis=-1)]
    )
    newrow = firstk & mlive
    rows = jnp.cumsum(newrow.astype(jnp.int32)) - 1
    n_rows = jnp.sum(newrow.astype(jnp.int32))

    from ..encoding import SET_TO_ASCII

    ascii_vals = jnp.asarray(SET_TO_ASCII)[mset]
    gap = jnp.uint8(ord("-"))
    # flat scatter position: int32 wraps once M * n_samples exceeds 2^31
    # (large-sample mesh builds), silently dropping rows — both factors
    # are static, so widen exactly when needed
    idt = jnp.int32 if M * n_samples + 1 < _I32_SCATTER_LIMIT else jnp.int64
    pos = jnp.where(
        mlive, rows.astype(idt) * idt(n_samples) + msid.astype(idt),
        idt(M * n_samples),
    )
    variants = (
        jnp.full(M * n_samples + 1, gap, jnp.uint8)
        .at[pos]
        .set(jnp.where(mlive, ascii_vals, gap))[: M * n_samples]
        .reshape(M, n_samples)
    )
    krows = jnp.where(newrow, rows, M)
    ukeys = (
        jnp.zeros((M + 1, W), U64)
        .at[krows]
        .set(jnp.where(newrow[:, None], mk, U64(0)))[:M]
    )
    counts = (
        jnp.zeros(M + 1, jnp.int32)
        .at[jnp.where(mlive, rows, M)]
        .add(mlive.astype(jnp.int32))[:M]
    )
    return ukeys, variants, counts, n_rows[None], overflow[None]


@partial(
    jax.jit,
    static_argnames=(
        "k", "rc", "W", "is_reads", "use_mq", "min_count", "mesh_holder",
    ),
)
def _jit_local(
    seqs, valid, qual_ok, rec_last, sids,
    k, rc, W, is_reads, use_mq, min_count, mesh_holder,
):
    mesh = mesh_holder.mesh
    fn = jax.shard_map(
        partial(
            _local_triples,
            k=k, rc=rc, W=W,
            is_reads=is_reads, use_mq=use_mq, min_count=min_count,
        ),
        mesh=mesh,
        in_specs=(P("samples"), P("samples"), P("samples"), P("samples"),
                  P("samples")),
        out_specs=(P("samples"), P("samples"), P("samples")),
    )
    return fn(seqs, valid, qual_ok, rec_last, sids)


@partial(
    jax.jit,
    static_argnames=(
        "k", "rc", "W", "is_reads", "use_mq", "min_count",
        "strict_valid", "has_qual", "mesh_holder",
    ),
)
def _jit_local_raw(
    seqs, qual_bits, rec_ends, sids,
    k, rc, W, is_reads, use_mq, min_count, strict_valid, has_qual,
    mesh_holder,
):
    mesh = mesh_holder.mesh
    fn = jax.shard_map(
        partial(
            _local_triples_raw,
            k=k, rc=rc, W=W,
            is_reads=is_reads, use_mq=use_mq, min_count=min_count,
            strict_valid=strict_valid, has_qual=has_qual,
        ),
        mesh=mesh,
        in_specs=(P("samples"), P("samples"), P("samples"), P("samples")),
        out_specs=(P("samples"), P("samples"), P("samples")),
    )
    return fn(seqs, qual_bits, rec_ends, sids)


@partial(jax.jit, static_argnames=("n_samples", "C_pair", "mesh_holder"))
def _jit_merge(keyv_parts, sid_parts, set_parts, n_samples, C_pair, mesh_holder):
    mesh = mesh_holder.mesh
    n_dev = mesh.devices.size
    fn = jax.shard_map(
        partial(
            _merge_shard,
            n_dev=n_dev, n_samples=n_samples, C_pair=C_pair,
        ),
        mesh=mesh,
        in_specs=(P("samples"), P("samples"), P("samples")),
        out_specs=(
            P("samples"), P("samples"), P("samples"), P("samples"), P("samples"),
        ),
    )
    return fn(keyv_parts, sid_parts, set_parts)


class _MeshHolder:
    """Hashable wrapper so the mesh can be a static jit arg."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash(tuple(d.id for d in self.mesh.devices.flat))

    def __eq__(self, other):
        return isinstance(other, _MeshHolder) and hash(self) == hash(other)


def _pow2(n: int) -> int:
    b = 256
    while b < n:
        b *= 2
    return b


def distributed_build_multi(calls, k, rc, mesh, min_count=0):
    """Full distributed build+merge of a mixed-shape cohort in ONE
    key-range exchange.

    calls: list of dicts, one per (length bucket, FASTQ config) group.
    Two staging shapes are accepted:
      legacy masks — seqs/valid/qual/rec_last: (S_c, L_c) host arrays
      raw bytes    — key "quals" present: seqs (S_c, L_c) uint8,
        quals = PACKED quality-pass bits (S_c, ceil(L_c/8)) (or (S_c, 1)
        dummy), rec_ends (S_c, E) int32, plus strict_valid/has_qual
        config; masks derive on device (1-1.125 bytes/base cross the
        link instead of 4)
    plus in both shapes:
      sids: (S_c,) int32 GLOBAL cohort column of each row
      is_reads/use_mq: bool pipeline config for the group
    The host arrays are CONSUMED (set to None) as each group is staged
    to the devices, so peak host memory is one sub-batch, not the
    cohort.
    n_samples (the output width) is 1 + max sid across calls.

    Each call's local pipeline runs as its own jitted dispatch (shapes
    differ), its triples staying device-resident; the merge is a single
    dispatch over all of them — no host op ever touches the full union
    (the reference's one global merge, merge_ska_dict.rs:354-417).
    Returns (keys (R, W), variants (R, n_samples) uint8, counts (R,),
    n_rows) on host, globally sorted by key.
    """
    W = K.width_for_k(k)
    D = mesh.devices.size
    holder = _MeshHolder(mesh)
    sharding = NamedSharding(mesh, P("samples"))

    def _put(x_np):
        # make_array_from_callback materializes only the addressable
        # shards, so this works unchanged on a multi-process (multi-host)
        # mesh where plain device_put of a host array cannot
        x_np = np.asarray(x_np)
        return jax.make_array_from_callback(
            x_np.shape, sharding, lambda idx: x_np[idx]
        )

    n_samples = 1 + max(int(np.max(c["sids"])) for c in calls)
    keyv_parts, sid_parts, set_parts = [], [], []
    N_loc_total = 0
    for c in calls:
        seqs_np = np.asarray(c["seqs"])
        S_in, L = seqs_np.shape
        S_pad = -(-S_in // D) * D
        raw = "quals" in c
        sids_np = np.asarray(c["sids"], dtype=np.int32)
        if raw:
            quals_np = np.asarray(c["quals"])
            ends_np = np.asarray(c["rec_ends"], dtype=np.int32)
        else:
            valid_np = np.asarray(c["valid"])
            qual_np = np.asarray(c["qual"])
            rl_np = np.asarray(c["rec_last"])
        if S_pad != S_in:
            padrow = ((0, S_pad - S_in), (0, 0))
            seqs_np = np.pad(seqs_np, padrow)  # zero bytes: no triples
            sids_np = np.pad(sids_np, (0, S_pad - S_in))
            if raw:
                quals_np = np.pad(quals_np, padrow)
                ends_np = np.pad(
                    ends_np, padrow, constant_values=L  # >= L: padding
                )
            else:
                valid_np = np.pad(valid_np, padrow)  # all-invalid
                qual_np = np.pad(qual_np, padrow)
                rl_np = np.pad(rl_np, padrow)
        if raw:
            kv, sv, tv = _jit_local_raw(
                _put(seqs_np), _put(quals_np), _put(ends_np), _put(sids_np),
                k, rc, W, bool(c["is_reads"]), bool(c["use_mq"]),
                int(min_count),
                bool(c.get("strict_valid", False)),
                bool(c.get("has_qual", False)), holder,
            )
            c["seqs"] = c["quals"] = c["rec_ends"] = None
            del seqs_np, quals_np, ends_np
        else:
            kv, sv, tv = _jit_local(
                _put(seqs_np), _put(valid_np), _put(qual_np), _put(rl_np),
                _put(sids_np),
                k, rc, W, bool(c["is_reads"]), bool(c["use_mq"]),
                int(min_count), holder,
            )
            # the staged host copies are device-resident now (_put
            # materializes the shards synchronously) — drop them so peak
            # host memory stays one sub-batch (SKA_MAX_HOST_BATCH_BYTES),
            # not the whole cohort held alive through `calls`
            c["seqs"] = c["valid"] = c["qual"] = c["rec_last"] = None
            del seqs_np, valid_np, qual_np, rl_np
        keyv_parts.append(kv)
        sid_parts.append(sv)
        set_parts.append(tv)
        N_loc_total += (S_pad // D) * L

    def _fetch(x):
        # on a multi-process mesh the output shards are not all
        # addressable locally; gather them to every process (host 0
        # writes outputs, but identical arrays everywhere keep the
        # call site process-agnostic)
        if jax.process_count() == 1:
            return np.asarray(x)
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))

    # even share is N_loc/D per (src, dst) pair; PSRS splitters bound the
    # realized bucket at ~2x, so 2x capacity avoids escalation in practice.
    # SKA_MESH_CPAIR_INIT shrinks the first guess (stress tests drive the
    # escalation loop with it; correctness never depends on the guess)
    import os as _os

    C_pair = int(_os.environ.get("SKA_MESH_CPAIR_INIT", 0)) or min(
        _pow2(max(2 * N_loc_total // D, 1)), _pow2(N_loc_total)
    )
    while True:
        ukeys, variants, counts, n_rows, overflow = _jit_merge(
            keyv_parts, sid_parts, set_parts, int(n_samples), int(C_pair),
            holder,
        )
        if not bool(_fetch(overflow).any()):
            break
        if C_pair >= N_loc_total:  # cnt <= nv <= N_loc: cannot overflow here
            break
        import logging

        logging.getLogger("ska_tpu").info(
            "distributed merge: bucket overflow at capacity %d, doubling", C_pair
        )
        C_pair = min(C_pair * 2, _pow2(N_loc_total))

    # host assembly: device blocks are consecutive key ranges
    M = D * C_pair
    ukeys = _fetch(ukeys)
    variants = _fetch(variants)
    counts = _fetch(counts)
    nr = _fetch(n_rows)
    parts_k, parts_v, parts_c = [], [], []
    for d in range(D):
        n = int(nr[d])
        parts_k.append(ukeys[d * M : d * M + n])
        parts_v.append(variants[d * M : d * M + n])
        parts_c.append(counts[d * M : d * M + n])
    keys = np.concatenate(parts_k, axis=0)
    var = np.concatenate(parts_v, axis=0)
    cnts = np.concatenate(parts_c, axis=0).astype(np.int64)
    return keys, var, cnts, len(keys)


def distributed_merged_build(
    seqs_np, valid_np, qual_np, rec_last_np, k, rc, mesh,
    is_reads=False, use_mid_qual=False, min_count=0,
):
    """Single-group build of (n_samples, L) uint8 sequences (the
    one-length-bucket special case of distributed_build_multi).

    Any sample count (rows are padded to a mesh multiple with all-invalid
    samples) and the full FASTQ surface (quality masks, min-count filter)
    are supported. Returns (keys (R, W), variants (R, n_samples) uint8,
    counts (R,), n_rows) on host, globally sorted by key.
    """
    S_in = np.asarray(seqs_np).shape[0]
    return distributed_build_multi(
        [dict(
            seqs=seqs_np, valid=valid_np, qual=qual_np, rec_last=rec_last_np,
            sids=np.arange(S_in, dtype=np.int32),
            is_reads=is_reads, use_mq=use_mid_qual,
        )],
        k, rc, mesh, min_count=min_count,
    )


def distributed_build(seqs_np, valid_np, rec_last_np, k, rc, mesh):
    """FASTA-only convenience wrapper (no quality/count filtering)."""
    qual = np.ones_like(np.asarray(valid_np), dtype=bool)
    return distributed_merged_build(
        seqs_np, valid_np, qual, rec_last_np, k, rc, mesh
    )


def dryrun_step(n_devices: int, k: int = 17, L: int = 512, per_dev_samples: int = 2):
    """Tiny mesh-sharded build steps (used by __graft_entry__).

    Exercises the full distributed pipeline on four configs: FASTA at
    k=17 with a sample count that does NOT divide the mesh (padding
    path), FASTQ with the min-count rank filter, W=2 two-limb keys
    (k=41), and a MIXED-LENGTH cohort (two length buckets through one
    key-range exchange) — i.e. local build, splitter selection,
    all_to_all key-range exchange, and the bucket merge, under every
    key/filter/grouping variant.
    """
    mesh = build_mesh(n_devices)
    n_samples = n_devices * per_dev_samples - 1 if n_devices > 1 else per_dev_samples
    rng = np.random.default_rng(0)
    seqs = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(n_samples, L))
    valid = np.ones((n_samples, L), bool)
    rec_last = np.zeros((n_samples, L), bool)
    rec_last[:, -1] = True
    keys, variants, counts, n_rows = distributed_build(seqs, valid, rec_last, k, True, mesh)
    assert n_rows > 0
    assert variants.shape == (n_rows, n_samples)

    # FASTQ + min-count: two identical reads per sample so every k-mer
    # passes the min_count=2 rank filter
    seqs2 = seqs.copy()
    seqs2[:, L // 2 :] = seqs[:, : L - L // 2]
    rl2 = np.zeros((n_samples, L), bool)
    rl2[:, L // 2 - 1] = True
    rl2[:, -1] = True
    qual = np.ones((n_samples, L), bool)
    _, _, _, n2 = distributed_merged_build(
        seqs2, valid, qual, rl2, k, True, mesh,
        is_reads=True, use_mid_qual=True, min_count=2,
    )
    assert n2 > 0

    # W=2 two-limb keys
    *_, n3 = distributed_build(seqs, valid, rec_last, 41, True, mesh)
    assert n3 > 0

    # mixed-length cohort: two buckets, one exchange
    L2 = L // 2
    seqs_b = seqs[:, :L2]
    rl_b = np.zeros((n_samples, L2), bool)
    rl_b[:, -1] = True
    calls = [
        dict(seqs=seqs, valid=valid, qual=qual, rec_last=rec_last,
             sids=np.arange(n_samples, dtype=np.int32),
             is_reads=False, use_mq=False),
        dict(seqs=seqs_b, valid=valid[:, :L2], qual=qual[:, :L2],
             rec_last=rl_b,
             sids=np.arange(n_samples, 2 * n_samples, dtype=np.int32),
             is_reads=False, use_mq=False),
    ]
    keys4, var4, _, n4 = distributed_build_multi(calls, k, True, mesh)
    assert n4 > 0 and var4.shape == (n4, 2 * n_samples)

    # distributed post-build modes over the same mesh (postbuild.py):
    # key-range-sharded map lookup and site-sharded distance Gram
    from .postbuild import distributed_class_gram, distributed_lookup

    queries = np.concatenate([keys[::3], keys[:4] ^ np.uint64(0x5A5A)])
    found, rows = distributed_lookup(keys, queries, mesh)
    n_hits = len(keys[::3])
    assert found[:n_hits].all()
    assert np.array_equal(keys[rows[:n_hits]], keys[::3])
    G = distributed_class_gram(variants, mesh)
    # every site contributes one class co-occurrence per (i, j) pair
    assert int(G.sum()) == variants.shape[0] * variants.shape[1] ** 2
    return n_rows
