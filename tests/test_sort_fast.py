"""ops.keys.lax_sort_fast: the single-key fast path and, critically, the
rare-tie fallback branch (first-key ties with out-of-order later keys
must trigger the full multi-key re-sort and still produce the exact
lexicographic order)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ska_tpu.ops import keys as K


def _np_lex(ops, num_keys):
    order = np.lexsort(tuple(np.asarray(o) for o in reversed(ops[:num_keys])))
    return [np.asarray(o)[order] for o in ops]


@pytest.mark.parametrize("is_stable", [True, False])
def test_fallback_fires_on_tied_descents(is_stable):
    """Adversarial input: many duplicate hi limbs whose lo limbs arrive
    descending — the fast single-key pass cannot order them, so the
    cond fallback must."""
    rng = np.random.default_rng(0)
    N = 4096
    hi = rng.integers(0, 8, size=N, dtype=np.uint64)  # heavy ties
    lo = rng.integers(0, 1 << 60, size=N, dtype=np.uint64)
    got = K.lax_sort_fast((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2,
                          is_stable=is_stable)
    want = _np_lex((hi, lo), 2)
    assert np.array_equal(np.asarray(got[0]), want[0])
    assert np.array_equal(np.asarray(got[1]), want[1])


def test_fast_path_without_ties_matches_full_sort():
    rng = np.random.default_rng(1)
    N = 4096
    hi = rng.permutation(np.arange(N, dtype=np.uint64))  # unique: no ties
    lo = rng.integers(0, 1 << 60, size=N, dtype=np.uint64)
    got = K.lax_sort_fast((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    full = jax.lax.sort((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2)
    assert np.array_equal(np.asarray(got[0]), np.asarray(full[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(full[1]))


def test_three_keys_with_payload():
    """num_keys=3 + payload: descent detection must consider the full
    lexicographic prefix, and stable payloads must follow their keys."""
    rng = np.random.default_rng(2)
    N = 2048
    a = rng.integers(0, 4, size=N, dtype=np.uint64)
    b = rng.integers(0, 4, size=N, dtype=np.uint64)
    c = rng.integers(0, 1 << 30, size=N, dtype=np.uint64)
    pay = np.arange(N, dtype=np.int32)
    got = K.lax_sort_fast(
        (jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(pay)),
        num_keys=3,
    )
    order = np.lexsort((pay, c, b, a))  # stable: original index last
    assert np.array_equal(np.asarray(got[0]), a[order])
    assert np.array_equal(np.asarray(got[1]), b[order])
    assert np.array_equal(np.asarray(got[2]), c[order])
    assert np.array_equal(np.asarray(got[3]), pay[order])


def test_2d_rows_share_one_flag():
    """dimension=-1 over (S, L): a violation in ANY row re-sorts all rows
    (one shared cond flag), and every row comes out lex-sorted."""
    rng = np.random.default_rng(3)
    S, L = 4, 512
    hi = rng.integers(0, 3, size=(S, L), dtype=np.uint64)
    lo = rng.integers(0, 1 << 50, size=(S, L), dtype=np.uint64)
    got = K.lax_sort_fast((jnp.asarray(hi), jnp.asarray(lo)), num_keys=2,
                          dimension=-1)
    gh, gl = np.asarray(got[0]), np.asarray(got[1])
    for s in range(S):
        order = np.lexsort((lo[s], hi[s]))
        assert np.array_equal(gh[s], hi[s][order])
        assert np.array_equal(gl[s], lo[s][order])


def test_pipeline_w2_with_adversarial_shared_flanks():
    """End-to-end k=63 build where many split keys share their leading
    30 flank bases (hi-limb ties): the unstable dedup fast path must
    fall back and the sample dict must match the brute-force oracle."""
    from ska_tpu.io import fastx
    from ska_tpu.sample import QualOpts, dict_from_batch
    from tests import oracle

    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    core = rng.choice(acgt, size=40)
    recs = []
    for i in range(30):
        tail = rng.choice(acgt, size=60)
        recs.append(bytes(core.tobytes()) + tail.tobytes())  # shared 40-base prefix
    batch = fastx.build_batch(recs, [None] * len(recs))
    qual = QualOpts(min_count=0, min_qual=0, qual_filter="strict")
    keys_np, sets_np = dict_from_batch(batch, 63, True, qual, False)

    want = oracle.sample_dict(recs, 63, rc=True)
    got = {
        (int(h) << 64) | int(l): int(s)
        for (h, l), s in zip(keys_np, sets_np)
    }
    assert got == want


# ---------------------------------------------------------------------------
# The sort every device path uses (sort_with -> lax_sort_fast) on the
# shapes the build pipeline feeds it: u64 keys with payloads at pow2
# lengths, two-limb keys, odd lengths, and all-ones pad sentinels.


def _check_multiset(ops_in, ops_out):
    a1 = sorted(zip(*[np.asarray(o).reshape(-1).tolist() for o in ops_in]))
    a2 = sorted(zip(*[np.asarray(o).reshape(-1).tolist() for o in ops_out]))
    assert a1 == a2


@pytest.mark.parametrize("L", [1 << 13, 1 << 14, 1 << 15])
def test_sort_with_u64_keys_with_payload(L):
    rng = np.random.default_rng(7)
    # many duplicates to stress tie handling
    x = rng.integers(0, 97, size=L, dtype=np.uint64) * np.uint64(
        0x9E3779B97F4A7C15
    )
    pay = rng.integers(0, 2**31, size=L, dtype=np.int32)
    sk, _, (sp,) = K.sort_with(jnp.asarray(x)[:, None], (jnp.asarray(pay),))
    order = np.argsort(x, kind="stable")
    assert np.array_equal(np.asarray(sk)[:, 0], x[order])
    assert np.array_equal(np.asarray(sp), pay[order])  # stable payloads
    _check_multiset((x, pay), (np.asarray(sk)[:, 0], sp))


def test_sort_with_two_limb_keys_bool_payload():
    rng = np.random.default_rng(3)
    L = 1 << 13
    hi = rng.integers(0, 3, size=L, dtype=np.uint64)
    lo = rng.integers(0, 2**63, size=L, dtype=np.uint64)
    em = rng.integers(0, 2, size=L).astype(bool)
    keys = jnp.stack([jnp.asarray(hi), jnp.asarray(lo)], axis=-1)
    sk, _, (se,) = K.sort_with(keys, (jnp.asarray(em),))
    gk = np.asarray(sk)
    order = np.lexsort((lo, hi))
    assert (gk[:, 0] == hi[order]).all() and (gk[:, 1] == lo[order]).all()
    _check_multiset((hi, lo, em), (gk[:, 0], gk[:, 1], se))


def test_lax_sort_fast_non_pow2_rows():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 2**63, size=(3, 1000), dtype=np.uint64)
    got = K.lax_sort_fast((jnp.asarray(x),), num_keys=1)
    assert (np.asarray(got[0]) == np.sort(x, axis=-1)).all()


def test_sentinels_sort_last():
    # the pipeline pads with 0xFF..FF rows and relies on them at the tail
    L = 1 << 13
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2**62, size=L, dtype=np.uint64)
    x[:100] = np.uint64(0xFFFFFFFFFFFFFFFF)
    hi = rng.integers(0, 2, size=L, dtype=np.uint64)
    hi[:100] = np.uint64(0xFFFFFFFFFFFFFFFF)
    sk, _, _ = K.sort_with(
        jnp.stack([jnp.asarray(hi), jnp.asarray(x)], axis=-1), ()
    )
    got = np.asarray(sk)
    assert (got[-100:] == np.uint64(0xFFFFFFFFFFFFFFFF)).all()
    order = np.lexsort((x, hi))
    assert (got[:, 1] == x[order]).all()
