"""`ska distance` byte-exact comparisons vs reference oracles."""

import io

import pytest

from ska_tpu.api import build, distance_mode
from ska_tpu.io import skf
from ska_tpu.sample import QualOpts


def _dist_out(arr, min_freq=0.0, filt_ambig=True):
    fh = io.StringIO()
    distance_mode(arr, fh, min_freq, filt_ambig)
    return fh.getvalue()


def _oracle(ref_out, name):
    with open(f"{ref_out}/{name}") as f:
        return f.read()


@pytest.mark.parametrize(
    "fixture,kwargs,oracle_name",
    [
        ("merge.skf", {}, "merge.dist.stdout"),
        ("merge_k41.skf", {}, "merge_k41.dist.stdout"),
        ("merge_k9.skf", {"filt_ambig": False}, "merge_k9.dist.stdout"),
        ("merge_k9.skf", {}, "merge_k9_no_ambig.dist.stdout"),
        ("merge_k9.skf", {"min_freq": 1.0}, "merge_k9_min_freq.dist.stdout"),
    ],
)
def test_distance_fixture_oracles(ref_in, ref_out, fixture, kwargs, oracle_name):
    arr = skf.load(f"{ref_in}/{fixture}")
    assert _dist_out(arr, **kwargs) == _oracle(ref_out, oracle_name)


@pytest.fixture(scope="module")
def multidist(ref_in):
    names = ["N_test_1", "N_test_2", "ambig_test_1", "ambig_test_2", "test_1", "test_2"]
    files = [(n, f"{ref_in}/{n}.fa", None) for n in names]
    return build(files, 9, rc=True, qual=QualOpts())


def test_multidist(multidist, ref_out):
    arr = skf.load  # noqa: F841 (shape kept close to reference test flow)
    assert _dist_out(multidist.copy_like()) == _oracle(ref_out, "multidist.stdout")


def test_multidist_minfreq(multidist, ref_out):
    assert _dist_out(multidist.copy_like(), min_freq=0.9) == _oracle(
        ref_out, "multidist.minfreq.stdout"
    )


def test_multidist_ambig(multidist, ref_out):
    assert _dist_out(multidist.copy_like(), filt_ambig=False) == _oracle(
        ref_out, "multidist.ambig.stdout"
    )


def test_dedupe_rows_matches_np_unique():
    """_dedupe_rows (packed 4-bit lexsort) must equal np.unique(axis=0)
    with counts — including n not divisible by the 16-per-word packing."""
    import numpy as np

    from ska_tpu.distance import _dedupe_rows

    rng = np.random.default_rng(7)
    for S, n in [(0, 4), (1, 1), (500, 5), (300, 16), (400, 33), (257, 128)]:
        rows = rng.integers(0, 16, size=(S, n)).astype(np.int32)
        # force heavy duplication like real variant matrices
        if S > 10:
            rows = rows[rng.integers(0, max(S // 7, 1), size=S)]
        got_rows, got_counts = _dedupe_rows(rows)
        if S == 0:
            assert len(got_rows) == 0 and len(got_counts) == 0
            continue
        exp_rows, exp_counts = np.unique(rows, axis=0, return_counts=True)
        # _dedupe_rows orders by packed words (sample 0 in the LOW nibble),
        # which is a different total order than np.unique's lexicographic —
        # compare as sets of (row, count)
        got = {tuple(r) + (int(c),) for r, c in zip(got_rows, got_counts)}
        exp = {tuple(r) + (int(c),) for r, c in zip(exp_rows, exp_counts)}
        assert got == exp
        assert int(got_counts.sum()) == S


def test_weighted_gram_chunks_match_unweighted():
    """f32 and f64 weighted Gram over deduped rows must equal the int8
    Gram over the expanded (repeated) rows."""
    import jax.numpy as jnp
    import numpy as np

    from ska_tpu.distance import _gram_chunk, _gram_chunk_weighted

    rng = np.random.default_rng(11)
    n, width, U = 6, 8, 40
    rows = rng.integers(0, width, size=(U, n)).astype(np.int32)
    w = rng.integers(1, 50, size=U).astype(np.int64)
    expanded = np.repeat(rows, w, axis=0)
    exp = np.asarray(_gram_chunk(jnp.asarray(expanded), n, width), np.int64)
    for f64 in (False, True):
        got = np.asarray(
            _gram_chunk_weighted(jnp.asarray(rows), jnp.asarray(w), n, width, f64),
            np.int64,
        )
        assert np.array_equal(got, exp), f"f64={f64}"


def test_pairwise_stats_brute_force_all_classes():
    """Random matrices spanning ALL 16 classes (gap, ACGT, every IUPAC
    code) vs a direct per-pair walk implementing the reference semantics
    (merge_ska_array.rs:587-632). Exercises the width-16 compact bucket,
    the dedup path, and both filt_ambig branches."""
    import numpy as np

    from ska_tpu.distance import pairwise_stats
    from ska_tpu.encoding import BASE_PROB

    alphabet = np.frombuffer(b"-ACGTRYSWKMBDHVN", dtype=np.uint8)
    rng = np.random.default_rng(20260818)
    for n, S in [(3, 50), (7, 333), (12, 101)]:
        v = alphabet[rng.integers(0, 16, size=(S, n))]
        # heavy duplication to hit the dedup path
        v = v[rng.integers(0, max(S // 3, 1), size=S)]
        for filt_ambig in (False, True):
            got = pairwise_stats(v, constant=5.0, filt_ambig=filt_ambig)
            for i in range(n):
                for j in range(i + 1, n):
                    dist = 0.0
                    mism = 0.0
                    matches = 5.0
                    for s in range(len(v)):
                        a, b = int(v[s, i]), int(v[s, j])
                        if a == ord("-") or b == ord("-"):
                            if not (a == ord("-") and b == ord("-")):
                                mism += 1.0
                        elif filt_ambig:
                            if chr(a) in "ACGT" and chr(b) in "ACGT":
                                matches += 1.0
                                if a != b:
                                    dist += 1.0
                        else:
                            overlap = float(BASE_PROB[a] @ BASE_PROB[b])
                            if overlap > 0.0:
                                matches += 1.0
                            dist += 1.0 - overlap
                    g = got[i][j - i - 1]
                    assert abs(g.distance - dist) < 1e-9 * max(1.0, dist)
                    assert g.match_count == int(matches)
                    assert g.mismatch_count == int(mism)
                    denom = matches + mism
                    prop = mism / denom if denom else 0.0
                    assert abs(g.mismatch_prop - prop) < 1e-12


def test_class_gram_width_bucket_edges():
    """K==width corner cases: 4 gapless classes must bump the width (the
    tail-pad slot would otherwise collide with a real class), and exactly
    8 classes including '-' must reuse class 0 as the pad."""
    import numpy as np

    from ska_tpu.distance import class_gram
    from ska_tpu.encoding import ASCII_TO_SET

    rng = np.random.default_rng(3)

    def brute(v):
        cls = ASCII_TO_SET[v].astype(np.int64)
        n = v.shape[1]
        G = np.zeros((n * 16, n * 16), np.int64)
        for row in cls:
            for i in range(n):
                for j in range(n):
                    G[i * 16 + row[i], j * 16 + row[j]] += 1
        return G

    import ska_tpu.distance as dist_mod

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    eight = np.frombuffer(b"-ACGTRYS", dtype=np.uint8)
    for alpha, S, n in [(acgt, 77, 3), (eight, 130, 5), (acgt, 16384 + 3, 2)]:
        v = alpha[rng.integers(0, len(alpha), size=(S, n))]
        # ensure every class of the alphabet appears so K is exact
        v[: len(alpha), 0] = alpha
        # all three kernels: the dedup+weighted host path (zero-weight
        # pads), the dedup+weighted accelerator path, and — by forcing
        # the dedup ceiling to 0 — the undeduped accelerator path, whose
        # K==width tail pads reuse class 0 and must be subtracted back
        # out of the Gram
        assert np.array_equal(class_gram(v, on_host=True), brute(v)), (
            bytes(alpha), S, n)
        assert np.array_equal(class_gram(v, on_host=False), brute(v)), (
            bytes(alpha), S, n)
        ceiling = dist_mod.DEDUP_MAX_SITES
        try:
            dist_mod.DEDUP_MAX_SITES = 0
            assert np.array_equal(class_gram(v, on_host=False), brute(v)), (
                "undeduped", bytes(alpha), S, n)
        finally:
            dist_mod.DEDUP_MAX_SITES = ceiling


def test_weighted_gram_integer_exactness():
    """The weighted f32 Gram must be exact for integer weights with chunk
    totals just under 2^24 — on a GPU this requires Precision.HIGHEST
    (a default-precision f32 matmul may run in TF32, whose 10-bit
    mantissa cannot hold the weights)."""
    import numpy as np
    import jax.numpy as jnp

    from ska_tpu.distance import _gram_chunk_weighted

    rng = np.random.default_rng(3)
    C, n, width = 1024, 4, 8
    classes = rng.integers(0, width, size=(C, n)).astype(np.int8)
    w = (rng.integers(1, 32767, size=C).astype(np.int64)) | 1  # odd
    w[0] = (1 << 24) - 1 - int(w[1:].sum())
    assert w[0] > 0 and int(w.sum()) == (1 << 24) - 1
    G = np.asarray(
        _gram_chunk_weighted(jnp.asarray(classes), jnp.asarray(w), n, width, False),
        np.int64,
    )
    onehot = np.eye(width, dtype=np.int64)[classes].reshape(C, n * width)
    oracle = (onehot * w[:, None]).T @ onehot
    assert np.array_equal(G, oracle)


def test_host_distance_is_jax_free(tmp_path, ref_in):
    """SKA_PLATFORM=cpu `ska distance` must never import jax: the host
    Gram kernel is numpy BLAS (_np_gram_weighted) and the distributed
    gate answers from the environment (VERDICT r4 #5 — the ~2 s jax
    import was ~35% of the calm-window host command)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, SKA_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, io\n"
         "from ska_tpu import api\n"
         "from ska_tpu.io import skf\n"
         f"arr = skf.load({ref_in + '/merge.skf'!r})\n"
         "buf = io.StringIO()\n"
         "api.distance_mode(arr, buf, 0.0, True)\n"
         "assert 'Distance' in buf.getvalue()\n"
         "assert len(buf.getvalue().splitlines()) > 1\n"
         "assert 'jax' not in sys.modules, 'host distance imported jax'\n"
         "print('OK')\n"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.strip().endswith("OK")
