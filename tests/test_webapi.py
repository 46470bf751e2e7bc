"""Tests for the in-memory JSON API (ska_tpu.webapi) — this framework's
equivalent of the reference WASM frontend (src/wasm/, lib.rs:894-1446).

No reference oracles exist for the browser build (it is untested in the
reference repo), so these tests assert (a) JSON document shape against
the reference source's construction order, (b) internal consistency with
the CLI pipeline (the mapped sequences must equal `ska map` rows), and
(c) the neighbor-joining solver against the standard worked 4-taxon
example.
"""

import io
import json
import os

import numpy as np
import pytest

from ska_tpu import api
from ska_tpu.sample import QualOpts
from ska_tpu.constants import QUAL_STRICT, DEFAULT_MINQUAL
from ska_tpu.webapi import (
    AlignData,
    SkaData,
    _clean_name,
    _file_kind,
    _same_pair,
    neighbor_joining,
)


def test_nj_canonical_example():
    # the standard worked NJ example (Saitou-Nei): first join (a,b) with
    # branch lengths 2 and 3, final trifurcation at (c:4, d:4, u:3)
    D = np.array(
        [
            [0, 5, 9, 9],
            [5, 0, 10, 10],
            [9, 10, 0, 8],
            [9, 10, 8, 0],
        ],
        dtype=float,
    )
    nwk = neighbor_joining(D, ["a", "b", "c", "d"])
    assert nwk == "(c:4,d:4,(a:2,b:3):3);"


def test_nj_small_cases():
    assert neighbor_joining(np.zeros((1, 1)), ["x"]) == "x;"
    two = neighbor_joining(np.array([[0.0, 3.0], [3.0, 0.0]]), ["x", "y"])
    assert two == "(x:3,y:0);"


def test_pair_heuristic():
    assert _same_pair("reads_1.fq", "reads_2.fq")
    assert _same_pair("s0_R1.fastq.gz", "s0_R2.fastq.gz")
    assert not _same_pair("test_1_fwd.fastq.gz", "test_1_rev.fastq.gz")
    assert not _same_pair("a_1.fq", "ab_2.fq")  # length mismatch
    assert not _same_pair("same.fq", "same.fq")


def test_file_kind_and_clean():
    assert _file_kind("x.fastq.gz") == "fastq"
    assert _file_kind("x.fq") == "fastq"
    assert _file_kind("x.fa.gz") == "fasta"
    assert _file_kind("x.fasta") == "fasta"
    assert _clean_name("my sample.fasta") == "my_sample"
    # the reference replaces ".fa" before ".fastq", so ".fastq" loses its
    # ".fa" prefix first (ska_align.rs:81-88) — reproduce, don't fix
    assert _clean_name("r_1.fastq.gz") == "r_1stq.gz"


def test_skadata_map_matches_cli(ref_in):
    ref = os.path.join(ref_in, "test_ref.fa")
    q1 = os.path.join(ref_in, "test_1.fa")
    sd = SkaData(ref, k=9)
    out = json.loads(sd.map(q1))
    assert set(out) == {"Mapped sequences", "Number of variants", "Coverage"}

    # the concatenated mapped sequence must equal the `ska map` aln row
    # for the same single-sample array
    qual = QualOpts(min_count=1, min_qual=0, qual_filter=QUAL_STRICT)
    arr = api.build([("test_1", q1, None)], 9, True, qual)
    buf = io.BytesIO()
    api.map_mode(arr, ref, buf, fmt="aln")
    cli_row = buf.getvalue().decode().splitlines()[1]
    whole = "".join(out["Mapped sequences"])
    assert whole == cli_row

    n_ref_chroms = 1
    assert len(out["Mapped sequences"]) == n_ref_chroms
    mapped = sum(1 for c in whole if c != "-")
    assert out["Coverage"] == pytest.approx(mapped / len(whole))
    assert out["Number of variants"] > 0

    # repeated map calls work (the reference accumulates SkaMaps)
    out2 = json.loads(sd.map(os.path.join(ref_in, "test_2.fa")))
    assert len("".join(out2["Mapped sequences"])) == len(whole)


def test_skadata_two_chrom_split(ref_in):
    ref = os.path.join(ref_in, "test_ref_two_chrom.fa")
    sd = SkaData(ref, k=9)
    out = json.loads(sd.map(os.path.join(ref_in, "test_1.fa")))
    seqs = out["Mapped sequences"]
    assert len(seqs) == 2
    # chunk lengths follow the reference chromosome lengths
    ref_lens = [len(s) for s in sd.reference.seq]
    assert [len(s) for s in seqs] == ref_lens
    assert sd.get_reference().split("\n") == ["".join(map(chr, s)) for s in sd.reference.seq]


def test_skadata_width_check(ref_in):
    with pytest.raises(ValueError):
        SkaData(os.path.join(ref_in, "test_ref.fa"), k=65)


def test_aligndata_not_enough(ref_in):
    ad = AlignData(k=9)
    out = json.loads(
        ad.align([os.path.join(ref_in, "test_1.fa"), os.path.join(ref_in, "test_2.fa")])
    )
    assert out["newick"] == "Not enough sequences to align"
    assert out["alignment"] == "Not enough sequences to align"
    assert out["names"] == ["test_1.fa", "test_2.fa"]


def test_aligndata_three_fastas(ref_in):
    files = [
        os.path.join(ref_in, "test_1.fa"),
        os.path.join(ref_in, "test_2.fa"),
        os.path.join(ref_in, "test_2_rc.fa"),
    ]
    ad = AlignData(k=9)
    out = json.loads(ad.align(files))
    assert set(out) == {"newick", "names", "alignment"}
    assert out["names"] == ["test_1.fa", "test_2.fa", "test_2_rc.fa"]

    # alignment is the UNFILTERED fasta of the merged array (lib.rs:1407-1421)
    qual = QualOpts(min_count=1, min_qual=0, qual_filter=QUAL_STRICT)
    arr = api.build([(os.path.basename(f), f, None) for f in files], 9, True, qual)
    buf = io.BytesIO()
    arr.write_fasta(buf)
    assert out["alignment"] == buf.getvalue().decode()

    # newick: all cleaned names appear; test_2 and test_2_rc are identical
    # sequences up to strand, so their pairwise distance is 0 and they
    # must be adjacent in the tree
    nwk = out["newick"]
    for nm in ("test_1", "test_2", "test_2_rc"):
        assert nm in nwk
    assert nwk.endswith(";")


def test_aligndata_json_key_orders_pin_reference(ref_in):
    """The reference's two align() return paths insert keys in DIFFERENT
    orders — (newick, alignment, names) when there are too few sequences
    (lib.rs:1394-1402) vs (newick, names, alignment) for a real alignment
    (lib.rs:1436-1443). That inconsistency is the reference's own; we
    replicate it key-for-key, and this test pins both orders so neither
    path drifts."""
    short = AlignData(k=9).align([os.path.join(ref_in, "test_1.fa")])
    assert list(json.loads(short)) == ["newick", "alignment", "names"]
    full = AlignData(k=9).align([
        os.path.join(ref_in, "test_1.fa"),
        os.path.join(ref_in, "test_2.fa"),
        os.path.join(ref_in, "test_2_rc.fa"),
    ])
    assert list(json.loads(full)) == ["newick", "names", "alignment"]


def test_aligndata_incremental_build_cache(ref_in, monkeypatch):
    """Repeated align() calls must build only the newly added files: the
    reference builds each file once when handed to align() and
    accumulates the dicts (lib.rs:1205-1384, get_queries). A second call
    re-building the whole input list would make the interactive API
    O(total) per call."""
    import ska_tpu.webapi as W

    built_batches = []
    real = W.build_samples

    def counting(inputs, *a, **kw):
        built_batches.append([name for name, _, _ in inputs])
        return real(inputs, *a, **kw)

    monkeypatch.setattr(W, "build_samples", counting)
    ad = AlignData(k=9)
    out1 = json.loads(ad.align([
        os.path.join(ref_in, "test_1.fa"),
        os.path.join(ref_in, "test_2.fa"),
        os.path.join(ref_in, "test_2_rc.fa"),
    ]))
    out2 = json.loads(ad.align([os.path.join(ref_in, "test_ref.fa")]))
    assert built_batches == [
        ["test_1.fa", "test_2.fa", "test_2_rc.fa"],
        ["test_ref.fa"],
    ]
    assert out2["names"] == [
        "test_1.fa", "test_2.fa", "test_2_rc.fa", "test_ref.fa"
    ]
    assert out1["newick"].endswith(";") and out2["newick"].endswith(";")


def test_aligndata_fastq_pairing(tmp_path, ref_in):
    # copy fixtures under pairable names: differ at the digit only
    import shutil

    f1 = tmp_path / "reads_1.fastq.gz"
    f2 = tmp_path / "reads_2.fastq.gz"
    shutil.copy(os.path.join(ref_in, "test_1_fwd.fastq.gz"), f1)
    shutil.copy(os.path.join(ref_in, "test_1_rev.fastq.gz"), f2)
    fa = os.path.join(ref_in, "test_1.fa")
    fb = os.path.join(ref_in, "test_2.fa")

    ad = AlignData(k=9)
    out = json.loads(ad.align([str(f1), fa, str(f2), fb]))
    # the two fastqs collapse into ONE paired sample
    assert out["names"] == ["test_1.fa", "test_2.fa", "reads_1.fastq.gz"]
    assert out["alignment"].count(">") == 3


def test_skadata_map_paired_fastq(ref_in):
    ref = os.path.join(ref_in, "test_ref.fa")
    sd = SkaData(ref, k=9)
    out = json.loads(
        sd.map(
            os.path.join(ref_in, "test_1_fwd.fastq.gz"),
            rev_reads=os.path.join(ref_in, "test_1_rev.fastq.gz"),
        )
    )
    # FASTQ mapping uses min_count=1 / no quality filter (ska_map.rs:47-51):
    # the reads recover the FASTA sample's variants up to read-coverage
    # gaps (these fixtures lose one k-mer to a gap)
    fa = json.loads(SkaData(ref, k=9).map(os.path.join(ref_in, "test_1.fa")))
    assert len("".join(out["Mapped sequences"])) == len(
        "".join(fa["Mapped sequences"])
    )
    assert fa["Number of variants"] - 2 <= out["Number of variants"] <= fa[
        "Number of variants"
    ]
    assert out["Coverage"] > 0.5


def test_aligndata_two_limb_k41(ref_in):
    files = [
        os.path.join(ref_in, "test_1.fa"),
        os.path.join(ref_in, "test_2.fa"),
        os.path.join(ref_in, "test_2_rc.fa"),
    ]
    out = json.loads(AlignData(k=41).align(files))
    # W=2 path: the pair distance walks _combine128; test_2/test_2_rc are
    # rc-identical so their distance is 0 and they join first
    assert "(test_2:" in out["newick"] or "test_2:0" in out["newick"]
    assert out["alignment"].count(">") == 3


def test_nj_newick_float_format_contract():
    """Documented divergence (webapi.py module docstring): branch lengths
    render via Python %.10g formatting, NOT speedytree's Display. This
    pins the exact serialization so it is a contract, not drift."""
    D = np.array(
        [
            [0, 0.5, 0.9, 0.95],
            [0.5, 0, 1.0, 1.05],
            [0.9, 1.0, 0, 0.8],
            [0.95, 1.05, 0.8, 0],
        ]
    )
    assert (
        neighbor_joining(D, list("abcd"))
        == "(a:0.2,b:0.3,(c:0.375,d:0.425):0.325);"
    )
    # negative-zero lengths must serialize as plain "0"
    from ska_tpu.webapi import _fmt_len

    assert _fmt_len(-0.0) == "0"
    assert _fmt_len(-1e-13) == "-1e-13"


def test_aligndata_many_fastq_pairing_contract(tmp_path, ref_in):
    """Documented divergence (webapi.py module docstring): the reference's
    >=3-fastq pairing loop (lib.rs:1309-1384) indexes its index list with
    popped VALUES and panics/mispairs for most inputs; we implement the
    documented intent — greedy first-match pairing by the digit-difference
    test. Pin that behavior on two interleaved pairs + a fasta."""
    import shutil

    fwd = os.path.join(ref_in, "test_1_fwd.fastq.gz")
    rev = os.path.join(ref_in, "test_1_rev.fastq.gz")
    pa1, pa2 = tmp_path / "sampA_1.fq.gz", tmp_path / "sampA_2.fq.gz"
    pb1, pb2 = tmp_path / "sampB_1.fq.gz", tmp_path / "sampB_2.fq.gz"
    for src, dst in ((fwd, pa1), (rev, pa2), (fwd, pb1), (rev, pb2)):
        shutil.copy(src, dst)
    fa = os.path.join(ref_in, "test_1.fa")

    ad = AlignData(k=9)
    out = json.loads(
        ad.align([str(pa1), str(pb1), fa, str(pb2), str(pa2)])
    )
    # each pair collapses to ONE sample named by its first-seen file, in
    # first-seen order, after the fasta samples
    assert out["names"] == ["test_1.fa", "sampA_1.fq.gz", "sampB_1.fq.gz"]
    assert out["alignment"].count(">") == 3
