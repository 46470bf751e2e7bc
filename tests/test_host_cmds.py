"""Differential tests: the native host command engines (csrc/host_modes.cpp
via ska_tpu.host_cmds) must be byte-identical to the canonical python
pipeline for `ska align` and `ska distance` across fixtures and flags.
"""

import io
import os
import subprocess
import sys

import pytest

from ska_tpu import api
from ska_tpu.io import skf
from ska_tpu import host_cmds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF_IN = "/root/reference/tests/test_files_in"
FIXTURES = ["merge.skf", "merge_k41.skf", "merge_k9.skf", "multidist.skf"]


def _py_align(path, min_freq, filt, ambig_missing, mask, no_gaps):
    arr = skf.load(path)
    fh = io.BytesIO()
    api.align(arr, fh, filter_type=filt, ambig_mask=mask,
              ignore_const_gaps=no_gaps, min_freq=min_freq,
              filter_ambig_as_missing=ambig_missing)
    return fh.getvalue()


def _py_distance(path, min_freq, allow_ambig):
    arr = skf.load(path)
    fh = io.StringIO()
    api.distance_mode(arr, fh, min_freq, not allow_ambig)
    return fh.getvalue().encode()


def _native(tmp_path, fn, path, *args):
    lib = host_cmds._load()
    out = str(tmp_path / "native.out").encode()
    rc = fn(lib)(path.encode(), out, *args)
    assert rc == 0, f"native engine returned {rc} for {path} {args}"
    return open(tmp_path / "native.out", "rb").read()


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize(
    "min_freq,filt,ambig_missing,mask,no_gaps",
    [
        (0.9, "no-const", False, False, False),      # align defaults
        (0.0, "no-filter", False, False, False),
        (0.5, "no-ambig", False, True, False),
        (1.0, "no-ambig-or-const", True, False, True),
        (0.75, "no-const", True, True, True),
    ],
)
def test_align_native_matches_python(tmp_path, fixture, min_freq, filt,
                                     ambig_missing, mask, no_gaps):
    path = f"{REF_IN}/{fixture}"
    want = _py_align(path, min_freq, filt, ambig_missing, mask, no_gaps)
    mode = host_cmds._FILTER_MODE[filt]
    got = _native(tmp_path, lambda lib: lib.ska_host_align, path,
                  float(min_freq), mode, int(ambig_missing), int(mask),
                  int(no_gaps))
    assert got == want


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("min_freq,allow_ambig",
                         [(0.0, False), (0.0, True), (0.5, False),
                          (0.3, True), (1.0, False)])
def test_distance_native_matches_python(tmp_path, fixture, min_freq,
                                        allow_ambig):
    path = f"{REF_IN}/{fixture}"
    want = _py_distance(path, min_freq, allow_ambig)
    got = _native(tmp_path, lambda lib: lib.ska_host_distance, path,
                  float(min_freq), int(not allow_ambig))
    assert got == want


def test_distance_matches_reference_golden(tmp_path):
    got = _native(tmp_path, lambda lib: lib.ska_host_distance,
                  f"{REF_IN}/merge.skf", 0.0, 1)
    want = open("/root/reference/tests/test_results_correct/"
                "merge.dist.stdout", "rb").read()
    assert got == want


def test_cli_routes_native_and_falls_back(tmp_path):
    """End-to-end through the CLI: the native route must engage on the
    pinned host backend (no numpy import) and SKA_NATIVE_CMDS=0 must
    produce identical bytes via the python pipeline."""
    env = dict(os.environ, SKA_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    out_n, out_p = tmp_path / "n.tsv", tmp_path / "p.tsv"
    probe = (
        "import sys; sys.argv=['ska','distance',%r,'-o',%r];"
        "import ska_tpu.cli as c; c.main();"
        "assert 'numpy' %s sys.modules, sys.modules.keys()"
    )
    subprocess.run(
        [sys.executable, "-c",
         probe % (f"{REF_IN}/merge.skf", str(out_n), "not in")],
        check=True, env=env, cwd=REPO, capture_output=True)
    subprocess.run(
        [sys.executable, "-c",
         probe % (f"{REF_IN}/merge.skf", str(out_p), "in")],
        check=True, env={**env, "SKA_NATIVE_CMDS": "0"}, cwd=REPO,
        capture_output=True)
    assert out_n.read_bytes() == out_p.read_bytes()


def test_cli_inprocess_routes_all_native_cmds(tmp_path):
    """Every natively-routed subcommand must survive the in-process CLI
    arg shapes (r5 regression: nk has no args.output and the shared
    prologue crashed instead of routing)."""
    env = dict(os.environ, SKA_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    import shutil

    base = tmp_path / "b.skf"
    shutil.copy(f"{REF_IN}/merge.skf", base)
    cmds = [
        ["nk", str(base)],
        ["nk", str(base), "--full-info"],
        ["weed", str(base), f"{REF_IN}/weed.fa", "-o",
         str(tmp_path / "w.skf")],
        ["delete", "-s", str(base), "test_1", "-o", str(tmp_path / "d")],
        ["merge", str(base), f"{REF_IN}/merge.skf", "-o",
         str(tmp_path / "m")],
    ]
    for argv in cmds:
        outs = {}
        for nc in ("1", "0"):
            r = subprocess.run(
                [sys.executable, os.path.join(REPO, "ska.py")] + argv,
                env={**env, "SKA_NATIVE_CMDS": nc}, capture_output=True,
                timeout=120)
            assert r.returncode == 0, (argv, nc, r.stderr[-400:])
            assert b"Traceback" not in r.stderr, (argv, nc)
            outs[nc] = r.stdout
        assert outs["1"] == outs["0"], argv


def test_native_route_skipped_off_host():
    """Without the cpu pin the native route must decline (device runs
    keep the accelerator pipeline)."""
    saved = os.environ.pop("SKA_PLATFORM", None)
    try:
        class A:  # minimal args shim
            output = None
        assert host_cmds.try_run("distance", A()) is False
    finally:
        if saved is not None:
            os.environ["SKA_PLATFORM"] = saved


def test_native_rejects_malformed(tmp_path):
    bad = tmp_path / "bad.skf"
    bad.write_bytes(b"\xffnot an skf at all")
    lib = host_cmds._load()
    rc = lib.ska_host_distance(str(bad).encode(),
                               str(tmp_path / "o").encode(), 0.0, 1)
    assert rc != 0


@pytest.mark.parametrize("fixture", FIXTURES + ["test_skalo.skf"])
def test_native_save_byte_identical(tmp_path, fixture):
    """ska_host_save must produce the exact bytes of the python encoder
    (CBOR field order, minimal heads, ciborium bignums, 64 KiB framing)."""
    from ska_tpu.io import native

    arr = skf.load(f"{REF_IN}/{fixture}")
    p_native = str(tmp_path / "n.skf")
    p_python = str(tmp_path / "p.skf")
    assert native.skf_save(p_native, arr.keys, arr.variants, arr.counts,
                           arr.names, arr.k, arr.rc, arr.ska_version)
    # force the python encoder
    import ska_tpu.io.skf as skf_mod

    saved = native.skf_save
    try:
        native.skf_save = lambda *a, **kw: False
        skf_mod.save(arr, p_python, add_suffix=False)
    finally:
        native.skf_save = saved
    assert open(p_native, "rb").read() == open(p_python, "rb").read()
    # and the round trip loads back equal
    back = skf.load(p_native)
    import numpy as np

    assert np.array_equal(np.asarray(back.keys), np.asarray(arr.keys))
    assert np.array_equal(back.variants, arr.variants)
    assert back.names == arr.names and back.k == arr.k


@pytest.mark.parametrize("k", [17, 41])
def test_native_build_files_byte_identical(tmp_path, k):
    """ska_host_build_files (C FASTA parse -> build engine -> native
    save) must write the exact .skf bytes of the python build route."""
    lib = host_cmds._load()
    f1 = f"{REF_IN}/test_1.fa"
    f2 = f"{REF_IN}/test_2.fa"
    p_native = str(tmp_path / "n.skf")
    paths = b"\x00".join([f1.encode(), f2.encode()])
    names = b"\x00".join([b"test_1", b"test_2"])
    from ska_tpu import __version__

    ver = __version__.encode()
    rc = lib.ska_host_build_files(p_native.encode(), paths, len(paths), 2,
                                  names, len(names), k, 1, ver, len(ver))
    assert rc == 0
    # python route (native CLI path disabled end to end)
    from ska_tpu.io import fastx
    from ska_tpu.sampletypes import QualOpts
    from ska_tpu.constants import (DEFAULT_MINCOUNT, DEFAULT_MINQUAL,
                                   QUAL_STRICT)

    arr = api.build(fastx.read_input_fastas([f1, f2]), k, True,
                    QualOpts(min_count=DEFAULT_MINCOUNT,
                             min_qual=DEFAULT_MINQUAL,
                             qual_filter=QUAL_STRICT))
    p_python = str(tmp_path / "p.skf")
    skf.save(arr, p_python, add_suffix=False)
    assert open(p_native, "rb").read() == open(p_python, "rb").read()


def test_native_build_declines_fastq_and_gz(tmp_path):
    lib = host_cmds._load()
    for bad in ["test_1_fwd.fastq.gz", "test_1.fa.gz"]:
        src = f"{REF_IN}/{bad}"
        if not os.path.exists(src):
            continue
        paths = src.encode()
        rc = lib.ska_host_build_files(
            str(tmp_path / "o.skf").encode(), paths, len(paths), 1,
            b"x", 1, 17, 1, b"v", 1)
        assert rc != 0


def test_name_regexes_match_fastx():
    """host_cmds cannot import fastx (numpy); its copied name-stripping
    regexes must stay identical."""
    from ska_tpu.io import fastx

    assert host_cmds._RE_PATH.pattern == fastx._RE_PATH.pattern
    assert host_cmds._RE_NAME.pattern == fastx._RE_NAME.pattern


def test_auto_rebuild_srcs_complete():
    """io/nativebuild.py auto-rebuilds the .so when csrc/ is newer; its
    source list must cover every library .cpp or a stale-source rebuild
    strips symbols and disables ALL native acceleration (r5 incident: a
    bench subprocess rebuilt without host_modes.cpp and the import of
    io.native failed outright). The launcher's staleness check for
    ska_host must name the same sources as its build."""
    import glob
    import re

    from ska_tpu.io import nativebuild

    def names(paths):
        return {os.path.basename(p) for p in paths}

    all_srcs = names(glob.glob(os.path.join(nativebuild.CSRC, "*.cpp")))
    # ref_baseline is the bench proxy binary and host_cli the standalone
    # ska_host front-end — both have main()s, neither is library source
    assert all_srcs - {"ref_baseline.cpp", "host_cli.cpp"} == \
        names(nativebuild.LIBRARY_SRCS)
    launcher = open(os.path.join(REPO, "ska")).read()
    checked = re.search(r"for s in ([a-z_ ]+); do", launcher).group(1)
    assert {f"{s}.cpp" for s in checked.split()} == \
        names(nativebuild.HOST_CLI_SRCS)


# ---- ska map native engine (r5: csrc/host_modes.cpp host_map_impl) --------

def _py_map(path, ref_fa, fmt, ambig_mask, repeat_mask):
    arr = skf.load(path)
    if fmt == "aln":
        fh = io.BytesIO()
        api.map_mode(arr, ref_fa, fh, "aln", ambig_mask, repeat_mask)
        return fh.getvalue()
    fh = io.StringIO()
    api.map_mode(arr, ref_fa, fh, "vcf", ambig_mask, repeat_mask)
    return fh.getvalue().encode()


def _native_map(tmp_path, skf_path, ref_fa, fmt, ambig_mask, repeat_mask):
    lib = host_cmds._load()
    out = str(tmp_path / "native_map.out").encode()
    rc = lib.ska_host_map(ref_fa.encode(), skf_path.encode(), out,
                          int(fmt == "vcf"), int(ambig_mask),
                          int(repeat_mask))
    assert rc == 0, f"ska_host_map returned {rc} for {skf_path} {ref_fa}"
    return open(tmp_path / "native_map.out", "rb").read()


MAP_CASES = [
    ("merge.skf", "test_ref.fa", "aln", False, False),
    ("merge_k9.skf", "test_ref.fa", "aln", True, False),
    ("merge_k9.skf", "test_ref.fa", "aln", False, True),
    ("merge.skf", "test_ref_two_chrom.fa", "aln", False, False),
    ("merge_k41.skf", "test_ref.fa", "aln", False, False),  # W=2 bignums
    ("merge_k9.skf", "test_ref_two_chrom_repeats.fa", "aln", False, True),
    ("merge.skf", "test_ref.fa", "vcf", False, False),
    ("merge.skf", "test_ref_two_chrom.fa", "vcf", False, False),
    ("merge_k41.skf", "test_ref.fa", "vcf", False, False),
    ("merge_k9.skf", "test_ref_two_chrom_repeats.fa", "vcf", False, True),
    ("multidist.skf", "test_ref.fa", "aln", False, False),
]


@pytest.mark.parametrize("fixture,ref,fmt,mask,rep", MAP_CASES)
def test_map_native_matches_python(tmp_path, fixture, ref, fmt, mask, rep):
    path = f"{REF_IN}/{fixture}"
    want = _py_map(path, f"{REF_IN}/{ref}", fmt, mask, rep)
    got = _native_map(tmp_path, path, f"{REF_IN}/{ref}", fmt, mask, rep)
    assert got == want


def test_map_native_unsorted_keys(tmp_path):
    """A .skf whose rows are NOT in key order must take the permutation
    path (saved files are sorted, so this needs a hand-shuffled file)."""
    import numpy as np

    arr = skf.load(f"{REF_IN}/merge.skf")
    rng = np.random.default_rng(7)
    perm = rng.permutation(arr.ksize)
    arr.keys = np.ascontiguousarray(arr.keys[perm])
    arr.variants = np.ascontiguousarray(arr.variants[perm])
    arr.counts = np.ascontiguousarray(np.asarray(arr.counts)[perm])
    shuffled = str(tmp_path / "shuffled.skf")
    skf.save(arr, shuffled, add_suffix=False)
    ref_fa = f"{REF_IN}/test_ref.fa"
    want = _py_map(shuffled, ref_fa, "aln", False, False)
    got = _native_map(tmp_path, shuffled, ref_fa, "aln", False, False)
    assert got == want


def test_map_native_thread_invariance(tmp_path):
    saved = os.environ.get("SKA_THREADS")
    try:
        os.environ["SKA_THREADS"] = "1"
        one = _native_map(tmp_path, f"{REF_IN}/merge.skf",
                          f"{REF_IN}/test_ref.fa", "aln", False, False)
        os.environ["SKA_THREADS"] = "4"
        four = _native_map(tmp_path, f"{REF_IN}/merge.skf",
                           f"{REF_IN}/test_ref.fa", "aln", False, False)
    finally:
        if saved is None:
            os.environ.pop("SKA_THREADS", None)
        else:
            os.environ["SKA_THREADS"] = saved
    assert one == four


def test_map_native_declines_zero_hits(tmp_path):
    """A reference sharing no k-mers with the .skf must return nonzero so
    the python route raises the reference's 'No split k-mers mapped'
    error (ska_ref.rs:557)."""
    alien = tmp_path / "alien_ref.fa"
    alien.write_bytes(b">alien\n" + b"A" * 200 + b"\n")
    lib = host_cmds._load()
    rc = lib.ska_host_map(str(alien).encode(),
                          f"{REF_IN}/merge.skf".encode(),
                          str(tmp_path / "o").encode(), 0, 0, 0)
    assert rc != 0


# ---- FASTQ-capable native build (r5: ska_host_build_files2) ---------------

def _native_build2(tmp_path, pairs, names, k, qf, min_qual, min_count):
    lib = host_cmds._load()
    out = str(tmp_path / "n2.skf")
    p1 = b"\x00".join(p[0].encode() for p in pairs)
    p2 = b"\x00".join((p[1] or "").encode() for p in pairs)
    nm = b"\x00".join(n.encode() for n in names)
    rc = lib.ska_host_build_files2(
        out.encode(), p1, len(p1), p2, len(p2), len(pairs), nm, len(nm),
        k, 1, qf, min_qual, min_count, b"v", 1)
    assert rc == 0, f"build_files2 rc={rc}"
    return out


FASTQ_CASES = [
    # (k, fixture prefix, qual_filter, min_qual, min_count)
    (9, "test", 2, 2, 2),
    (7, "test_count", 2, 20, 1),
    (7, "test_count", 2, 20, 3),
    (9, "test", 1, 10, 2),
    (9, "test", 0, 20, 1),
    (63, "test_long", 2, 20, 1),   # u128 whole-k-mer count keys
    (63, "test_long", 2, 20, 3),
]


@pytest.mark.parametrize("k,prefix,qf,mq,mc", FASTQ_CASES)
def test_fastq_build_native_matches_python(tmp_path, k, prefix, qf, mq, mc):
    """The quality-gated, count-filtered FASTQ build engine must produce
    the exact .skf of the canonical pipeline (gz decode, PHRED gates,
    whole-k-mer min-count rank filter, pair batching)."""
    from ska_tpu.constants import QUAL_FILTER_NAMES

    pairs = [(f"{REF_IN}/{prefix}_1_fwd.fastq.gz",
              f"{REF_IN}/{prefix}_1_rev.fastq.gz"),
             (f"{REF_IN}/{prefix}_2_fwd.fastq.gz",
              f"{REF_IN}/{prefix}_2_rev.fastq.gz")]
    names = [f"{prefix}_1", f"{prefix}_2"]
    out_n = _native_build2(tmp_path, pairs, names, k, qf, mq, mc)

    from ska_tpu.sample import QualOpts

    qf_name = {v: n for n, v in QUAL_FILTER_NAMES.items()}[qf]
    files = [(names[i], pairs[i][0], pairs[i][1]) for i in range(2)]
    arr = api.build(files, k, True,
                    QualOpts(min_count=mc, min_qual=mq, qual_filter=qf))
    out_p = str(tmp_path / "p2.skf")
    # python encoder with the same version string as the native call
    arr.ska_version = "v"
    skf.save(arr, out_p, add_suffix=False)
    assert open(out_n, "rb").read() == open(out_p, "rb").read(), qf_name


def test_fastq_build_mixed_fasta_sample(tmp_path):
    """A cohort mixing a FASTA sample with a FASTQ pair: quality/count
    machinery applies per sample (is_reads per ska_dict.rs:357-366)."""
    pairs = [(f"{REF_IN}/test_1.fa", None),
             (f"{REF_IN}/test_2_fwd.fastq.gz",
              f"{REF_IN}/test_2_rev.fastq.gz")]
    names = ["test_1", "test_2"]
    out_n = _native_build2(tmp_path, pairs, names, 9, 2, 2, 2)

    from ska_tpu.sample import QualOpts

    files = [(names[i], pairs[i][0], pairs[i][1]) for i in range(2)]
    arr = api.build(files, 9, True,
                    QualOpts(min_count=2, min_qual=2, qual_filter=2))
    arr.ska_version = "v"
    out_p = str(tmp_path / "p2.skf")
    skf.save(arr, out_p, add_suffix=False)
    assert open(out_n, "rb").read() == open(out_p, "rb").read()


def test_fastq_build_declines_malformed(tmp_path):
    lib = host_cmds._load()
    bad = tmp_path / "bad.fastq"
    bad.write_bytes(b"@r1\nACGT\n+\nII\n")  # qual/seq length mismatch
    p1 = str(bad).encode()
    rc = lib.ska_host_build_files2(
        str(tmp_path / "o.skf").encode(), p1, len(p1), b"", 0, 1,
        b"x", 1, 9, 1, 2, 20, 1, b"v", 1)
    assert rc != 0
