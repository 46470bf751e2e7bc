"""End-to-end tests of the all-native `ska_host` front-end
(csrc/host_cli.cpp) through the `ska` launcher.

With SKA_PLATFORM=cpu the launcher execs ska_host for
align/distance/map/build, skipping CPython entirely; anything the
front-end cannot handle execs ska.py with the same argv. These tests pin
byte-identity of the all-native route against the python pipeline and
that the fallback really reaches python.

The SKA_PYTHON=/bin/false trick proves native handling: if ska_host had
fallen back to python, the exec of /bin/false would fail the command.

ska_host is not committed: the module fixture builds it from csrc/ (as
the launcher does at first host-mode use). The cases on the reference
repository's fixtures skip where those are absent; the synthetic-cohort
cases run everywhere.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_IN = "/root/reference/tests/test_files_in"
SKA = os.path.join(REPO, "ska")
BIN = os.path.join(REPO, "ska_host")


@pytest.fixture(scope="module", autouse=True)
def host_cli():
    from ska_tpu.io import nativebuild

    assert nativebuild.host_cli() == BIN
    return BIN


@pytest.fixture
def ref_files():
    if not os.path.isdir(REF_IN):
        pytest.skip("needs the reference repository's test fixtures")


def _env(**extra):
    env = dict(os.environ, SKA_PLATFORM="cpu", SKA_PYTHON=sys.executable)
    for k in ("JAX_PLATFORMS", "SKA_THREADS"):
        env.pop(k, None)
    env.update(extra)
    return env


def _run(args, check=True, **extra):
    r = subprocess.run([SKA] + args, env=_env(**extra), capture_output=True,
                       timeout=300)
    if check:
        assert r.returncode == 0, r.stderr[-500:]
    return r


NATIVE_ONLY = {"SKA_PYTHON": "/bin/false"}  # fallback would exit nonzero


CASES = [
    (["align", f"{REF_IN}/merge.skf"], True),
    (["align", f"{REF_IN}/merge_k41.skf", "--filter", "no-ambig",
      "-m", "0.5"], True),
    (["distance", f"{REF_IN}/merge.skf"], True),
    (["distance", f"{REF_IN}/multidist.skf", "--allow-ambiguous"], True),
    (["map", f"{REF_IN}/test_ref.fa", f"{REF_IN}/merge.skf"], True),
    (["map", f"{REF_IN}/test_ref_two_chrom_repeats.fa",
      f"{REF_IN}/merge_k9.skf", "-f", "vcf", "--repeat-mask"], True),
    (["map", f"{REF_IN}/test_ref.fa", f"{REF_IN}/merge_k41.skf",
      "--ambig-mask"], True),
    # implicit build from a plain-FASTA list (io_utils.rs:60-93)
    (["align", f"{REF_IN}/test_1.fa", f"{REF_IN}/test_2.fa"], True),
    (["map", f"{REF_IN}/test_ref.fa", f"{REF_IN}/test_1.fa",
      f"{REF_IN}/test_2.fa"], True),
    (["map", f"{REF_IN}/test_ref.fa", f"{REF_IN}/test_1.fa",
      f"{REF_IN}/test_2.fa", "-f", "vcf"], True),
    (["nk", f"{REF_IN}/merge.skf"], True),
    (["nk", f"{REF_IN}/merge_k41.skf", "--full-info"], True),
    (["nk", f"{REF_IN}/multidist.skf", "--full-info"], True),
]


@pytest.mark.parametrize("args,native", CASES)
def test_stdout_byte_identity_and_native_handling(tmp_path, args, native,
                                                  ref_files):
    got = _run(args, **NATIVE_ONLY).stdout
    want = _run(args, SKA_NATIVE_CMDS="0").stdout
    assert got == want
    assert b"SKA: Split K-mer Analysis" in _run(args).stderr


def test_output_file_and_attached_short_flags(tmp_path, ref_files):
    out = str(tmp_path / "a.aln")
    _run(["align", f"{REF_IN}/merge.skf", "-o" + out, "-m0.9"],
         **NATIVE_ONLY)
    want = _run(["align", f"{REF_IN}/merge.skf", "-m", "0.9"],
                SKA_NATIVE_CMDS="0").stdout
    assert open(out, "rb").read() == want


def test_build_positional_and_filelist(tmp_path, ref_files):
    out_n = str(tmp_path / "n")
    _run(["build", "-o", out_n, "-k", "17", f"{REF_IN}/test_1.fa",
          f"{REF_IN}/test_2.fa"], **NATIVE_ONLY)
    fl = tmp_path / "list.txt"
    fl.write_text(f"test_1\t{REF_IN}/test_1.fa\n"
                  f"test_2\t{REF_IN}/test_2.fa\n")
    out_l = str(tmp_path / "l")
    _run(["build", "-o", out_l, "-k", "17", "-f", str(fl)], **NATIVE_ONLY)
    out_p = str(tmp_path / "p")
    _run(["build", "-o", out_p, "-k", "17", f"{REF_IN}/test_1.fa",
          f"{REF_IN}/test_2.fa"], SKA_NATIVE_CMDS="0")
    n = open(out_n + ".skf", "rb").read()
    assert n == open(out_l + ".skf", "rb").read()
    assert n == open(out_p + ".skf", "rb").read()


def test_weed_and_delete_byte_identity(tmp_path, ref_files):
    import shutil

    base = tmp_path / "base.skf"
    shutil.copy(f"{REF_IN}/merge.skf", base)
    cases = [
        (["weed", str(base), f"{REF_IN}/weed.fa"], "w1"),
        (["weed", str(base), f"{REF_IN}/weed.fa", "--reverse"], "w2"),
        (["weed", str(base), "--filter", "no-ambig-or-const", "-m", "0.5",
          "--ambig-mask"], "w3"),
        (["weed", str(base), f"{REF_IN}/weed.fa",
          "--filter-ambig-as-missing", "--no-gap-only-sites"], "w4"),
        (["delete", "-s", str(base), "test_1"], "d1"),
    ]
    for args, tag in cases:
        out_n = tmp_path / f"{tag}_n.skf"
        out_p = tmp_path / f"{tag}_p.skf"
        _run(args + ["-o", str(out_n)], **NATIVE_ONLY)
        _run(args + ["-o", str(out_p)], SKA_NATIVE_CMDS="0")
        assert out_n.read_bytes() == out_p.read_bytes(), tag


def test_merge_byte_identity(tmp_path, ref_files):
    cases = [
        ([f"{REF_IN}/merge.skf", f"{REF_IN}/merge.skf"], "m1"),
        ([f"{REF_IN}/merge_k9.skf", f"{REF_IN}/multidist.skf"], "m2"),
        ([f"{REF_IN}/multidist.skf", f"{REF_IN}/merge_k9.skf",
          f"{REF_IN}/multidist.skf"], "m3"),
    ]
    for files, tag in cases:
        out_n = tmp_path / f"{tag}_n"
        out_p = tmp_path / f"{tag}_p"
        _run(["merge"] + files + ["-o", str(out_n)], **NATIVE_ONLY)
        _run(["merge"] + files + ["-o", str(out_p)], SKA_NATIVE_CMDS="0")
        assert (tmp_path / f"{tag}_n.skf").read_bytes() == \
               (tmp_path / f"{tag}_p.skf").read_bytes(), tag
    # k mismatch: native declines, python raises the canonical error
    r = _run(["merge", f"{REF_IN}/merge.skf", f"{REF_IN}/merge_k41.skf",
              "-o", str(tmp_path / "bad")], check=False)
    assert r.returncode != 0
    assert b"K-mer lengths do not match" in r.stderr


def test_delete_filelist_and_missing_name(tmp_path, ref_files):
    import shutil

    base = tmp_path / "base.skf"
    shutil.copy(f"{REF_IN}/merge.skf", base)
    fl = tmp_path / "list.txt"
    fl.write_text(f"test_2\t{REF_IN}/test_2.fa\n")
    out_n = tmp_path / "n.skf"
    out_p = tmp_path / "p.skf"
    _run(["delete", "-s", str(base), "-f", str(fl), "-o", str(out_n)],
         **NATIVE_ONLY)
    _run(["delete", "-s", str(base), "-f", str(fl), "-o", str(out_p)],
         SKA_NATIVE_CMDS="0")
    assert out_n.read_bytes() == out_p.read_bytes()
    # unknown sample: native declines, python raises its canonical error
    r = _run(["delete", "-s", str(base), "nosuch", "-o",
              str(tmp_path / "x")], check=False)
    assert r.returncode != 0
    assert b"Could not find sample" in r.stderr


def test_fastq_build_via_launcher(tmp_path, ref_files):
    """FASTQ-pair cohorts (gz) build all-native through ska_host."""
    fl = tmp_path / "pairs.txt"
    fl.write_text(
        f"test_1\t{REF_IN}/test_1_fwd.fastq.gz\t{REF_IN}/test_1_rev.fastq.gz\n"
        f"test_2\t{REF_IN}/test_2_fwd.fastq.gz\t{REF_IN}/test_2_rev.fastq.gz\n")
    out_n = tmp_path / "n"
    out_p = tmp_path / "p"
    args = ["build", "-f", str(fl), "-k", "9", "--min-count", "2",
            "--min-qual", "2"]
    _run(args + ["-o", str(out_n)], **NATIVE_ONLY)
    _run(args + ["-o", str(out_p)], SKA_NATIVE_CMDS="0")
    assert (tmp_path / "n.skf").read_bytes() == \
           (tmp_path / "p.skf").read_bytes()
    # --min-count auto must reach the python coverage-model path
    r = subprocess.run(
        [SKA, "build", "-f", str(fl), "-k", "9", "--min-count", "auto",
         "-o", str(tmp_path / "x")],
        env=_env(SKA_PYTHON="/bin/false"), capture_output=True, timeout=60)
    assert r.returncode != 0  # python (here /bin/false) had to run


def test_fallback_reaches_python(tmp_path, ref_files):
    # -v asks for progress messages, which live in the python pipeline;
    # python must run (SKA_PYTHON=/bin/false then fails)
    r = subprocess.run(
        [SKA, "align", f"{REF_IN}/merge.skf", "-v"],
        env=_env(SKA_PYTHON="/bin/false"), capture_output=True, timeout=60)
    assert r.returncode != 0
    ok = _run(["align", f"{REF_IN}/merge.skf", "-v"])
    want = _run(["align", f"{REF_IN}/merge.skf"]).stdout
    assert ok.stdout == want


def test_fallback_error_messages_come_from_argparse():
    r = _run(["align", f"{REF_IN}/merge.skf", "-m", "1.5"], check=False)
    assert r.returncode != 0
    assert b"Frequency must be between 0 and 1" in r.stderr
    r = _run(["align", f"{REF_IN}/merge.skf", "--bogus-flag"], check=False)
    assert r.returncode != 0
    assert b"unrecognized arguments" in r.stderr


def test_native_cmds_kill_switch_uses_python():
    r = subprocess.run(
        [SKA, "align", f"{REF_IN}/merge.skf"],
        env=_env(SKA_PYTHON="/bin/false", SKA_NATIVE_CMDS="0"),
        capture_output=True, timeout=60)
    assert r.returncode != 0  # python (here /bin/false) had to run


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A reference and four samples at 0.5% SNPs, one with an N run and
    IUPAC codes, and their .skf built on the python route."""
    import numpy as np

    d = tmp_path_factory.mktemp("cohort")
    rng = np.random.default_rng(3)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, size=30_000)
    (d / "ref.fa").write_bytes(b">ref\n" + ref.tobytes() + b"\n")
    samples = []
    for i in range(4):
        g = ref.copy()
        pos = rng.choice(len(g), size=150, replace=False)
        g[pos] = acgt[(np.searchsorted(acgt, g[pos]) + 1) % 4]
        if i == 3:
            g[1000:1040] = ord("N")
            g[5000:5003] = np.frombuffer(b"RYK", np.uint8)
        p = d / f"s{i}.fa"
        p.write_bytes(b">s%d\n" % i + g.tobytes() + b"\n")
        samples.append(str(p))
    skf = str(d / "all")
    _run(["build", "-o", skf, "-k", "31", *samples], SKA_NATIVE_CMDS="0")
    return {"dir": d, "ref": str(d / "ref.fa"), "samples": samples,
            "skf": skf + ".skf"}


SYNTH_CASES = [
    ["align", "{skf}"],
    ["align", "{skf}", "--filter", "no-filter", "-m", "0.5"],
    ["map", "{ref}", "{skf}"],
    ["map", "{ref}", "{skf}", "-f", "vcf"],
    ["distance", "{skf}"],
    ["nk", "{skf}", "--full-info"],
]


@pytest.mark.parametrize("args", SYNTH_CASES, ids=lambda a: "_".join(
    x.strip("{}-") for x in a))
def test_synthetic_cohort_stdout_native_vs_python(cohort, args):
    args = [a.format(**cohort) for a in args]
    got = _run(args, **NATIVE_ONLY).stdout
    assert got and got == _run(args, SKA_NATIVE_CMDS="0").stdout


@pytest.mark.parametrize("k", [17, 63])
def test_synthetic_cohort_build_native_vs_python(cohort, tmp_path, k):
    args = ["build", "-k", str(k), *cohort["samples"]]
    _run(args + ["-o", str(tmp_path / "n")], **NATIVE_ONLY)
    _run(args + ["-o", str(tmp_path / "p")], SKA_NATIVE_CMDS="0")
    assert (tmp_path / "n.skf").read_bytes() == \
           (tmp_path / "p.skf").read_bytes()


def test_synthetic_cohort_merge_and_delete(cohort, tmp_path):
    skf = cohort["skf"]
    for tag, args in (("m", ["merge", skf, skf]),
                      ("d", ["delete", "-s", skf, "s1"])):
        _run(args + ["-o", str(tmp_path / f"{tag}_n")], **NATIVE_ONLY)
        _run(args + ["-o", str(tmp_path / f"{tag}_p")], SKA_NATIVE_CMDS="0")
        assert (tmp_path / f"{tag}_n.skf").read_bytes() == \
               (tmp_path / f"{tag}_p.skf").read_bytes(), tag


def test_launcher_builds_host_cli_at_first_use(tmp_path, cohort):
    """In a tree with no ska_host (as a fresh checkout has), the first
    host-mode command builds it from csrc/ and runs on it."""
    import shutil

    skip = shutil.ignore_patterns("__pycache__", "*.so", "*.lock", "*.tmp",
                                  "ref_baseline")
    for name in ("ska_tpu", "csrc"):
        shutil.copytree(os.path.join(REPO, name), tmp_path / name,
                        ignore=skip)
    for name in ("ska", "ska.py"):
        shutil.copy2(os.path.join(REPO, name), tmp_path / name)
    launcher = str(tmp_path / "ska")
    assert not (tmp_path / "ska_host").exists()
    r = subprocess.run([launcher, "build", "-o", str(tmp_path / "x"), "-k",
                        "31", *cohort["samples"]],
                       env=_env(), capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    assert os.access(tmp_path / "ska_host", os.X_OK)
    assert (tmp_path / "x.skf").read_bytes() == \
           open(cohort["skf"], "rb").read()
    r = subprocess.run([launcher, "nk", str(tmp_path / "x.skf")],
                       env=_env(**NATIVE_ONLY), capture_output=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr[-500:]


def test_version_constant_in_sync():
    """host_cli.cpp hardcodes the .skf ska_version field; it must match
    the package version or launcher-built and python-built files
    diverge."""
    import re

    from ska_tpu import __version__

    src = open(os.path.join(REPO, "csrc", "host_cli.cpp")).read()
    m = re.search(r'SKA_VERSION = "([^"]+)"', src)
    assert m and m.group(1) == __version__
