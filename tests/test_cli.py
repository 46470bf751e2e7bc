"""CLI smoke tests (in-process: a subprocess per command would pay the
jax import and compiles again)."""

import io
import sys

import pytest

from ska_tpu.cli import main


def _run(argv, capsys):
    main(argv)
    return capsys.readouterr()


def test_cli_build_align_nk(tmp_path, ref_in, capsys):
    out = str(tmp_path / "basic")
    _run(["build", "-o", out, "-k", "17", f"{ref_in}/test_1.fa", f"{ref_in}/test_2.fa"], capsys)
    import os

    assert os.path.exists(out + ".skf")

    res = _run(["nk", out + ".skf"], capsys)
    assert "k=17" in res.out and "samples=2" in res.out

    aln = str(tmp_path / "basic.aln")
    _run(["align", out + ".skf", "-o", aln], capsys)
    assert open(aln).read().startswith(">test_1\n")


def test_cli_map_vcf(tmp_path, ref_in, capsys):
    vcf = str(tmp_path / "map.vcf")
    _run(
        ["map", f"{ref_in}/test_ref.fa", f"{ref_in}/merge.skf", "-o", vcf, "-f", "vcf"],
        capsys,
    )
    head = open(vcf).read().splitlines()
    assert head[0].startswith("##fileformat=VCFv")
    assert head[1] == "##contig=<ID=fake_ref>"


def test_cli_distance_stdout(ref_in, capsys):
    res = _run(["distance", f"{ref_in}/merge.skf"], capsys)
    assert res.out.startswith("Sample1\tSample2\t")


def test_cli_k_validation(capsys):
    with pytest.raises(SystemExit):
        main(["build", "-o", "x", "-k", "65", "a.fa", "b.fa"])
    with pytest.raises(SystemExit):
        main(["build", "-o", "x", "-k", "8", "a.fa", "b.fa"])


def test_align_n_oracle(tmp_path, ref_in, ref_out, capsys, monkeypatch):
    """N/n skipped in input (reference tests/fasta_input.rs:11-31); also
    checks -o with explicit .skf doesn't get a second suffix."""
    monkeypatch.chdir(tmp_path)
    _run(["build", f"{ref_in}/N_test_1.fa", f"{ref_in}/N_test_2.fa", "-o", "N_test.skf"], capsys)
    import os

    assert os.path.exists("N_test.skf") and not os.path.exists("N_test.skf.skf")
    res = _run(["align", "N_test.skf"], capsys)
    assert res.out == open(f"{ref_out}/align_N.stdout").read()


def test_map_n_oracle(tmp_path, ref_in, ref_out, capsys, monkeypatch):
    """reference tests/fasta_input.rs:34-57."""
    monkeypatch.chdir(tmp_path)
    _run(["build", f"{ref_in}/N_test_1.fa", f"{ref_in}/N_test_2.fa", "-k", "11", "-o", "N_test"], capsys)
    res = _run(["map", f"{ref_in}/test_ref.fa", "N_test.skf"], capsys)
    assert res.out == open(f"{ref_out}/map_N.stdout").read()


def test_k33_oracle(tmp_path, ref_in, ref_out, capsys, monkeypatch):
    """k=33 -> 128-bit keys; nk matches k33.stdout modulo the version line
    (reference tests/align.rs:118-166)."""
    from helpers import var_hash

    monkeypatch.chdir(tmp_path)
    _run(["build", "-o", "build_k33", "-k", "33", f"{ref_in}/test_1.fa", f"{ref_in}/test_2.fa", "-v"], capsys)
    res = _run(["nk", "build_k33.skf", "-v"], capsys)
    got = res.out.splitlines()
    want = open(f"{ref_out}/k33.stdout").read().splitlines()
    assert want[0].startswith("ska_version=") and got[0].startswith("ska_version=")
    assert got[1:] == want[1:]

    res = _run(["align", "build_k33.skf", "-v"], capsys)
    assert var_hash(res.out) == {("C", "T"), ("T", "A")}

    with pytest.raises(SystemExit):
        main(["build", "-o", "x", "-k", "65", f"{ref_in}/test_1.fa", f"{ref_in}/test_2.fa"])


def test_build_min_count_auto(tmp_path, ref_in, capsys, monkeypatch):
    """--min-count auto fits the coverage model; negative count rejected
    (reference tests/fastq_input.rs:513-538)."""
    import os

    monkeypatch.chdir(tmp_path)
    rfile = tmp_path / "reads.txt"
    rfile.write_text(
        f"test_1\t{ref_in}/test_1_fwd.fastq.gz\t{ref_in}/test_1_rev.fastq.gz\n"
        f"test_2\t{ref_in}/test_2_fwd.fastq.gz\t{ref_in}/test_2_rev.fastq.gz\n"
    )
    _run(
        ["build", "-f", str(rfile), "-o", "reads",
         "--min-count", "auto", "-v", "-k", "9", "--min-qual", "2"],
        capsys,
    )
    assert os.path.exists("reads.skf")

    with pytest.raises(SystemExit):
        main(["build", "-f", str(rfile), "-o", "reads",
              "--min-count", "-1", "-v", "-k", "9", "--min-qual", "2"])


def test_cli_threads_pool_notice_and_progress(tmp_path, ref_in, capsys, caplog, monkeypatch):
    """--threads sizes the host-side native pools via SKA_THREADS (the
    reference sizes a rayon pool from the same flag); with -v the build
    shows an indicatif-style progress bar on stderr."""
    import logging as _logging
    import os as _os

    # setenv (not delenv) so monkeypatch snapshots the var and restores
    # the pre-test state at teardown even though the CLI overwrites the
    # value — delenv on an absent var records nothing and the CLI's
    # os.environ write would leak T=4 into every later test
    monkeypatch.setenv("SKA_THREADS", "")
    out = str(tmp_path / "thr")
    caplog.set_level(_logging.INFO, logger="ska_tpu")
    _run(
        ["build", "-v", "--threads", "4", "-o", out, "-k", "17",
         f"{ref_in}/test_1.fa", f"{ref_in}/test_2.fa"],
        capsys,
    )
    _logging.getLogger().handlers.clear()  # undo basicConfig for later tests
    assert any("4-thread pool" in r.message for r in caplog.records)
    assert _os.environ.get("SKA_THREADS") == "4"


def test_cli_threads_flag_beats_env(tmp_path, ref_in, capsys, monkeypatch):
    """An explicit --threads N overrides an inherited SKA_THREADS (and
    --threads 1 resets a lingering value); without the flag the env var
    stands — the log must report the EFFECTIVE pool size either way."""
    import os as _os

    out = str(tmp_path / "prec")
    monkeypatch.setenv("SKA_THREADS", "4")
    _run(
        ["build", "--threads", "1", "-o", out, "-k", "17",
         f"{ref_in}/test_1.fa"],
        capsys,
    )
    assert _os.environ.get("SKA_THREADS") == "1"

    monkeypatch.setenv("SKA_THREADS", "2")
    _run(["nk", out + ".skf"], capsys)  # no --threads flag: env stands
    assert _os.environ.get("SKA_THREADS") == "2"


def test_is_primary_tpu_pod_env(monkeypatch):
    """Only SKA_COORDINATOR runs have secondary processes: the rank
    variables of other cluster managers never make a process secondary,
    and the check never touches the backend."""
    from ska_tpu.cli import _is_primary

    monkeypatch.delenv("SKA_COORDINATOR", raising=False)
    assert _is_primary()
    monkeypatch.setenv("SLURM_PROCID", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "1")
    assert _is_primary()
    # with a coordinator the answer comes from the process group
    monkeypatch.setenv("SKA_COORDINATOR", "localhost:1")
    monkeypatch.setattr("ska_tpu.parallel.is_primary", lambda: False,
                        raising=False)
    assert not _is_primary()


def test_cli_profile_trace(tmp_path, ref_in, capsys, monkeypatch):
    """SKA_PROFILE=<dir> wraps the command in a JAX profiler trace."""
    import glob

    monkeypatch.setenv("SKA_PROFILE", str(tmp_path / "trace"))
    _run(["nk", f"{ref_in}/merge.skf"], capsys)
    assert glob.glob(str(tmp_path / "trace" / "plugins" / "profile" / "*" / "*.xplane.pb"))


def test_ska_platform_env_pins_backend():
    """SKA_PLATFORM=cpu must pin the JAX platform even when a GPU is the
    default backend. The pin lives in ska_tpu.jaxinit,
    the single gateway every compute module imports jax through (plain
    `import ska_tpu` is deliberately jax-free so host-native commands
    skip the runtime import entirely)."""
    import os
    import subprocess

    env = dict(os.environ, SKA_PLATFORM="cpu")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, ska_tpu; assert 'jax' not in sys.modules, "
         "'import ska_tpu must stay jax-free'; "
         "from ska_tpu.jaxinit import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.strip().splitlines()[-1] == "cpu"


def test_build_proportion_reads_oracle(tmp_path, ref_in, ref_out, capsys, monkeypatch):
    """--proportion-reads subsamples records (FASTA too): step=round(1/p),
    keep every step-th record per file (reference tests/align.rs:33-60,
    src/ska_dict.rs:125-141); oracle proportion_reads.stdout."""
    monkeypatch.chdir(tmp_path)
    _run(
        [
            "build", "-k", "17", "--single-strand",
            "-o", "build_proportion_reads",
            f"{ref_in}/proportion_reads.fa",
            "--proportion-reads", "0.5",
        ],
        capsys,
    )
    res = _run(["nk", "build_proportion_reads.skf", "--full-info"], capsys)
    from tests.test_skf_ops import _match_wildcard

    with open(f"{ref_out}/proportion_reads.stdout") as f:
        _match_wildcard(res.out, f.read())


def test_launcher_routes_dispatch_free_commands(tmp_path):
    """The `ska` launcher must pin SKA_PLATFORM=cpu for dispatch-free
    subcommands (align/nk/merge/delete/weed/lo) BEFORE Python starts, so
    they never bring up the GPU runtime; pass device-dispatching commands
    (build/map/distance/cov) through untouched; never override an
    explicit SKA_PLATFORM; and leave the rest of the environment
    (JAX_PLATFORMS included) as the caller set it."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # SKA_PYTHON shim: prints the env the launcher execs Python with
    shim = tmp_path / "fakepy"
    shim.write_text(
        "#!/bin/sh\n"
        'echo "JP=${JAX_PLATFORMS-UNSET} PLAT=${SKA_PLATFORM-UNSET}"\n'
    )
    shim.chmod(0o755)

    def launch(cmd, platform=None):
        env = dict(os.environ, SKA_PYTHON=str(shim), JAX_PLATFORMS="cuda",
                   SKA_NATIVE_CMDS="0")
        env.pop("SKA_PLATFORM", None)
        if platform is not None:
            env["SKA_PLATFORM"] = platform
        r = subprocess.run([os.path.join(repo, "ska"), cmd, "x"],
                           capture_output=True, text=True, timeout=60, env=env)
        assert r.returncode == 0, r.stderr
        return r.stdout.strip()

    for cmd in ("align", "nk", "merge", "delete", "weed", "lo"):
        assert launch(cmd) == "JP=cuda PLAT=cpu", cmd
    for cmd in ("build", "map", "distance", "cov"):
        assert launch(cmd) == "JP=cuda PLAT=UNSET", cmd
    # explicit SKA_PLATFORM always wins: no routing, env untouched
    assert launch("align", platform="cuda") == "JP=cuda PLAT=cuda"
    assert launch("build", platform="cpu") == "JP=cuda PLAT=cpu"
    with open(os.path.join(repo, "ska")) as f:
        assert "PALLAS" not in f.read()  # no remote-backend env handling


def test_launcher_runs_real_cli(tmp_path, ref_in):
    """End-to-end through the launcher: align on a routed (jax-free)
    path produces output and exits 0."""
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("SKA_PLATFORM", None)
    env["SKA_PYTHON"] = sys.executable
    out = tmp_path / "o.aln"
    r = subprocess.run(
        [os.path.join(repo, "ska"), "align", f"{ref_in}/merge.skf",
         "-o", str(out)],
        capture_output=True, timeout=300, env=env, cwd=repo,
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert out.exists() and out.stat().st_size > 0


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_compile_cache_placement(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is where compiled programs
    land (and the package sets no other directory); unset, they land in
    one fixed, git-ignored directory inside the checkout."""
    import os
    import subprocess
    import uuid

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("SKA_PLATFORM", None)
    if env_set:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    else:
        want = os.path.join(repo, ".jax_cache")
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
    before = set(os.listdir(want)) if os.path.isdir(want) else set()
    salt = uuid.uuid4().int % 1_000_003  # a program no earlier run compiled
    r = subprocess.run(
        [sys.executable, "-c",
         "from ska_tpu.jaxinit import jax, jnp, CACHE_DIR\n"
         "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
         f"jax.jit(lambda x: x * {salt} + 1)(jnp.arange(7)).block_until_ready()\n"
         "print(jax.config.jax_compilation_cache_dir)\n"
         "print(CACHE_DIR)\n"],
        capture_output=True, text=True, timeout=300, env=env, cwd=repo,
    )
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout.split() == [want, want]
    assert set(os.listdir(want)) - before, "nothing was cached there"
    if not env_set:
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
