"""CPU rehearsal of chip_smoke.py: it refuses to run without a card or
outside a checkout, its helpers compare and report exactly, and every
phase runs end to end at tiny sizes on the CPU backend (the device
check lives only in main(), so the phase functions are reachable here).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as C  # noqa: E402

TINY = C.Sizes(genome_len=20_000, n_a=3, n_b=5, read_genome_len=20_000,
               coverage=40, sort_rows=(2, 4096))


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("JAX_PLATFORMS", None)
    return env


def test_refuses_to_run_without_a_gpu():
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       env=_no_card_env(), cwd=REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no CUDA device" in r.stderr


def test_refuses_to_run_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, timeout=300,
                       env=_no_card_env(), cwd=tmp_path)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "checkout" in r.stderr


@pytest.mark.parametrize("count", [1, 4])
def test_final_line_is_exact(count):
    line = C.final_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    f'"kind": "NVIDIA H100 80GB HBM3", "count": {count}}}}}')
    assert json.loads(line)["device"]["count"] == count


def test_same_bytes(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    (a / "eq").write_bytes(b"x" * 100)
    (b / "eq").write_bytes(b"x" * 100)
    (a / "ne").write_bytes(b"x" * 100)
    (b / "ne").write_bytes(b"x" * 99 + b"y")
    (a / "gone").write_bytes(b"")
    assert C.same_bytes(a, b, ["eq", "ne", "gone"]) == {
        "eq": True, "ne": False, "gone": False}


def test_compare_phase_fails_on_any_difference(tmp_path, monkeypatch,
                                               capsys):
    def write(text):
        def run(argv):
            Path(argv[0]).write_text(text)
            return 0.0
        return run

    cmds = [("cmd", lambda o: [o / "out.txt"], "out.txt")]
    monkeypatch.setattr(C, "device_stats", lambda: {})
    monkeypatch.setattr(C, "run_host", write("same"))
    monkeypatch.setattr(C, "run_device", write("same"))
    rec = C.compare_phase("ok_phase", tmp_path, cmds)
    assert rec["identical"] and set(rec["files"]) == {"cold/out.txt",
                                                      "warm/out.txt"}
    monkeypatch.setattr(C, "run_device", write("other"))
    with pytest.raises(RuntimeError, match="differ"):
        C.compare_phase("bad_phase", tmp_path, cmds)
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[-1])["identical"] is False


def test_make_reads_are_paired_fastq_with_qualities(tmp_path):
    from ska_tpu.io import fastx

    lst = C.make_reads(tmp_path, 5_000, 30, seed=1)
    name, r1, r2 = lst.read_text().split()
    assert name == "reads"
    f1, f2 = fastx.read_fastx(r1), fastx.read_fastx(r2)
    n = 30 * 5_000 // 300
    assert f1.is_fastq and len(f1.seqs) == len(f2.seqs) == n
    assert f1.ids[0] == "r00000000/1" and f2.ids[0] == "r00000000/2"
    assert all(len(s) == 150 for s in f1.seqs[:50])
    q = np.frombuffer(b"".join(f1.quals), np.uint8) - 33
    assert q.min() >= 2 and q.max() <= 40
    assert 0.005 < np.mean(q < 20) < 0.05  # the strict filter has work


def test_reference_gram_matches_brute_force():
    from ska_tpu.encoding import ASCII_TO_SET

    rng = np.random.default_rng(0)
    v = rng.choice(np.frombuffer(b"ACGT-N", np.uint8), size=(300, 5))
    c = ASCII_TO_SET[v].astype(np.int64)
    X = np.eye(16, dtype=np.int64)[c].reshape(300, 5 * 16)
    assert np.array_equal(C.reference_gram(v), X.T @ X)


def test_sort_timing_reports_both_sorts():
    out = C.time_sorts((2, 4096), seed=0)
    assert out["rows"] == 8192
    for name in ("dedup_1op", "merged_3op"):
        assert out[name]["cold_s"] > 0 and len(out[name]["warm_runs_s"]) == 3


def test_rehearsal_every_default_phase(tmp_path, capsys):
    """Every default-mode phase, device side on the CPU backend, host
    side through the launcher: all outputs must match byte for byte."""
    C.run_single(tmp_path, 0, TINY)
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    phases = [r["phase"] for r in recs]
    assert phases == ["cohort_a_k31", "cohort_a_k63", "cohort_b", "sorts",
                      "reads", "gram"]
    for r in recs:
        if r["phase"] != "sorts":
            assert r["identical"] is True, r
    reads = next(r for r in recs if r["phase"] == "reads")
    assert (tmp_path / "reads" / "host" / "reads.skf").stat().st_size > 0
    assert set(reads["commands"]["build_fastq"]) == {"host_s", "cold_s",
                                                     "warm_s"}


def test_rehearsal_four_on_virtual_mesh(tmp_path, capsys, monkeypatch):
    """--four's phase on the virtual CPU mesh (the mesh path is forced
    on: the CPU backend never selects it by itself)."""
    monkeypatch.setenv("SKA_DISTRIBUTED", "1")
    C.run_four(tmp_path, 0, TINY)
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["phase"] == "mesh_cohort_b" and rec["identical"] is True
    assert set(rec["commands"]) == {"build", "map_aln", "distance"}


def test_four_refuses_a_single_device(tmp_path, monkeypatch):
    monkeypatch.setenv("SKA_DISTRIBUTED", "0")
    with pytest.raises(RuntimeError, match="mesh path"):
        C.run_four(tmp_path, 0, TINY)


@pytest.mark.gpu
def test_gram_kernels_exact_on_gpu(gpu_device):
    """Both accelerator Gram kernels on the card, against the exact
    integer Gram (HIGHEST must keep the f32 kernel out of TF32)."""
    snippet = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "import chip_smoke as C\n"
        "from ska_tpu import distance as D\n"
        "from ska_tpu.jaxinit import jax\n"
        "assert jax.devices()[0].platform == 'gpu'\n"
        "rng = np.random.default_rng(0)\n"
        "v = rng.choice(np.frombuffer(b'ACGT-', np.uint8), size=(50000, 32))\n"
        "want = C.reference_gram(v)\n"
        "assert np.array_equal(D.class_gram(v, on_host=False), want)\n"
        "D.DEDUP_MAX_SITES = 0\n"
        "assert np.array_equal(D.class_gram(v, on_host=False), want)\n"
        "print('OK')\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", snippet], capture_output=True,
                       text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("OK")
