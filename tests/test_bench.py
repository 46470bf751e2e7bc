"""bench.py and scripts/bench_cmds.py measure the GPU or nothing: with no
card they exit non-zero before measuring, and print no result."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _no_card_env(**extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", SKA_BENCH_CMDS="0")
    env.pop("JAX_PLATFORMS", None)
    env.update(extra)
    return env


@pytest.mark.parametrize("script", ["bench.py", "scripts/bench_cmds.py"])
@pytest.mark.parametrize("platform", [None, "cpu"],
                         ids=["unset", "cpu-requested"])
def test_refuses_to_measure_without_a_gpu(tmp_path, script, platform):
    env = _no_card_env(**({} if platform is None else
                          {"JAX_PLATFORMS": platform, "SKA_PLATFORM": platform}))
    out = tmp_path / "table.json"
    argv = [sys.executable, str(REPO / script)]
    if script != "bench.py":
        argv += ["--json", str(out)]
    r = subprocess.run(argv, capture_output=True, text=True, timeout=300,
                       env=env, cwd=tmp_path)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "kmers/s" not in r.stdout and not out.exists()
