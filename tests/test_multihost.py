"""True multi-process distributed build: two JAX processes (2 CPU devices
each) joined via jax.distributed — the multi-host topology the reference
has no equivalent of (its README.md:124 says to shard builds by hand).

The single-process 8-device virtual mesh elsewhere in the suite cannot
catch multi-process-only failures: device_put of host arrays to
non-addressable devices, output shards owned by the other process, and
cross-process collectives. This test runs the same input through (a) the
in-process mesh and (b) a real 2-process 4-device cluster and requires
identical results — the global key sort makes the output independent of
device count and process layout.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("min_count", [0, 2])
def test_two_process_distributed_build(tmp_path, min_count):
    from ska_tpu.parallel.build import build_mesh, distributed_merged_build

    rng = np.random.default_rng(7 + min_count)
    S, L, k = 6, 320, 17
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    seqs = rng.choice(bases, size=(S, L), p=[0.24, 0.24, 0.24, 0.24, 0.04])
    is_reads = min_count > 0
    if is_reads:
        # reads: several records per row so the count filter has repeats
        rec_last = np.zeros((S, L), bool)
        rec_last[:, 79::80] = True
        rec_last[:, -1] = True
        # duplicate each row's first read so min_count=2 keeps something
        seqs[:, 80:160] = seqs[:, :80]
    else:
        rec_last = np.zeros((S, L), bool)
        rec_last[:, -1] = True
    valid = (seqs & 0xF) != 14
    qual = np.ones((S, L), bool)

    # expected: single-process virtual mesh (the already-validated path)
    mesh = build_mesh()
    keys, var, cnts, _ = distributed_merged_build(
        seqs, valid, qual, rec_last, k, True, mesh,
        is_reads=is_reads, min_count=min_count,
    )
    np.savez(
        tmp_path / "input.npz",
        seqs=seqs, valid=valid, qual=qual, rec_last=rec_last, k=k,
        is_reads=is_reads, min_count=min_count,
    )
    np.savez(tmp_path / "expected.npz", keys=keys, var=var, cnts=cnts)

    port = _free_port()
    driver = os.path.join(os.path.dirname(__file__), "multihost_driver.py")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, driver, str(pid), str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=420) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    assert (tmp_path / "ok0").exists() and (tmp_path / "ok1").exists()


def test_two_process_cli_build(tmp_path, ref_in):
    """The documented multi-host quick start (parallel/multihost.py): two
    processes run the SAME `ska build` CLI command with SKA_COORDINATOR
    set; the mesh spans both, host 0 alone writes the .skf, and the file
    equals a serial single-process build."""
    port = _free_port()
    out = tmp_path / "mh"
    args = [
        sys.executable, os.path.join(os.path.dirname(__file__), "..", "ska.py"),
        "build", "-o", str(out), "-k", "17",
        os.path.join(ref_in, "test_1.fa"), os.path.join(ref_in, "test_2.fa"),
    ]
    base = dict(os.environ)
    base.pop("JAX_PLATFORMS", None)
    base.update(
        SKA_PLATFORM="cpu",
        SKA_DISTRIBUTED="1",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
        SKA_COORDINATOR=f"localhost:{port}",
        SKA_NUM_PROCESSES="2",
    )
    procs = [
        subprocess.Popen(
            args, env={**base, "SKA_PROCESS_ID": str(pid)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=420) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-2000:]
    assert (tmp_path / "mh.skf").exists()

    from ska_tpu import api
    from ska_tpu.io import skf
    from ska_tpu.sample import QualOpts
    from ska_tpu.constants import QUAL_STRICT

    got = skf.load(str(tmp_path / "mh.skf"))
    ref = api.build(
        [("test_1", os.path.join(ref_in, "test_1.fa"), None),
         ("test_2", os.path.join(ref_in, "test_2.fa"), None)],
        17, True, QualOpts(min_count=0, min_qual=0, qual_filter=QUAL_STRICT),
    )
    assert np.array_equal(got.keys, ref.keys)
    assert np.array_equal(got.variants, ref.variants)
    assert got.names == ref.names
