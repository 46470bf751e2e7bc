"""Subprocess driver for test_multihost.py: one of two JAX processes.

Each process owns 2 virtual CPU devices; together they form a 4-device
global mesh connected through jax.distributed (Gloo collectives), the
same topology class as a 2-host cluster. Both processes run the
key-range-repartitioned distributed build and compare the gathered
result against the expected arrays computed single-process by the test.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    pid, port, tmp = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    jax.distributed.initialize(
        f"localhost:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2
    assert len(jax.devices()) == 4

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    import numpy as np

    from ska_tpu.parallel.build import build_mesh, distributed_merged_build

    data = np.load(os.path.join(tmp, "input.npz"))
    mesh = build_mesh()
    keys, var, cnts, n = distributed_merged_build(
        data["seqs"], data["valid"], data["qual"], data["rec_last"],
        int(data["k"]), True, mesh,
        is_reads=bool(data["is_reads"]), min_count=int(data["min_count"]),
    )
    exp = np.load(os.path.join(tmp, "expected.npz"))
    assert np.array_equal(keys, exp["keys"]), "keys mismatch"
    assert np.array_equal(var, exp["var"]), "variants mismatch"
    assert np.array_equal(cnts, exp["cnts"]), "counts mismatch"
    with open(os.path.join(tmp, f"ok{pid}"), "w") as f:
        f.write("ok")


if __name__ == "__main__":
    main()
