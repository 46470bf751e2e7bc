"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Tests never need a GPU: the platform is pinned to cpu through jax.config
(before any backend is initialized), so a host with a card still runs
the suite on the CPU. Multi-chip sharding is validated on forced host
platform devices. Tests that only make sense on the card carry the
`gpu` marker and skip here (see the `gpu_device` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

REF_IN = "/root/reference/tests/test_files_in"
REF_OUT = "/root/reference/tests/test_results_correct"


@pytest.fixture(scope="session")
def ref_in():
    return REF_IN


@pytest.fixture(scope="session")
def ref_out():
    return REF_OUT


@pytest.fixture
def gpu_device():
    """The first CUDA device, or a skip. Decided here, at run time, and
    never at import: every xdist worker must collect the same tests."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices('cuda')[0]; print(d.device_kind)"],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"},
    )
    if r.returncode != 0:
        pytest.skip("needs an NVIDIA GPU (CUDA backend not available)")
    return r.stdout.strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (run with -m gpu on the card)"
    )
