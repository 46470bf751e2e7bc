"""Build the native host engines from csrc/ at first use.

No build product is committed. Each one is compiled by g++ from the
committed sources when it is missing or older than one of them, into a
private file that is renamed into place under a lock: concurrent users
(test workers, parallel CLI runs) wait for one build, and none loads or
execs a half-written file.

    python ska_tpu/io/nativebuild.py [library] [ska_host]

builds (or refreshes) the ones named, ska_host by default.

Standard library only: the `ska` launcher runs this file before any
package import.
"""

import fcntl
import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(ROOT, "csrc")


def _srcs(*names):
    return [os.path.join(CSRC, f"{n}.cpp") for n in names]


# the ctypes library behind ska_tpu.io.native and ska_tpu.host_cmds
LIBRARY = os.path.join(ROOT, "ska_tpu", "io", "_skanative.so")
LIBRARY_SRCS = _srcs("skanative", "skalo_core", "skalo_snps", "merge_batches",
                     "host_build", "host_modes")
LIBRARY_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-pthread", "-shared"]

# the all-native front-end the `ska` launcher execs in host mode
HOST_CLI = os.path.join(ROOT, "ska_host")
HOST_CLI_SRCS = _srcs("host_cli", "skanative", "host_build", "host_modes",
                      "merge_batches")
HOST_CLI_FLAGS = ["-O3", "-std=c++17", "-pthread"]


def stale(target, srcs) -> bool:
    return not os.path.exists(target) or (
        max(os.path.getmtime(s) for s in srcs) > os.path.getmtime(target))


def build(target, srcs, flags) -> str:
    """Compile `srcs` into `target` unless it is up to date; returns
    `target`. A failed compile raises with the compiler's message."""
    if not stale(target, srcs):
        return target
    with open(target + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not stale(target, srcs):
            return target  # another process built it while this one waited
        tmp = f"{target}.{os.getpid()}.tmp"
        try:
            r = subprocess.run(["g++", *flags, "-o", tmp, *srcs, "-lz"],
                               capture_output=True, text=True)
            if r.returncode:
                raise RuntimeError(f"g++ failed building {target}:\n"
                                   f"{r.stderr[-4000:]}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return target


def library() -> str:
    return build(LIBRARY, LIBRARY_SRCS, LIBRARY_FLAGS)


def host_cli() -> str:
    return build(HOST_CLI, HOST_CLI_SRCS, HOST_CLI_FLAGS)


if __name__ == "__main__":
    import sys

    for name in sys.argv[1:] or ["ska_host"]:
        {"library": library, "ska_host": host_cli}[name]()
