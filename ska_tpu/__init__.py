"""ska_tpu: split k-mer analysis as data-parallel JAX programs.

A from-scratch reimplementation of the capabilities of SKA2
(bacpop/ska.rust) designed for JAX/XLA on an NVIDIA GPU:

- FASTA/FASTQ parsing to integer sequence tensors (host, C++-accelerated)
- split k-mer extraction as a vectorized windowed kernel in plain JAX
  (replaces the rolling iterator in reference src/ska_dict/split_kmer.rs)
- sort-based segmented merges of packed-key arrays on device
  (replaces hashmaps in reference src/merge_ska_dict.rs)
- data-parallel sample sharding over a jax.sharding.Mesh with
  all_to_all + segmented reduction collectives (replaces rayon)

Capability parity targets the reference CLI: build, align, map, distance,
merge, delete, weed, nk, cov and lo (see reference src/cli.rs:167-426).

This package __init__ is deliberately jax-free: jax is imported (and
configured — x64, platform pin, compile cache, dispatch stats) exactly
once by ska_tpu.jaxinit, which every compute module imports instead of
``import jax``. Host-native command paths (SKA_PLATFORM=cpu with the
csrc engines) therefore never pay the ~2 s jax import.
"""

__version__ = "0.5.2"  # capability parity with reference v0.5.2


def __getattr__(name):
    # lazy: `ska_tpu.encoding` pulls numpy (~0.25 s), which the native
    # host command routes (host_cmds.py -> csrc/host_modes.cpp) never
    # need — an eager import here would hand that startup time back
    if name == "encoding":
        from . import encoding

        return encoding
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
