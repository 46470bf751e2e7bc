"""Multi-device (mesh) build and merge.

The reference parallelizes with rayon threads on one node only
(src/merge_ska_dict.rs:264-326; README tells users to shard builds by hand
and `ska merge` the outputs). Here samples are sharded data-parallel over a
jax.sharding.Mesh and the global dictionary merge is a key-range
repartitioned sample sort: local per-sample pipelines, quantile splitter
selection, all_to_all exchange by key range, and per-device bucket merges,
with the output row space (key space) sharded across devices.

Submodule re-exports are lazy (module __getattr__): importing this package
for `use_distributed` alone must stay jax-free, or every host-native
command path (e.g. `SKA_PLATFORM=cpu ska map`) pays the ~2 s jax import
for a policy check that usually answers from the environment.
"""

_LAZY = {
    "build_mesh": "build",
    "distributed_build": "build",
    "distributed_build_multi": "build",
    "distributed_merged_build": "build",
    "dryrun_step": "build",
    "init_multihost": "multihost",
    "is_primary": "multihost",
    "postbuild": None,  # submodule itself
}

__all__ = ["use_distributed", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name] or name}", __name__)
        value = mod if _LAZY[name] is None else getattr(mod, name)
        globals()[name] = value  # cache: next access skips __getattr__
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def use_distributed() -> bool:
    """Shared mesh-path policy: SKA_DISTRIBUTED=1 forces on with >1
    device (e.g. the virtual CPU mesh), =0 forces off, default auto =
    on for multi-chip accelerator backends (same gate api.build uses).

    Answers from the environment without importing jax whenever it can
    (host pin, or auto mode with no multi-chip hints): the jax import
    plus backend probe cost ~2 s on host-native command paths that will
    never distribute anyway.
    """
    import os

    flag = os.environ.get("SKA_DISTRIBUTED", "auto")
    if flag == "0":
        return False
    if flag == "auto" and os.environ.get("SKA_PLATFORM") == "cpu":
        # pinned host mode can never be a multi-chip accelerator backend;
        # deciding from the env keeps host-native commands jax-free
        # (an explicit =1 still probes: multi-process tests pin cpu AND force
        # the mesh path on the virtual device mesh)
        return False
    from ..jaxinit import jax

    n_dev = len(jax.devices())
    plat = jax.devices()[0].platform
    return flag == "1" and n_dev > 1 or (
        flag == "auto" and n_dev > 1 and plat != "cpu"
    )
