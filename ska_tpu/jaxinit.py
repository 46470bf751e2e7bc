"""The package's single JAX entry point.

Importing this module imports jax and applies the package-wide
configuration exactly once: 64-bit types, the SKA_PLATFORM pin, the
persistent compilation cache, and the SKA_DISPATCH_STATS jit wrapper.
Every ska_tpu module takes jax via ``from .jaxinit import jax, jnp``
(never ``import jax`` directly), which keeps the configuration ordering
correct AND lets host-native command paths (SKA_PLATFORM=cpu with the
csrc engines) skip the ~2 s jax import entirely — the reference is a
native binary whose fixed startup cost is milliseconds, so the CLI
paths that never touch the accelerator should not pay an accelerator
runtime import.
"""

import os

import jax

# Packed split k-mer keys for k<=31 need up to 60 bits; enable 64-bit types
# before any jax.numpy use (reference uses u64/u128, src/lib.rs:592-622).
jax.config.update("jax_enable_x64", True)

# SKA_PLATFORM=cpu|cuda|... pins the JAX platform for the whole toolchain.
# SKA_PLATFORM=cpu is the explicit host mode: the CLI routes to the native
# host engines and never touches a GPU. Without it JAX picks its default
# backend (the GPU where one is visible; JAX_PLATFORMS=cuda makes a
# missing or broken card an error).
_platform = os.environ.get("SKA_PLATFORM", "")
if _platform:
    jax.config.update("jax_platforms", _platform)

# Persistent XLA compilation cache: a fresh CLI process otherwise pays
# for compiling the build pipeline per shape. JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only when it is unset does the cache
# go to one fixed directory inside the checkout (the path is part of the
# cache key, so it must not move between runs). `.gitignore` lists it.
CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# SKA_DISPATCH_STATS=1: count jit dispatches (each is one host->device
# round trip) and backend compiles, printed as one stderr line at exit —
# `SKA_DISPATCH_STATS {"dispatches": N, ...}`. Bench tooling (scripts/bench_cmds.py) parses it so per-command dispatch
# counts are artifact-visible. Wrapping jax.jit here (before any ska_tpu
# module binds it) covers every jitted entry point in the package.
if os.environ.get("SKA_DISPATCH_STATS"):
    import atexit as _atexit
    import functools as _functools
    import json as _json
    import sys as _sys

    _dispatch_stats = {"jit_dispatches": 0, "backend_compiles": 0}
    _orig_jit = jax.jit

    def _counting_jit(fun=None, **kw):
        def wrap(f):
            jitted = _orig_jit(f, **kw)

            @_functools.wraps(f)
            def call(*a, **k):
                _dispatch_stats["jit_dispatches"] += 1
                return jitted(*a, **k)

            call.lower = jitted.lower
            return call

        return wrap if fun is None else wrap(fun)

    jax.jit = _counting_jit
    try:  # compile counts ride jax's own monitoring events (best effort)
        from jax._src import monitoring as _monitoring

        def _on_duration(event, duration, **kw):  # noqa: ARG001
            if "compile" in event:
                _dispatch_stats["backend_compiles"] += 1

        _monitoring.register_event_duration_secs_listener(_on_duration)
    except Exception:  # noqa: BLE001 - stats are diagnostics only
        pass

    _atexit.register(
        lambda: print(
            "SKA_DISPATCH_STATS " + _json.dumps(_dispatch_stats),
            file=_sys.stderr,
        )
    )

import jax.numpy as jnp  # noqa: E402  (after config on purpose)

__all__ = ["jax", "jnp"]
