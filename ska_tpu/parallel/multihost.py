"""Multi-host initialization for the distributed build.

The reference is explicitly single-node: its README tells users to split
sample lists into blocks, run `ska build` per block, and `ska merge` the
.skf files by hand (reference README.md:124). Here the same scale-out is
first-class: every process of the deployment calls `init_multihost()`, after
which `jax.devices()` spans all chips and the key-range-repartitioned
merge in ska_tpu.parallel.build runs over the global mesh — the
`all_to_all` exchange rides NVLink within a host and the network across
hosts, and each process owns a contiguous key-range shard of the output rows.

`ska build` auto-selects the mesh path when more than one device is
visible (api.build), so on a multi-host deployment the only extra step
is initializing the process group before invoking the CLI/library:

    SKA_COORDINATOR=host0:8476 SKA_NUM_PROCESSES=4 SKA_PROCESS_ID=$RANK \\
        python -m ska_tpu build -o out -f samples.tsv

(or call init_multihost() programmatically). Host 0 gathers the final
array; other hosts hold their row shards until collected.

This module is thin glue over jax.distributed: single-process runs,
including one process driving every GPU of a host, never import it, and
the virtual-CPU tests exercise the same mesh code path in one process.
"""

import logging
import os

log = logging.getLogger("ska_tpu")


def init_multihost(
    coordinator_address=None, num_processes=None, process_id=None
):
    """Initialize the JAX process group from args or SKA_* env vars.

    No-op (returns False) when no coordinator is configured or only one
    process is requested, so single-host runs need no changes.
    """
    coordinator_address = coordinator_address or os.environ.get("SKA_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("SKA_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        pid = os.environ.get("SKA_PROCESS_ID")
        process_id = int(pid) if pid is not None else None

    if not coordinator_address or num_processes <= 1 or process_id is None:
        return False

    from ..jaxinit import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "multihost: process %d/%d, %d global devices",
        process_id, num_processes, len(jax.devices()),
    )
    return True


def is_primary() -> bool:
    """True on the process that should write outputs (host 0)."""
    from ..jaxinit import jax

    return jax.process_index() == 0
