"""Multi-host launch: ``jax.distributed`` initialization + process info.

The reference is strictly single-process (SURVEY.md §2.6: no NCCL/Gloo/MPI
anywhere; ``utils/logger.py:15-19`` carries an always-0 rank).  This module
is the launch layer for runs that span hosts: each host process calls
:func:`initialize` before touching devices, after which ``jax.devices()``
is the *global* device set, meshes built by ``parallel.mesh.make_mesh``
span all hosts, and XLA lowers collectives onto NCCL (NVLink inside a
host, the network between hosts).  Input pipelines use
:func:`process_info` to read their per-process shard
(``data.loader.Loader(process_index, process_count)``), and batches are
assembled into global arrays with :func:`make_global_batch`.

One process drives every GPU of its host, so a single-host run on four
cards needs no distributed initialization at all: omit the
``distributed`` block and the env vars, and ``parallel: {data, graph}``
meshes the local devices.

Launch (one process per host), e.g.::

    DSTDGCN_COORDINATOR=host0:1234 DSTDGCN_NUM_PROCESSES=2 \
    DSTDGCN_PROCESS_ID=0 python main.py --config ... --run_dir ...

or via the config block::

    parallel:
      distributed:
        coordinator: host0:1234
        num_processes: 2
        process_id: 0              # usually from the env instead

Nothing on a GPU cluster tells JAX the topology, so ``coordinator``,
``num_processes`` and ``process_id`` must all be given; a block without
them is an error.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import jax

__all__ = ["initialize", "process_info", "make_global_batch"]

_INITIALIZED = False


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(dist_cfg: Optional[Dict[str, Any]] = None,
               logger=None) -> Tuple[int, int]:
    """Initialize ``jax.distributed`` from config/env; idempotent.

    Resolution order per field: the ``DSTDGCN_COORDINATOR`` /
    ``DSTDGCN_NUM_PROCESSES`` / ``DSTDGCN_PROCESS_ID`` env vars FIRST
    (one launch command per host with per-process env, as the config
    files document: "env vars override per process"), then the config
    block.  A missing config block AND missing env vars means
    single-process mode: no-op, returns (0, 1).  A launch that names
    some fields but not all three raises ``ValueError``.

    Returns ``(process_index, process_count)``.
    """
    global _INITIALIZED
    cfg = dict(dist_cfg or {})
    coord = os.environ.get("DSTDGCN_COORDINATOR") or cfg.get("coordinator")
    nproc = _env_int("DSTDGCN_NUM_PROCESSES")
    if nproc is None and cfg.get("num_processes") is not None:
        nproc = int(cfg["num_processes"])
    pid = _env_int("DSTDGCN_PROCESS_ID")
    if pid is None and cfg.get("process_id") is not None:
        pid = int(cfg["process_id"])

    if not cfg and coord is None and nproc is None:
        return 0, 1                       # single-process launch
    if not _INITIALIZED:
        if coord in (None, "auto") or nproc is None or pid is None:
            raise ValueError(
                "parallel.distributed needs coordinator (host:port), "
                "num_processes and process_id (config or DSTDGCN_* env); "
                f"got coordinator={coord!r}, num_processes={nproc!r}, "
                f"process_id={pid!r}.  A single host needs no distributed "
                "block: one process drives all its devices")
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nproc, process_id=pid)
        _INITIALIZED = True
    info = process_info()
    if logger is not None:
        logger.info(
            f"jax.distributed: process {info[0]}/{info[1]}, "
            f"{jax.local_device_count()} local / "
            f"{jax.device_count()} global devices")
    return info


def process_info() -> Tuple[int, int]:
    """(process_index, process_count) of this launch (single-process safe)."""
    return jax.process_index(), jax.process_count()


def make_global_batch(local_arrays, sharding):
    """Assemble per-process local batch shards into global ``jax.Array``s.

    Each process holds ``global_batch / process_count`` rows (the
    ``Loader`` per-process split); under multi-process this stitches them
    into one addressable global array per input, placed with ``sharding``.
    Single-process falls back to a plain ``device_put``.
    """
    if jax.process_count() == 1:
        return tuple(jax.device_put(a, sharding) for a in local_arrays)
    return tuple(
        jax.make_array_from_process_local_data(sharding, a)
        for a in local_arrays)
