"""Cross-process record merge over XLA collectives.

The file-based merge (scripts.merge_shards) assumes the per-shard
outputs land on a filesystem the merging host can read — true on a dev
box, not on a pod without shared storage.  This path ships the shard
records over the accelerator fabric instead (SURVEY §2.3's "allgather
of per-shard call records for deterministic merged output").

Memory is bounded: shards stream through fixed-size length-prefixed
chunks — every round all-gathers one ``[chunk]`` uint8 tensor plus its
valid length per process, and process 0 spools each shard's chunks to
per-shard temp files on disk before the in-order concatenation.  Peak
memory is O(chunk x num_processes) (default chunk 4 MiB), independent
of shard size — the round-2 design gathered whole output files padded
to the global max, i.e. O(max_shard_bytes x num_processes) on every
device, which at WGS scale is multi-GB.  The number of rounds is
deterministic (agreed from one initial length all-gather), so every
process executes the same collective sequence.

Built on jax.experimental.multihost_utils.process_allgather, i.e. an
XLA all_gather, which on GPUs runs as NCCL over NVLink between the cards
of a host; host gRPC is used only for coordination, exactly the
reference-free green-field design SURVEY §2.3 calls for.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from ..scripts.merge_shards import merge

DEFAULT_CHUNK = 4 << 20


def merge_barrier(timeout_ms: int | None = None) -> None:
    """Pre-merge rendezvous with a timeout (failure detection).

    An XLA all_gather has no timeout: if a peer process died mid-run,
    every survivor would hang in the collective forever.  This barrier
    runs on the distributed coordination service first — it fails fast
    (RuntimeError) when any process is missing, so survivors can exit
    cleanly with their shard outputs and resume manifests intact
    (SURVEY §5 failure-detection mandate).  Timeout:
    ``SNIPER_MERGE_TIMEOUT_MS`` (default 600000)."""
    if timeout_ms is None:
        try:
            timeout_ms = int(
                os.environ.get("SNIPER_MERGE_TIMEOUT_MS", "600000")
            )
        except ValueError:
            timeout_ms = 600000
    # private API: JAX 0.9 has no public barrier that takes a timeout
    from jax._src.distributed import global_state

    client = global_state.client
    if client is None:  # single-process / uninitialized: nothing to sync
        return
    client.wait_at_barrier("sniper_merge", timeout_ms)


def _chunk_bytes() -> int:
    try:
        return max(4096, int(os.environ.get("SNIPER_MERGE_CHUNK",
                                            DEFAULT_CHUNK)))
    except ValueError:
        return DEFAULT_CHUNK


def collective_merge(
    out_path: str, shard_path: str, process_id: int, num_processes: int,
    chunk: int | None = None,
) -> None:
    """All-gather every process's shard records in bounded chunks;
    process 0 writes the merged output.  Must be called by ALL
    processes (it is a collective); non-zero processes return after
    contributing."""
    from jax.experimental import multihost_utils as mhu

    chunk = chunk or _chunk_bytes()
    size = os.path.getsize(shard_path)
    # gather (size, my_chunk) together and agree on min(chunk): a
    # SNIPER_MERGE_CHUNK that differs across pod hosts would otherwise
    # make processes execute mismatched collective sequences (different
    # buffer shapes / round counts) and hang or crash mid-merge
    sz = np.asarray(
        mhu.process_allgather(np.array([size, chunk], np.int64))
    ).reshape(-1, 2)
    sizes = sz[:, 0]
    chunk = int(sz[:, 1].min())
    rounds = max(1, -(-int(sizes.max()) // chunk))

    spool_dir = None
    spools = []
    if process_id == 0:
        spool_dir = tempfile.mkdtemp(prefix="sniper_merge_")
        spools = [
            open(os.path.join(spool_dir, f"shard{i}"), "wb")
            for i in range(num_processes)
        ]
    try:
        with open(shard_path, "rb") as fh:
            for _ in range(rounds):
                data = fh.read(chunk)
                buf = np.zeros(chunk, np.uint8)
                if data:
                    buf[: len(data)] = np.frombuffer(data, np.uint8)
                lens = np.asarray(
                    mhu.process_allgather(
                        np.array([len(data)], np.int64)
                    )
                ).reshape(-1)
                blobs = np.asarray(mhu.process_allgather(buf))
                if process_id == 0:
                    for i in range(num_processes):
                        n = int(lens[i])
                        if n:
                            spools[i].write(blobs[i, :n].tobytes())
        if process_id == 0:
            for s in spools:
                s.close()
            merge(out_path, [s.name for s in spools])
    finally:
        if process_id == 0:
            for s in spools:
                try:
                    s.close()
                    os.unlink(s.name)
                except OSError:
                    pass
            if spool_dir:
                try:
                    os.rmdir(spool_dir)
                except OSError:
                    pass
