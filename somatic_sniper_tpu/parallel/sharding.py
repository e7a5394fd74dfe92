"""Device-mesh sharding for batched somatic calling.

Parallelism design (green-field vs. the single-threaded reference; see
SURVEY.md §2.3):

* **Data parallel** — pileup columns are independent, so the batch axis of
  every ``[B, D]`` column tensor is sharded across a 1-D ``("data",)``
  device mesh with ``jax.NamedSharding``; XLA partitions the whole scoring
  kernel with zero communication until the final result gather.
* **Genome-interval sharding** (the sequence-parallel analog) happens on
  the host: deterministic `.fai`-derived interval partition, reads
  assigned by overlap (halo), each shard's columns flow into the same
  data-parallel kernel.  Interval assignment is static so no scheduler
  traffic exists at runtime.
* **Result merge** — per-shard call records are fixed-width int32 vectors;
  a final ``all_gather`` (or host gather on a single process) concatenates
  them; records are then ordered by (tid, pos) for deterministic output
  independent of shard count.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.glfgen import ColumnBatch
from ..models.somatic import CallResult, call_batch


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D data-parallel mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("data",))


def shard_column_batch(cb: ColumnBatch, mesh: Mesh) -> ColumnBatch:
    """Place a ColumnBatch with its batch axis sharded over the mesh."""
    s2 = NamedSharding(mesh, P("data", None))
    s1 = NamedSharding(mesh, P("data"))
    return ColumnBatch(
        slots=jax.device_put(cb.slots, s2),
        depth=jax.device_put(cb.depth, s1),
        ref16=jax.device_put(cb.ref16, s1),
    )


def sharded_call_batch(
    mesh: Mesh,
    tumor: ColumnBatch,
    normal: ColumnBatch,
    tables_args: tuple,
    precision: str = "fast",
    use_joint: bool = False,
    **kwargs,
) -> CallResult:
    """Run call_batch with batch-axis data parallelism over ``mesh``.

    ``tables_args`` is (fk, coef, lhet, solo_prior, joint_prior, qadd,
    q_r_int).  The batch size must be divisible by the mesh size (pad with
    empty columns; they emit nothing).
    """
    repl = NamedSharding(mesh, P())
    tumor = shard_column_batch(tumor, mesh)
    normal = shard_column_batch(normal, mesh)
    fk, coef, lhet, solo, joint, qadd, q_r_int = tables_args
    put = lambda x: jax.device_put(jnp.asarray(x), repl)
    # the batch-sharded inputs partition the whole step under GSPMD
    return call_batch(
        tumor, normal,
        put(fk), put(coef), put(lhet), put(solo), put(joint), put(qadd),
        q_r_int, precision=precision, use_joint=use_joint, **kwargs,
    )


def partition_intervals(
    ref_lengths: list[int], n_shards: int, min_chunk: int = 1
) -> list[list[tuple[int, int, int]]]:
    """Deterministic (tid, start, end) interval partition of a genome.

    Splits total genome length into ``n_shards`` near-equal contiguous
    spans following contig order — identical on every host, so shard
    assignment needs no communication.
    """
    total = sum(ref_lengths)
    bounds = [round(i * total / n_shards) for i in range(n_shards + 1)]
    shards: list[list[tuple[int, int, int]]] = [[] for _ in range(n_shards)]
    gpos = 0
    for tid, ln in enumerate(ref_lengths):
        for s in range(n_shards):
            lo = max(bounds[s], gpos)
            hi = min(bounds[s + 1], gpos + ln)
            if hi > lo:
                shards[s].append((tid, lo - gpos, hi - gpos))
        gpos += ln
    return shards
