"""Single-host calling driver: BAM pair -> batched kernel -> records.

This is the batched inversion of the reference's main loop
(reference sniper_pileup.c:226-266 + somatic_sniper.c:109-273): instead of
one callback per reference position, whole windows of pileup columns are
columnarized on the host, scored as dense batches on the device, and only
emitted sites return to the host for exact dqstats + text formatting.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import Iterator, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .constants import NT16_TABLE
from .io.bam import BamHeader, BamReads, read_bam
from .io.fasta import FastaFile
from .models.glfgen import ColumnBatch
from .models.somatic import (
    COMPACT_FIELDS,
    CallResult,
    call_batch,
    call_batch_compact,
    call_batch_packed,
    call_batch_stacked,
)
from .models.tables import ModelParams, ModelTables, build_tables
from .output.dqstats import get_dqstats, get_dqstats_batch
from .output.records import SampleData, SniperRecord
from .utils.stats import STATS
from .pileup.columnize import (
    ColumnarPileup,
    PairedBatch,
    columnize,
    paired_batches,
    split_key,
    unpack_slots,
)


@dataclass
class RefCache:
    """Per-tid reference fetch cache (reference somatic_sniper.c:112-117).

    Thread-safe: the slab collector thread resolves reference chars for
    emitted records concurrently with the main thread's deep-column
    emission."""

    fasta: FastaFile | None
    header: BamHeader

    def __post_init__(self):
        import threading

        self._tid = -1
        self._seq: bytes | None = None
        self._lock = threading.Lock()

    def get(self, tid: int) -> bytes | None:
        with self._lock:
            if tid != self._tid:
                name = self.header.ref_names[tid]
                self._seq = self.fasta.fetch(name) if self.fasta else None
                self._tid = tid
            return self._seq


def _ref_arrays(batch: PairedBatch, refcache: RefCache):
    """Raw ref char + 4-bit code per column of a batch."""
    tids, poss = split_key(batch.keys)
    chars = np.full(len(tids), ord("N"), np.int32)
    for tid in np.unique(tids):
        seq = refcache.get(int(tid))
        m = tids == tid
        if seq is None:
            continue
        p = poss[m]
        ok = p < len(seq)
        arr = np.frombuffer(seq, dtype=np.uint8)
        vals = np.where(ok, arr[np.minimum(p, len(seq) - 1)], ord("N"))
        chars[m] = vals
    ref16 = NT16_TABLE[chars].astype(np.int32)
    return chars, ref16


_DEVICE_TABLES_CACHE: dict = {}
_MESH_CACHE: dict = {}


def _exact_cpu_ctx(precision: str):
    """Pin exact-precision JAX compute to the host CPU backend.

    The exact path replicates the reference C tool's double-precision
    arithmetic (reference sniper_maqcns.c:127-248), and the CPU backend
    is where that replication is tested bit for bit.  Naming the
    platform resolves no device, so a run whose scoring stays in the
    native layer never creates an accelerator client.  Fast precision
    is unaffected."""
    import contextlib

    if precision != "exact":
        return contextlib.nullcontext()
    return jax.default_device("cpu")


def data_mesh():
    """1-D ("data",) mesh over all local devices, or None on a single
    device.  The production dispatch shards every batch's leading axis
    over this mesh (XLA inserts the collectives); set SNIPER_NO_MESH=1
    to force single-device dispatch."""
    if os.environ.get("SNIPER_NO_MESH"):
        return None
    n = jax.local_device_count()
    if n <= 1:
        return None
    mesh = _MESH_CACHE.get(n)
    if mesh is None:
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.local_devices()), ("data",))
        _MESH_CACHE[n] = mesh
    return mesh


def _shard_batch(arr_h, mesh, batch_axis: int):
    """Host array -> device array sharded over the mesh on batch_axis."""
    from jax.sharding import NamedSharding, PartitionSpec

    spec = [None] * arr_h.ndim
    spec[batch_axis] = "data"
    return jax.device_put(arr_h, NamedSharding(mesh, PartitionSpec(*spec)))


def get_device_tables(params: ModelParams, precision: str) -> "DeviceTables":
    """Process-wide DeviceTables cache: the 16-32 MiB coef upload and the
    jnp conversions are paid once per (params, precision), not once per
    call_pair invocation."""
    key = (params, precision)
    dt = _DEVICE_TABLES_CACHE.get(key)
    if dt is None:
        from .utils.compile_cache import enable_persistent_cache

        enable_persistent_cache()
        if precision == "fast":
            # name the backend a fast run scores on (one line per run)
            devs = jax.local_devices()
            print(f"Scoring on {devs[0].platform} ({devs[0].device_kind})"
                  f" x{len(devs)}", file=sys.stderr, flush=True)
        dt = DeviceTables(build_tables(params), precision)
        _DEVICE_TABLES_CACHE[key] = dt
    return dt


class DeviceTables:
    """Model tables resident on device, converted once per precision.

    Re-sending the 32 MiB coef table with every batch dominates runtime
    (host->device transfer); device_put once and reuse.
    """

    def __init__(self, tabs: ModelTables, precision: str):
        f = jnp.float64 if precision == "exact" else jnp.float32
        self.fk = jax.device_put(jnp.asarray(tabs.fk, f))
        self.coef = jax.device_put(jnp.asarray(tabs.coef, f))
        self.lhet = jax.device_put(jnp.asarray(tabs.lhet, f))
        self.solo_prior = jax.device_put(jnp.asarray(tabs.solo_prior))
        self.joint_prior = jax.device_put(jnp.asarray(tabs.joint_prior))
        self.qadd = jax.device_put(jnp.asarray(tabs.qadd))
        self.q_r_int = tabs.q_r_int
        self.params = tabs.params


def _column_slice(pu: ColumnarPileup, key: int):
    i = int(np.searchsorted(pu.ukeys, key))
    s, e = int(pu.offsets[i]), int(pu.offsets[i + 1])
    return slice(s, e)


def _sample_data(pu, sl, rb4, wanted, gt, jgt, jcq, cnsq, vaq, score, status):
    base16, baseq, mapq, strand, is_del = unpack_slots(pu.slots[sl])
    dq = get_dqstats(base16, baseq, mapq, strand, is_del, rb4, wanted)
    return SampleData(
        genotype=gt,
        joint_genotype=jgt,
        joint_consensus_quality=jcq,
        consensus_quality=cnsq,
        variant_allele_quality=vaq,
        somatic_score=score,
        variant_status=status,
        dqstats=dq,
    )


def _load_pileups(tumor_bam, normal_bam, params, flag_args=None):
    """Decode + columnize both BAMs.  The two files are loaded on two OS
    threads with ONE native worker thread each (ctypes releases the GIL):
    the decode/pileup-build phases of the native loader are serial per
    file, so file-level parallelism beats giving both inflate threads to
    one file (~25% faster on a 2-core host).  ``flag_args`` additionally
    computes the pure-reference flags inside each file's load thread."""
    from .io import native_api

    if native_api.available():
        from concurrent.futures import ThreadPoolExecutor

        per_file = max(1, (os.cpu_count() or 2) // 2)
        with STATS.timer("decode"), ThreadPoolExecutor(max_workers=2) as ex:
            f_t = ex.submit(native_api.load_and_columnize, tumor_bam,
                            params.flag_mask, params.mapq_threshold,
                            per_file, flag_args)
            f_n = ex.submit(native_api.load_and_columnize, normal_bam,
                            params.flag_mask, params.mapq_threshold,
                            per_file, flag_args)
            header_t, pu_t = f_t.result()
            header_n, pu_n = f_n.result()
    else:
        header_t, reads_t = read_bam(tumor_bam)
        header_n, reads_n = read_bam(normal_bam)
        pu_t = columnize(reads_t, params.flag_mask, params.mapq_threshold)
        pu_n = columnize(reads_n, params.flag_mask, params.mapq_threshold)
    return header_t, pu_t, header_n, pu_n


def _ref_blob(fasta, header):
    """Whole-genome 4-bit reference blob, or (None, None) without a ref."""
    from .pileup.prefilter import build_ref16

    if fasta is None:
        return None, None
    seqs = []
    for name in header.ref_names:
        try:
            seqs.append(fasta.fetch(name) or b"")
        except Exception:
            seqs.append(b"")
    return build_ref16(seqs)


def _make_ref16_fn(ref_blob, ref_off):
    """keys -> int32[B] reference-code lookup over the blob ('N' = 15 for
    out-of-range positions, matching _ref_arrays)."""
    lens = np.diff(ref_off)
    n_ref = len(lens)

    def fn(keys):
        tid = (keys >> 40).astype(np.int64)
        pos = (keys & ((1 << 40) - 1)).astype(np.int64)
        ok = (tid >= 0) & (tid < n_ref)
        tid_c = np.clip(tid, 0, max(n_ref - 1, 0))
        ok &= pos < lens[tid_c]
        addr = ref_off[tid_c] + np.minimum(
            pos, np.maximum(lens[tid_c] - 1, 0)
        )
        return np.where(ok, ref_blob[addr], 15).astype(np.int32)

    return fn


def _prefilter_flags(pu_t, pu_n, ref_blob, ref_off, tabs):
    """(drop_tumor, drop_normal) pure-ref flags, or (None, None)."""
    from .io.native_api import precomputed_pure
    from .pileup.prefilter import prefilter_tables, pure_flags

    pt = prefilter_tables(tabs)
    if pt is None or ref_blob is None:
        return None, None
    ft = precomputed_pure(pu_t)
    fn = precomputed_pure(pu_n)
    if ft is not None and fn is not None:
        return ft, fn
    gmin, margin = pt
    ft = pure_flags(pu_t, ref_blob, ref_off, tabs.fk, gmin, margin)
    fn = pure_flags(pu_n, ref_blob, ref_off, tabs.fk, gmin, margin)
    return ft, fn


def call_pair(
    tumor_bam: str,
    normal_bam: str,
    ref_fasta: str | None,
    params: ModelParams = ModelParams(),
    precision: str = "exact",
    max_batch: int = 65536,
    prefilter: bool = True,
    fmt: str | None = None,
) -> Iterator[SniperRecord]:
    """Run the full caller, yielding emitted records in coordinate order.

    With ``fmt`` ("classic"/"vcf"/"bed") set, yields the formatted output
    LINES instead of SniperRecord objects — the bulk text-emission path
    (output.fast_emit), byte-identical to formatting the records but
    ~3x cheaper at WGS emit rates."""
    with _exact_cpu_ctx(precision):
        fasta = FastaFile(ref_fasta) if ref_fasta else None
        tabs = build_tables(params)
        flag_args = None
        ref_blob = ref_off = None
        # header read for the reference blob must not consume stdin
        # ('-' tumor support, reference main.c:128)
        hdr_path = normal_bam if tumor_bam == "-" else tumor_bam
        if fasta is not None and hdr_path != "-":
            # reference blob before the load: the loader threads compute
            # the pure-reference flags alongside the pileup build
            from .io.bam import read_bam_header
            from .pileup.prefilter import prefilter_tables

            try:
                header0 = read_bam_header(hdr_path)
                ref_blob, ref_off = _ref_blob(fasta, header0)
                if prefilter:
                    pt = prefilter_tables(tabs)
                    if pt is not None:
                        gmin, margin = pt
                        flag_args = (ref_blob, ref_off, tabs.fk, gmin,
                                     margin)
            except Exception:
                ref_blob = ref_off = None
        header_t, pu_t, header_n, pu_n = _load_pileups(
            tumor_bam, normal_bam, params, flag_args
        )
        refcache = RefCache(fasta, header_t)
        if ref_blob is None:
            ref_blob, ref_off = _ref_blob(fasta, header_t)
        # all-host exact path: plan + full scoring in the native layer
        if precision == "exact" and can_exact_native(pu_t, pu_n, ref_blob):
            records = exact_records_native(
                pu_t, pu_n, tabs, ref_blob, ref_off, refcache, prefilter,
                fmt=fmt,
            )
            for _, rec in records:
                yield rec
            return
        # the fast path plans through the native layer (packed batches);
        # the exact JAX fallback needs the full u32 slots
        packed16 = precision == "fast" and ref_blob is not None
        if can_plan(pu_t, pu_n, packed16):
            plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off,
                             prefilter, cns_mode="proof")
            if (
                len(plan.keys) < _device_min_cols()
                and can_exact_native(pu_t, pu_n, ref_blob)
            ):
                # SNIPER_DEVICE_MIN_COLS: plans below this many
                # survivors score exactly on the host.  Exact values
                # satisfy the fast contract by construction (same
                # calls, zero phred drift).
                records = exact_records_native(
                    pu_t, pu_n, tabs, ref_blob, ref_off, refcache,
                    prefilter, fmt=fmt, plan=plan,
                )
                for _, rec in records:
                    yield rec
                return
            # uniform-slab device path: one executable shape for the
            # whole run (see parallel.slab)
            from .parallel.slab import SlabDispatcher

            disp = SlabDispatcher(
                lambda: get_device_tables(params, precision), tabs,
                params, refcache, fmt=fmt,
            )
            disp.add_window(0, None, pu_t, pu_n, plan)
            for _, _, recs in disp.finish():
                yield from recs
            return
        dtabs = get_device_tables(params, precision)
        drop_t = drop_n = None
        if prefilter:
            drop_t, drop_n = _prefilter_flags(
                pu_t, pu_n, ref_blob, ref_off, tabs
            )
        ref16_fn = (
            _make_ref16_fn(ref_blob, ref_off) if packed16 else None
        )
        pending = submit_batches(
            pu_t, pu_n, refcache, dtabs, precision, max_batch,
            drop_t, drop_n, packed16, ref16_fn, params.cap_mapq,
        )
        records = collect_pending(
            pending, pu_t, pu_n, refcache, dtabs, precision, fmt=fmt
        )
    for _, rec in records:
        yield rec


def submit_batches(
    pu_t, pu_n, refcache, dtabs, precision, max_batch,
    drop_t, drop_n, packed16, ref16_fn, cap_mapq,
):
    """Dispatch every paired batch to the device (async); returns the
    pending list for collect_pending.  Submitting everything before
    collecting overlaps device compute/transfers with host-side padding
    of later batches.  (The native fast path uses
    :func:`submit_batches_planned` instead.)"""
    pending = []
    for batch in paired_batches(pu_t, pu_n, max_batch=max_batch,
                                drop_tumor=drop_t, drop_normal=drop_n,
                                packed16=packed16, ref16_fn=ref16_fn,
                                cap_mapq=cap_mapq):
        chars, ref16 = _ref_arrays(batch, refcache)
        dev_res, b0 = submit_call_batch(
            batch, ref16, chars, dtabs, precision, compact=True
        )
        pending.append((batch, chars, ref16, dev_res, b0))
    return pending


def can_plan(pu_t, pu_n, packed16: bool) -> bool:
    """True when the fused native plan path applies: fast-precision u16
    batches with both pileups owned by the native layer."""
    return (
        packed16
        and pu_t.owner is not None
        and hasattr(pu_t.owner, "pad16_into")
        and pu_n.owner is not None
        and hasattr(pu_n.owner, "pad16_into")
    )


def can_exact_native(pu_t, pu_n, ref_blob) -> bool:
    """True when the all-host exact scorer applies: native-owned pileups
    plus an in-memory reference blob."""
    return (
        ref_blob is not None
        and pu_t.owner is not None
        and getattr(pu_t.owner, "_ptr", None) is not None
        and pu_n.owner is not None
        and getattr(pu_n.owner, "_ptr", None) is not None
    )


class _PlanBatch(NamedTuple):
    """Shim giving the planned column list the tiny batch interface the
    record builder consumes (batch.keys indexing)."""

    keys: np.ndarray


def _device_min_cols() -> int:
    """Survivor count below which the fast path scores host-side
    instead of dispatching: ``SNIPER_DEVICE_MIN_COLS``, default 0
    (always dispatch).  The whole-file gate, the slab end-game cutover
    and the final-slab host tail all read it."""
    try:
        return max(0, int(os.environ.get("SNIPER_DEVICE_MIN_COLS", "0")))
    except ValueError:
        return 0


def exact_records_native(
    pu_t, pu_n, tabs, ref_blob, ref_off, refcache, prefilter: bool,
    fmt: str | None = None, plan=None,
) -> list[tuple[int, SniperRecord]]:
    """Exact mode entirely on the native layer: fused plan (intersect +
    prefilter + exact dual-consensus gate) then full per-column scoring
    (glfgen f64 + integer phred pipeline) in C — bit-identical to the
    JAX exact path (tested), with no device round trip.  The depth
    bucketing the plan produces is irrelevant here; records are sorted
    by coordinate at the end like collect_pending."""
    from .io.native_api import exact_pair_rows

    # proof-only gate here too: exact_pair_rows applies the complete
    # exact emission gate to every survivor, so the plan's extra f64
    # dual-consensus evals only duplicate work (measured ~4% of wall at
    # 10 Mb; outputs byte-identical across gate depths by construction,
    # and tests/test_prefilter.py pins both)
    if plan is None:
        plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off, prefilter,
                         cns_mode="proof")
    p = tabs.params
    with STATS.timer("score"):
        rows = exact_pair_rows(
            pu_t, pu_n, plan.ti, plan.ni, plan.ref16, tabs,
            p.use_joint_priors, p.min_somatic_qual, p.include_loh,
            p.include_gor,
        )
    with STATS.timer("emit"):
        records = emit_records_compact(
            _PlanBatch(keys=np.asarray(plan.keys, np.int64)), rows, None,
            np.asarray(plan.ref16, np.int64), pu_t, pu_n, refcache,
            fmt=fmt,
        )
    records.sort(key=lambda kv: kv[0])
    STATS.add("records_emitted", len(records))
    return records


def make_plan(pu_t, pu_n, tabs, ref_blob, ref_off, prefilter: bool,
              cns_mode: str = "full"):
    """One native ``paired_plan`` pass: fused ukey intersection, the
    pure-reference prefilter (both-samples-pure columns never leave the
    host), the dual-consensus gate (provably output-preserving — it
    evaluates the SNP gate with the exact f64 model itself) and depth
    grouping.  Shared by the exact scorer (``cns_mode="full"``) and the
    slab dispatcher (``"proof"``: unresolved columns ship to the device,
    which applies the whole gate — the host skips the expensive f64
    evals).  Override with SNIPER_PLAN_GATE=full|proof."""
    from .io.native_api import paired_plan
    from .pileup.columnize import DEPTH_BUCKETS
    from .pileup.prefilter import prefilter_tables

    cns_mode = os.environ.get("SNIPER_PLAN_GATE", cns_mode)
    gmin = None
    margin = 0.0
    coef = lhet = None
    if prefilter:
        pt = prefilter_tables(tabs)
        if pt is not None:
            gmin, margin = pt
        coef, lhet = tabs.coef, tabs.lhet
    with STATS.timer("plan"):
        plan = paired_plan(pu_t, pu_n, ref_blob, ref_off, DEPTH_BUCKETS,
                           fk=tabs.fk, gmin=gmin, margin=margin,
                           coef=coef, lhet=lhet, q_r_int=tabs.q_r_int,
                           cns_mode=cns_mode)
    STATS.add("columns_scored", len(plan.keys))
    return plan


def collect_pending(
    pending, pu_t, pu_n, refcache, dtabs, precision, fmt: str | None = None
) -> list[tuple[int, SniperRecord]]:
    """Fetch compacted results and build records, sorted by column key."""
    records: list[tuple[int, SniperRecord]] = []
    # Two batched fetches: first every count together, then only
    # rows[:bucket(count)] of each live buffer — emitted sites are a few
    # % of columns, so slicing before the fetch drops most of the
    # result-download bytes.
    with STATS.timer("device"):
        total_rows = sum(p[3].rows.shape[0] for p in pending)
        if total_rows * 4 * 17 <= (4 << 20):
            # small result buffers: one round-trip for everything beats
            # the two-phase sliced fetch
            with STATS.timer("device.rows"):
                fetched = jax.device_get(
                    [(p[3].count, p[3].rows) for p in pending]
                )
            counts = [c for c, _ in fetched]
            slices = [r for _, r in fetched]
            live_rows = iter(slices)
            slices = [True] * len(pending)
        else:
            with STATS.timer("device.counts"):
                counts = jax.device_get([p[3].count for p in pending])
            slices = []
            for p, cnt in zip(pending, counts):
                c = int(cnt)
                K = p[3].rows.shape[0]
                if c <= 0 or c > K:
                    slices.append(None)
                else:
                    slices.append(p[3].rows[: _emit_bucket(c, K)])
            live = [s for s in slices if s is not None]
            with STATS.timer("device.rows"):
                live_rows = iter(
                    jax.device_get(live) if live else []
                )
    for (batch, chars, ref16, dev_res, b0), cnt, sl in zip(
        pending, counts, slices
    ):
        count = int(cnt)
        rows_full = next(live_rows) if sl is not None else None
        if count <= 0:
            continue
        if count > dev_res.rows.shape[0]:
            # emitted rows overflow the compact buffer (pathological emit
            # rate) — refetch the full per-column result
            if chars is None:
                chars, _ = _ref_arrays(batch, refcache)
            full, _ = submit_call_batch(
                batch, ref16, chars, dtabs, precision, compact=False
            )
            host = jax.device_get(full)
            res = CallResult(*(v[:b0] for v in host))
            records.extend(
                emit_records(batch, res, chars, ref16, pu_t, pu_n,
                             refcache, fmt=fmt)
            )
            continue
        rows = rows_full[:count]
        with STATS.timer("emit"):
            records.extend(
                emit_records_compact(batch, rows, chars, ref16, pu_t, pu_n,
                                     refcache, fmt=fmt)
            )
    records.sort(key=lambda kv: kv[0])
    STATS.add("records_emitted", len(records))
    return records


def _ref_chars_for(keys: np.ndarray, refcache: RefCache) -> np.ndarray:
    """Raw reference characters for the given column keys (emit-time
    lookup for the fast path, which never materializes per-batch chars)."""
    tids = (keys >> 40).astype(np.int64)
    poss = (keys & ((1 << 40) - 1)).astype(np.int64)
    chars = np.full(len(keys), ord("N"), np.int32)
    for tid in np.unique(tids):
        seq = refcache.get(int(tid))
        if seq is None:
            continue
        m = tids == tid
        p = poss[m]
        ok = p < len(seq)
        arr = np.frombuffer(seq, dtype=np.uint8)
        chars[m] = np.where(ok, arr[np.minimum(p, len(seq) - 1)], ord("N"))
    return chars


def _pad_b(arr: np.ndarray, B: int):
    """Pad the leading (batch) axis to B with zeros."""
    if arr.shape[0] == B:
        return arr
    pad = [(0, B - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _emit_bucket(c: int, K: int) -> int:
    """Bounded slice lengths for the emitted-rows fetch: next power of
    two >= max(c, 128), capped at K (bounds compile variety of the
    device-side slice while fetching ~c rows instead of all K)."""
    k = 128
    while k < c:
        k *= 2
    return min(k, K)


def _b_bucket(b: int, minimum: int = 256) -> int:
    """Pad the batch axis to a bounded set of sizes: powers of two up to
    2048, then multiples of 2048.  Keeps XLA compile variety small while
    wasting far less upload bandwidth than pure powers of two."""
    B = minimum
    while B < b and B < 2048:
        B *= 2
    if B >= b:
        return B
    return ((b + 2047) // 2048) * 2048


def submit_call_batch(
    batch: PairedBatch,
    ref16: np.ndarray,
    chars: np.ndarray,
    dtabs: DeviceTables,
    precision: str,
    compact: bool = False,
):
    """Dispatch one padded batch to the device (async); returns the
    on-device result (CallResult, or CompactResult when ``compact``) and
    the unpadded column count."""
    # pad the batch axis to a bounded bucket set so XLA compiles once per
    # (B, D) bucket instead of once per distinct column count
    b0 = len(batch.keys)
    B = _b_bucket(b0)
    p = dtabs.params
    # one stacked upload for the two big slot arrays, one for the small
    # metadata (per-array transfers pay interconnect latency each)
    stacked_h = np.stack([_pad_b(batch.tumor, B), _pad_b(batch.normal, B)])
    meta_rows = [
        _pad_b(batch.n_tumor, B),
        _pad_b(batch.n_normal, B),
        _pad_b(ref16, B),
    ]
    if batch.packed16:
        meta_rows += [
            _pad_b(batch.nk_tumor, B), _pad_b(batch.nk_normal, B),
            _pad_b(batch.rms_tumor, B), _pad_b(batch.rms_normal, B),
        ]
    meta_h = np.stack(meta_rows)
    mesh = data_mesh()
    if mesh is not None and B % mesh.size != 0:
        mesh = None
    if mesh is not None:
        stacked = _shard_batch(stacked_h, mesh, 1)
        meta = _shard_batch(meta_h, mesh, 1)
    else:
        stacked = jnp.asarray(stacked_h)
        meta = jnp.asarray(meta_h)
    res = call_batch_stacked(
        stacked,
        meta,
        dtabs.fk,
        dtabs.coef,
        dtabs.lhet,
        dtabs.solo_prior,
        dtabs.joint_prior,
        dtabs.qadd,
        dtabs.q_r_int,
        precision=precision,
        use_joint=p.use_joint_priors,
        min_somatic_qual=p.min_somatic_qual,
        include_loh=p.include_loh,
        include_gor=p.include_gor,
        cap_mapq=p.cap_mapq,
        theta=p.theta,
        eta=p.eta,
        max_emit=min(B, 16384),
        packed16=batch.packed16,
        compact=compact,
    )
    return res, b0


def run_call_batch(batch, ref16, chars, dtabs, precision) -> CallResult:
    """Synchronous convenience wrapper around submit_call_batch."""
    res, b0 = submit_call_batch(batch, ref16, chars, dtabs, precision)
    host = jax.device_get(res)  # one transfer for all result fields
    return CallResult(*(v[:b0] for v in host))


def emit_records(
    batch: PairedBatch,
    res: CallResult,
    chars: np.ndarray | None,
    ref16: np.ndarray,
    pu_t: ColumnarPileup,
    pu_n: ColumnarPileup,
    refcache: RefCache,
    fmt: str | None = None,
) -> list[tuple[int, SniperRecord]]:
    emit = np.asarray(res.emit)
    idx = np.nonzero(emit)[0]
    if len(idx) == 0:
        return []
    f = {k: np.asarray(v)[idx] for k, v in res._asdict().items()}
    return _build_records(batch, idx, f, chars, ref16, pu_t, pu_n,
                          refcache, fmt)


def emit_records_compact(
    batch: PairedBatch,
    rows: np.ndarray,
    chars: np.ndarray | None,
    ref16: np.ndarray,
    pu_t: ColumnarPileup,
    pu_n: ColumnarPileup,
    refcache: RefCache,
    fmt: str | None = None,
) -> list[tuple[int, SniperRecord]]:
    """emit_records over a device-compacted [count, 1+NF] row matrix.

    Rows of width 1+NF+36 additionally carry the per-sample dqstats
    fields (tumor 18 then normal 18 — computed on-device for slab
    columns, host-appended for deep/tail columns), in which case the
    record builder skips its own pileup walk entirely."""
    if len(rows) == 0:
        return []
    idx = rows[:, 0].astype(np.int64)
    nf = len(COMPACT_FIELDS)
    rows_t = rows_n = None
    if rows.shape[1] == 1 + nf + 36:
        rows_t = rows[:, 1 + nf:1 + nf + 18]
        rows_n = rows[:, 1 + nf + 18:1 + nf + 36]
    f = {name: rows[:, 1 + j] for j, name in enumerate(COMPACT_FIELDS)}
    return _build_records(batch, idx, f, chars, ref16, pu_t, pu_n,
                          refcache, fmt, rows_t=rows_t, rows_n=rows_n)


def _build_records(
    batch: PairedBatch,
    idx: np.ndarray,
    f: dict,
    chars: np.ndarray | None,
    ref16: np.ndarray,
    pu_t: ColumnarPileup,
    pu_n: ColumnarPileup,
    refcache: RefCache,
    fmt: str | None = None,
    rows_t: np.ndarray | None = None,
    rows_n: np.ndarray | None = None,
) -> list[tuple[int, SniperRecord]]:
    header = refcache.header
    keys = batch.keys[idx]
    tids = (keys >> 40).astype(np.int64)
    poss = (keys & ((1 << 40) - 1)).astype(np.int64)
    chars_emit = (
        chars[idx] if chars is not None else _ref_chars_for(keys, refcache)
    )
    rb4 = ref16[idx].astype(np.int64)
    have_dq = rows_t is not None and rows_n is not None
    if fmt is not None:
        # bulk text path: raw dqstats rows + one-pass line builders —
        # no DqStats/SampleData/SniperRecord objects, same bytes.
        # Preferred renderer is the native emit_lines (one C pass; the
        # Python f-string loop was ~25% of the exact-mode main thread
        # at 10 Mb); output.fast_emit stays as the readable reference
        # and the no-toolchain fallback (byte-equality enforced by
        # tests/test_fast_emit.py).  Precomputed dqstats rows (device-
        # scored slab columns) skip the pileup walk AND the column
        # searchsorted here.
        from .io import native_api
        from .models.somatic import COMPACT_FIELDS
        from .output.dqstats import get_dqstats_rows

        if not have_dq:
            wanted = rb4 | f["tumor_eff_gt"] | f["normal_eff_gt"]
            ci_t = np.searchsorted(pu_t.ukeys, keys)
            ci_n = np.searchsorted(pu_n.ukeys, keys)
            with STATS.timer("emit.dqstats"):
                rows_t = get_dqstats_rows(pu_t, ci_t, rb4, wanted)
                rows_n = get_dqstats_rows(pu_n, ci_n, rb4, wanted)
        lines = None
        if all(k in f for k in COMPACT_FIELDS[:12]):
            fields = np.stack(
                [np.asarray(f[k], np.int64) for k in COMPACT_FIELDS[:12]],
                axis=1,
            )
            lines = native_api.emit_lines(
                fmt, header.ref_names, tids, poss, chars_emit, rb4,
                fields, rows_t, rows_n,
            )
        if lines is None:
            from .output.fast_emit import LINE_BUILDERS

            fl = {k: np.asarray(v).tolist() for k, v in f.items()}
            names_l = [header.ref_names[t] for t in tids.tolist()]
            lines = LINE_BUILDERS[fmt](
                names_l, poss.tolist(), chars_emit.tolist(), rb4.tolist(),
                fl, rows_t.tolist(), rows_n.tolist(),
            )
        return list(zip(keys.tolist(), lines))
    if have_dq:
        from .output.dqstats import rows_to_dqstats

        dq_t = rows_to_dqstats(rows_t)
        dq_n = rows_to_dqstats(rows_n)
    else:
        wanted = rb4 | f["tumor_eff_gt"] | f["normal_eff_gt"]
        ci_t = np.searchsorted(pu_t.ukeys, keys)
        ci_n = np.searchsorted(pu_n.ukeys, keys)
        dq_t = get_dqstats_batch(pu_t, ci_t, rb4, wanted)
        dq_n = get_dqstats_batch(pu_n, ci_n, rb4, wanted)

    # bulk numpy->python conversion: one .tolist() per column beats a
    # per-record int(np_scalar) for every field by an order of magnitude
    fl = {k: np.asarray(v).tolist() for k, v in f.items()}
    keys_l = keys.tolist()
    names_l = [header.ref_names[t] for t in tids.tolist()]
    poss_l = poss.tolist()
    chars_l = chars_emit.tolist()
    rb4_l = rb4.tolist()
    t_gt, t_jgt = fl["tumor_gt"], fl["joint_tumor_gt"]
    n_gt, n_jgt = fl["normal_gt"], fl["joint_normal_gt"]
    jcq = fl["joint_cnsq"]
    t_cq, t_vaq = fl["tumor_cnsq"], fl["tumor_vaq"]
    n_cq, n_vaq = fl["normal_cnsq"], fl["normal_vaq"]
    score = fl["somatic_score"]
    t_st, n_st = fl["tumor_status"], fl["normal_status"]

    out = []
    for k in range(len(idx)):
        tumor = SampleData(
            genotype=t_gt[k],
            joint_genotype=t_jgt[k],
            joint_consensus_quality=jcq[k],
            consensus_quality=t_cq[k],
            variant_allele_quality=t_vaq[k],
            somatic_score=score[k],
            variant_status=t_st[k],
            dqstats=dq_t[k],
        )
        normal = SampleData(
            genotype=n_gt[k],
            joint_genotype=n_jgt[k],
            joint_consensus_quality=jcq[k],
            consensus_quality=n_cq[k],
            variant_allele_quality=n_vaq[k],
            somatic_score=-1,
            variant_status=n_st[k],
            dqstats=dq_n[k],
        )
        rec = SniperRecord(
            seq_name=names_l[k],
            pos=poss_l[k],
            ref_base=chars_l[k],
            ref_base4=rb4_l[k],
            tumor=tumor,
            normal=normal,
        )
        out.append((keys_l[k], rec))
    return out
