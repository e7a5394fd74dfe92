"""Region-sharded streaming driver.

The reference streams both BAMs whole, single-threaded (SURVEY.md §0);
this driver instead cuts the genome into deterministic windows, seeks
each window via the BAI index, and runs the same batched device pipeline
per window — constant memory at WGS scale, shardable across processes /
hosts, and resumable per window.

Output-equality contract: the concatenation of all windows' records (in
window order) is byte-identical to the whole-file run.  The one
cross-window dependency is the reference's contig-transition drop quirk
(sniper_pileup.c:216): the first kept read of a contig is dropped when
its end precedes the previous contig's last kept-read start, which a
window at a contig start cannot see locally — so the driver carries that
value in via ``region_last_kept_start``.

Windows must be longer than the longest read (columns of a quirk-dropped
read must all fall in the contig's first window); the default 250 kb is
~3 orders of magnitude above short-read lengths and measured fastest
for BOTH precision modes on the dev host (round 4, after the async
device dispatch: 10 Mb pair best wall 5.3 s at 250 kb vs 6.0-6.3 s at
1 Mb — finer windows pack the 2-core load/compute pipeline better, and
the per-window plan/dispatch overhead stays negligible to ~125 kb).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Iterator

import numpy as np

from ..io import bai, native, native_api
from ..io.bam import BamHeader, read_bam_header
from ..io.fasta import FastaFile
from ..models.tables import ModelParams, build_tables
from ..output.records import SniperRecord

DEFAULT_WINDOW = 250_000


def genome_windows(
    ref_lengths: list[int], window_size: int = DEFAULT_WINDOW
) -> list[tuple[int, int, int]]:
    """Deterministic (tid, beg, end) windows covering the genome."""
    out = []
    for tid, ln in enumerate(ref_lengths):
        beg = 0
        while beg < ln:
            out.append((tid, beg, min(beg + window_size, ln)))
            beg += window_size
    return out


def shard_windows(windows, shards: int, shard_index: int | None):
    """Contiguous split of the window list across shards (keeps each
    shard's output a contiguous genome span, so shard outputs
    concatenate in shard order)."""
    if shard_index is None:
        return list(windows)
    n = len(windows)
    lo = shard_index * n // shards
    hi = (shard_index + 1) * n // shards
    return list(windows[lo:hi])


class _QuirkCarry:
    """Per-file carried previous-contig last kept-read start values."""

    def __init__(self, bam_path: str, index: bai.BaiIndex, header: BamHeader,
                 flag_mask: int, mapq_thresh: int):
        self.path = bam_path
        self.index = index
        self.header = header
        self.flag_mask = flag_mask
        self.mapq_thresh = mapq_thresh

    def for_window(self, tid: int, beg: int) -> int:
        """drop_first_end_le for a window, or -1 when not applicable."""
        if beg != 0 or tid == 0:
            return -1
        lib = native.get_lib()
        # previous contig with any indexed reads
        for p in range(tid - 1, -1, -1):
            if self.index.refs[p].bins:
                break
        else:
            return -1
        plen = self.header.ref_lengths[p]
        # Backward scan in DISJOINT, escalating spans: each BGZF region
        # is decoded at most once (worst case = one pass over the
        # contig, vs the old overlapping escalation that re-decoded the
        # tail each round).  A span's result may be a read that merely
        # overlaps it (start < span begin), so a candidate is only final
        # once it is >= the current span's begin — an earlier span can
        # no longer hold a later start.
        best = -1
        hi = plen
        look = 1 << 15
        while hi > 0:
            beg_p = max(0, hi - look)
            chunks = bai.region_chunks(self.index, p, beg_p, hi)
            if chunks:
                ch = np.ascontiguousarray(
                    np.asarray(chunks, np.int64).reshape(-1, 2)
                )
                import ctypes

                last = lib.region_last_kept_start(
                    self.path.encode(),
                    ch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(ch), p, beg_p, hi,
                    self.flag_mask, self.mapq_thresh, 2,
                )
                if last > best:
                    best = int(last)
                if best >= beg_p:
                    return best
            hi = beg_p
            look *= 4
        return best


def call_pair_windows(
    tumor_bam: str,
    normal_bam: str,
    ref_fasta: str | None,
    params: ModelParams = ModelParams(),
    precision: str = "exact",
    max_batch: int = 65536,
    prefilter: bool = True,
    window_size: int = DEFAULT_WINDOW,
    shards: int = 1,
    shard_index: int | None = None,
    skip_windows: set[int] | None = None,
    fmt: str | None = None,
) -> Iterator[tuple[int, tuple[int, int, int], list[SniperRecord]]]:
    """Yield (window_index, window, records) per genome window.

    Window indices are global (stable across shard counts) so resume
    manifests and multi-shard merges agree on numbering.
    """
    from ..runner import (
        RefCache,
        can_exact_native,
        can_plan,
        exact_records_native,
        get_device_tables,
        make_plan,
        _exact_cpu_ctx,
        _make_ref16_fn,
        _prefilter_flags,
        _ref_arrays,
        _ref_blob,
        collect_pending,
        submit_batches,
    )
    from .slab import SlabDispatcher

    header = read_bam_header(tumor_bam)
    idx_t = bai.ensure_index(tumor_bam)
    idx_n = bai.ensure_index(normal_bam)
    windows = genome_windows(header.ref_lengths, window_size)
    mine = shard_windows(list(enumerate(windows)), shards, shard_index)

    fasta = FastaFile(ref_fasta) if ref_fasta else None
    refcache = RefCache(fasta, header)
    tabs = build_tables(params)
    ref_blob, ref_off = _ref_blob(fasta, header)
    packed16 = precision == "fast" and ref_blob is not None
    ref16_fn = _make_ref16_fn(ref_blob, ref_off) if packed16 else None

    # DeviceTables only exist once a window actually dispatches to the
    # device: the all-native exact path never does, so a pure-exact run
    # skips the 16-32 MiB coef conversion/upload entirely.
    _dtabs: list = []

    def dtabs():
        if not _dtabs:
            with _exact_cpu_ctx(precision):
                _dtabs.append(get_device_tables(params, precision))
        return _dtabs[0]

    carry_t = _QuirkCarry(tumor_bam, idx_t, header,
                          params.flag_mask, params.mapq_threshold)
    carry_n = _QuirkCarry(normal_bam, idx_n, header,
                          params.flag_mask, params.mapq_threshold)

    # One-window lookahead: the next window's two region loads run on
    # background threads (the native loader releases the GIL) while the
    # current window pads, uploads, and waits on the device — the
    # host<->device link and the host decode pipeline stay busy
    # simultaneously instead of alternating.
    from concurrent.futures import ThreadPoolExecutor

    flag_args = None
    if prefilter and ref_blob is not None:
        from ..pileup.prefilter import prefilter_tables

        pt = prefilter_tables(tabs)
        if pt is not None:
            gmin, margin = pt
            flag_args = (ref_blob, ref_off, tabs.fk, gmin, margin)

    def _load_one(path, idx, carry, tid, beg, end):
        return native_api.load_region_and_columnize(
            path, np.asarray(bai.region_chunks(idx, tid, beg, end)),
            tid, beg, end, params.flag_mask, params.mapq_threshold,
            n_threads=1, drop_first_end_le=carry.for_window(tid, beg),
            flag_args=flag_args,
        )

    todo = [
        (wi, w) for wi, w in mine
        if not (skip_windows and wi in skip_windows)
    ]
    # SNIPER_LOAD_POOL bounds the concurrent region-load threads (the
    # native loader releases the GIL).  --jobs sets it to 1 for its
    # workers when N workers x 2 load threads would oversubscribe the
    # host cores (the measured failure mode of round 2's --jobs).
    # Default scales with the host: cores minus the main + device
    # threads, in [2, 6] (2 on the 2-vCPU dev host — the measured
    # optimum there; larger hosts keep more window loads in flight).
    default_pool = max(2, min(6, (os.cpu_count() or 2) - 2))
    try:
        pool_n = max(1, int(
            os.environ.get("SNIPER_LOAD_POOL", str(default_pool))
        ))
    except ValueError:
        pool_n = default_pool
    ex = ThreadPoolExecutor(max_workers=pool_n)

    import threading
    from concurrent.futures import Future

    # The per-window paired plan is offloaded into the pool only when
    # the pool has threads beyond the two a window's loads occupy: on
    # wide hosts the plan then rides the pool instead of serializing on
    # the main thread (the next bottleneck once loads parallelize).  On
    # a 2-thread pool the main thread is the spare core — queueing the
    # plan behind lookahead loads only delays the critical path
    # (measured +0.4-0.9 s on the 10 Mb fast run on the 2-vCPU host) —
    # so it plans inline as before.
    offload_plan = pool_n >= 3

    def _submit_window(win):
        """Submit the window's two region loads and (on wide pools)
        chain its paired plan behind them via completion callbacks — a
        plan task queued eagerly could occupy every pool thread waiting
        on loads that then cannot run.  Resolves to
        (pu_t, pu_n, plan-or-None); None when the plan was not
        offloaded or the native fused plan does not apply (the main
        loop then plans inline exactly as before)."""
        tid, beg, end = win
        f_t = ex.submit(_load_one, tumor_bam, idx_t, carry_t,
                        tid, beg, end)
        f_n = ex.submit(_load_one, normal_bam, idx_n, carry_n,
                        tid, beg, end)
        done = Future()
        n_landed = [0]
        cb_lock = threading.Lock()

        def _plan_task():
            try:
                pu_t, pu_n = f_t.result(), f_n.result()
                plan = None
                if (
                    ref_blob is not None
                    and getattr(pu_t.owner, "_ptr", None) is not None
                    and getattr(pu_n.owner, "_ptr", None) is not None
                ):
                    plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off,
                                     prefilter, cns_mode="proof")
                done.set_result((pu_t, pu_n, plan))
            except BaseException as e:  # surfaces on .result()
                done.set_exception(e)

        def _resolve_loads():
            try:
                done.set_result((f_t.result(), f_n.result(), None))
            except BaseException as e:
                done.set_exception(e)

        def _on_load(_):
            with cb_lock:
                n_landed[0] += 1
                if n_landed[0] < 2:
                    return
            if offload_plan:
                ex.submit(_plan_task)
            else:
                _resolve_loads()  # runs on the completing load thread

        f_t.add_done_callback(_on_load)
        f_n.add_done_callback(_on_load)
        return done

    # two-window lookahead keeps the load pool fed while the current
    # window computes (one-deep starves when compute is faster than the
    # pair of loads; the pool still bounds thread concurrency)
    # two-window lookahead on small hosts; deeper when the load pool
    # has threads to feed (each in-flight window pair holds ~50-100 MB
    # of pileup at the default window size)
    LOOKAHEAD = 2 if pool_n <= 2 else (pool_n + 1) // 2 + 1
    try:
        LOOKAHEAD = max(1, int(
            os.environ.get("SNIPER_LOOKAHEAD", LOOKAHEAD)
        ))
    except ValueError:
        pass
    inflight: list = [
        _submit_window(w) for _, w in todo[:LOOKAHEAD]
    ]

    # Collect is deferred: a window's device results are fetched only
    # after later windows have been loaded and dispatched, so device
    # execution runs under subsequent host work instead of on the
    # critical path.  The fast path does this
    # with the cross-window uniform-slab dispatcher (parallel.slab);
    # the legacy fallback keeps the one-window deferred pending list.
    # Yields stay in window order in all modes (a deferred window is
    # always flushed before anything newer).
    slab_disp = None
    deferred = None  # (wi, win, pu_t, pu_n, pending)

    def _collect(d):
        wi, win, pu_t, pu_n, pending = d
        with _exact_cpu_ctx(precision):
            records = collect_pending(
                pending, pu_t, pu_n, refcache, dtabs(), precision, fmt=fmt,
            )
        return wi, win, [r for _, r in records]

    from ..utils.stats import STATS

    for i, (wi, (tid, beg, end)) in enumerate(todo):
        fut = inflight.pop(0)
        with STATS.timer("load_wait"):
            # While the next window's loads run (native threads, no
            # GIL), drain any LANDED slabs and emit their completed
            # windows instead of blocking idle: the fast path's decode
            # + merged-emit work rides inside the load gaps that used
            # to be pure waiting (exact mode has no deferred work, so
            # this is a fast-path-only overlap win).  ready() preserves
            # window order, and the current window always yields later,
            # so output bytes cannot change.
            if slab_disp is not None:
                import concurrent.futures as _cf

                while not fut.done():
                    slab_disp.poll()
                    yield from slab_disp.ready()
                    # coarse poll: a tighter loop's GIL wakeups delay
                    # the load threads' completion callbacks
                    _cf.wait([fut], timeout=0.02)
            pu_t, pu_n, plan = fut.result()
        j = i + LOOKAHEAD
        if j < len(todo):
            inflight.append(_submit_window(todo[j][1]))
        if can_plan(pu_t, pu_n, packed16) and not (
            precision == "exact" and can_exact_native(pu_t, pu_n, ref_blob)
        ):
            # fast device path: windows feed the shared slab dispatcher
            if deferred is not None:  # mode-mix ordering guard
                yield _collect(deferred)
                deferred = None
            if slab_disp is None:
                slab_disp = SlabDispatcher(
                    dtabs, tabs, params, refcache, fmt=fmt,
                )
            if plan is None:
                plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off,
                                 prefilter, cns_mode="proof")
            slab_disp.add_window(wi, (tid, beg, end), pu_t, pu_n, plan,
                                 remaining=len(todo) - 1 - i)
            yield from slab_disp.ready()
            continue
        with _exact_cpu_ctx(precision):
            if precision == "exact" and can_exact_native(pu_t, pu_n,
                                                         ref_blob):
                records = exact_records_native(
                    pu_t, pu_n, tabs, ref_blob, ref_off, refcache,
                    prefilter, fmt=fmt, plan=plan,
                )
                pending = None
            else:
                drop_t = drop_n = None
                if prefilter:
                    drop_t, drop_n = _prefilter_flags(
                        pu_t, pu_n, ref_blob, ref_off, tabs
                    )
                pending = submit_batches(
                    pu_t, pu_n, refcache, dtabs(), precision, max_batch,
                    drop_t, drop_n, packed16, ref16_fn, params.cap_mapq,
                )
        if slab_disp is not None:  # mode-mix ordering guard
            yield from slab_disp.finish()
            slab_disp = None
        if deferred is not None:
            yield _collect(deferred)
            deferred = None
        if pending is None:
            yield wi, (tid, beg, end), [r for _, r in records]
        else:
            deferred = (wi, (tid, beg, end), pu_t, pu_n, pending)
    if slab_disp is not None:
        with STATS.timer("tail"):
            yield from slab_disp.finish()
    if deferred is not None:
        yield _collect(deferred)
    ex.shutdown(wait=True)


def call_pair_sharded(*args, **kwargs) -> Iterator[SniperRecord]:
    """Flattened record stream over :func:`call_pair_windows`."""
    for _, _, records in call_pair_windows(*args, **kwargs):
        yield from records


class Manifest:
    """Append-only per-window completion log for resumable runs.

    Each line: {"window": i, "offset": byte offset of the output file
    AFTER the window's records were flushed}.  On resume, the driver
    truncates the output to the last completed offset and skips the
    recorded windows — a crashed run loses at most one window.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.done: dict[int, int] = {}
        if self.path.exists():
            for ln in self.path.read_text().splitlines():
                try:
                    d = json.loads(ln)
                    self.done[int(d["window"])] = int(d["offset"])
                except (ValueError, KeyError):
                    continue

    def resume_offset(self) -> int | None:
        return max(self.done.values()) if self.done else None

    def mark(self, window: int, offset: int) -> None:
        self.done[window] = offset
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"window": window, "offset": offset}) + "\n")
