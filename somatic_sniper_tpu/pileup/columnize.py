"""Vectorized pileup columnarization: reads -> dense column batches.

Inverts the reference's pull-based linked-list pileup
(reference sniper_pileup.c:57-224): instead of advancing one reference
position at a time and re-walking CIGARs, every (read, CIGAR-run) pair is
expanded to per-column entries in one numpy pass, grouped by genomic
position, and padded into ``[B, D]`` tensors for the batched device kernel.

Replicated semantics:

* read ingestion filter: ``!(flag & flag_mask) && !(mapq < thresh)``
  (reference sniper_pileup.c:208)
* zero-reference-length reads never enter the buffer
  (end <= pos check, reference sniper_pileup.c:216)
* per-column read view: M runs contribute (base, qual) at the aligned
  query position; D runs contribute an ``is_del`` entry; N runs exclude
  the read from those columns entirely (resolve_cigar's ret=0,
  reference sniper_pileup.c:94-99); I/S consume query only; H/P and the
  post-0.1.6 '='/'X' ops are ignored exactly like samtools-0.1.6.
* a column exists for the caller when both samples have >= 1 entry
  (reference sniper_pileup.c:256).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple

import numpy as np

from ..constants import (
    BAM_DEF_MASK,
    BAM_FREVERSE,
    BAM_FUNMAP,
    CDEL,
    CINS,
    CMATCH,
    CREF_SKIP,
    CSOFT_CLIP,
)
from ..io.bam import BamReads


class ColumnarPileup(NamedTuple):
    """Per-sample column entries, sorted by (tid, pos) key.

    ``slots`` is the packed u32 per-entry encoding shared with the device
    kernel: ``mapQ | baseQ<<8 | base16<<16 | strand<<20 | is_del<<21``.
    """

    keys: np.ndarray | None  # int64 (tid << 40 | pos) per entry, sorted
    slots: np.ndarray        # uint32 packed entries
    ukeys: np.ndarray        # int64 unique column keys
    offsets: np.ndarray      # int64 [n_cols + 1] entry offsets per column
    owner: object = None     # keeps native-backed memory alive

    @property
    def depths(self) -> np.ndarray:
        return np.diff(self.offsets)


def unpack_slots(slots: np.ndarray):
    """slots -> (base16, baseq, mapq, strand, is_del) numpy arrays."""
    s = np.asarray(slots, np.uint32)
    return (
        (s >> 16) & 0xF,
        (s >> 8) & 0xFF,
        s & 0xFF,
        (s >> 20) & 1,
        ((s >> 21) & 1).astype(bool),
    )


def make_key(tid, pos):
    return (np.asarray(tid, np.int64) << 40) | np.asarray(pos, np.int64)


def split_key(keys):
    return (keys >> 40).astype(np.int32), (keys & ((1 << 40) - 1)).astype(
        np.int64
    )


def _ragged_arange(lengths: np.ndarray) -> np.ndarray:
    """[0..l0-1, 0..l1-1, ...] for the given segment lengths."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(lengths)
    return np.arange(total, dtype=np.int64) - np.repeat(
        ends - lengths, lengths
    )


def _read_end(reads: BamReads, r: int) -> int:
    """bam_calend (vendor bam.c:37-48): pos + M/D/N reference span."""
    runs = reads.cigar[reads.cigar_off[r] : reads.cigar_off[r + 1]]
    op = runs & 0xF
    ln = (runs >> 4).astype(np.int64)
    span = ln[(op == CMATCH) | (op == CDEL) | (op == CREF_SKIP)].sum()
    return int(reads.pos[r]) + int(span)


def _drop_contig_transition_reads(
    reads: BamReads, ridx: np.ndarray
) -> np.ndarray:
    """Replicate a reference pileup quirk (sniper_pileup.c:216): the first
    filter-passing read of each subsequent contig is silently dropped when
    its end is <= the buffer position reached on the previous contig (the
    ``end > pos`` ingestion check runs before the tid jump resets pos, and
    pos equals the start of the previous contig's last read at that
    moment)."""
    if len(ridx) < 2:
        return ridx
    tids = reads.tid[ridx]
    boundaries = np.nonzero(tids[1:] != tids[:-1])[0] + 1
    if len(boundaries) == 0:
        return ridx
    drop = []
    for j in boundaries:
        first_new = int(ridx[j])
        prev_last = int(ridx[j - 1])
        if _read_end(reads, first_new) <= int(reads.pos[prev_last]):
            drop.append(j)
    if drop:
        ridx = np.delete(ridx, drop)
    return ridx


def columnize(
    reads: BamReads,
    flag_mask: int = BAM_DEF_MASK,
    mapq_thresh: int = 0,
    window: tuple[int, int, int] | None = None,
) -> ColumnarPileup:
    """Expand filtered reads into per-column entries.

    ``window``: optional (tid, start, end) restriction — reads overlapping
    the window contribute only their in-window columns (halo handling for
    sharded processing).
    """
    fmask = BAM_FUNMAP | flag_mask
    keep = ((reads.flag.astype(np.int64) & fmask) == 0) & (
        reads.mapq >= mapq_thresh
    )
    ridx = np.nonzero(keep)[0]
    ridx = _drop_contig_transition_reads(reads, ridx)

    if window is not None:
        wtid, wstart, wend = window
    # Per-read CIGAR runs
    n_cig = reads.n_cigar[ridx].astype(np.int64)
    run_read = np.repeat(ridx, n_cig)                # read index per run
    ci = reads.cigar_off[ridx]
    flat_idx = np.repeat(ci, n_cig) + _ragged_arange(n_cig)
    runs = reads.cigar[flat_idx]
    op = (runs & 0xF).astype(np.int32)
    ln = (runs >> 4).astype(np.int64)

    consumes_ref = (op == CMATCH) | (op == CDEL) | (op == CREF_SKIP)
    consumes_query = (op == CMATCH) | (op == CINS) | (op == CSOFT_CLIP)

    # x_start / y_start per run via segmented exclusive cumsum
    ref_len = np.where(consumes_ref, ln, 0)
    q_len = np.where(consumes_query, ln, 0)

    def seg_excl_cumsum(vals, seg_read):
        """Exclusive cumulative sum within each run of equal seg_read."""
        if len(vals) == 0:
            return np.zeros(0, dtype=np.int64)
        cs = np.cumsum(vals)
        seg_change = np.empty(len(vals), dtype=bool)
        seg_change[0] = True
        seg_change[1:] = seg_read[1:] != seg_read[:-1]
        seg_starts = np.nonzero(seg_change)[0]
        before_seg = np.repeat(cs[seg_starts] - vals[seg_starts],
                               np.diff(np.append(seg_starts, len(vals))))
        return cs - vals - before_seg

    x_rel = seg_excl_cumsum(ref_len, run_read)
    y_rel = seg_excl_cumsum(q_len, run_read)
    x0 = reads.pos[run_read].astype(np.int64) + x_rel
    y0 = y_rel

    # keep only M and D runs; drop reads with zero reference footprint is
    # implicit (they produce no M/D runs)
    is_m = op == CMATCH
    is_d = op == CDEL
    sel = is_m | is_d
    if window is not None:
        # clip runs to the window
        tid_run = reads.tid[run_read]
        sel &= tid_run == wtid
    run_read, x0, y0, ln = run_read[sel], x0[sel], y0[sel], ln[sel]
    del_run = is_d[sel]

    if window is not None:
        clip_lo = np.maximum(x0, wstart)
        clip_hi = np.minimum(x0 + ln, wend)
        adv = clip_lo - x0
        y0 = y0 + np.where(del_run, 0, adv)
        ln2 = clip_hi - clip_lo
        x0 = clip_lo
        keep_run = ln2 > 0
        run_read = run_read[keep_run]
        x0, y0 = x0[keep_run], y0[keep_run]
        ln = ln2[keep_run]
        del_run = del_run[keep_run]

    # expand runs to per-column entries
    within = _ragged_arange(ln)
    e_read = np.repeat(run_read, ln)
    e_del = np.repeat(del_run, ln)
    e_col = np.repeat(x0, ln) + within
    e_qpos = np.repeat(y0, ln) + np.where(e_del, 0, within)

    # field gathers + slot packing
    so = reads.seq_off[e_read]
    max_q = np.maximum(reads.l_qseq[e_read].astype(np.int64) - 1, 0)
    qp = np.minimum(e_qpos, max_q)  # clamp (del entries never read fields)
    # base/qual are never read for deletion entries; zero them so the
    # packed form is canonical (matches the native pileup byte-for-byte)
    not_del = (~e_del).astype(np.uint32)
    slots = (
        reads.mapq[e_read].astype(np.uint32)
        | ((reads.qual[so + qp].astype(np.uint32) * not_del) << 8)
        | ((reads.seq[so + qp].astype(np.uint32) * not_del) << 16)
        | (((reads.flag[e_read] & BAM_FREVERSE) != 0).astype(np.uint32) << 20)
        | (e_del.astype(np.uint32) << 21)
    )

    keys = make_key(reads.tid[e_read], e_col)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    ukeys, first = np.unique(keys, return_index=True)
    offsets = np.append(first, len(keys)).astype(np.int64)

    return ColumnarPileup(
        keys=keys,
        slots=slots[order],
        ukeys=ukeys,
        offsets=offsets,
    )


# Depth-axis padding buckets.  Finer steps through the 16-128 range
# matter: at 30x coverage the shared-column depth distribution is tight
# (p25~29, p99~44 on the bench pair), and every padded slot is wasted
# upload bandwidth on hosts where the accelerator link is the
# end-to-end bottleneck.  The Pallas kernel lane-packs each bucket up
# to the next power of two internally, so intermediate sizes cost no
# extra compute — only fewer transfer bytes.
DEPTH_BUCKETS = (8, 16, 24, 32, 40, 48, 64, 96, 128, 256, 512, 1024,
                 2048, 4096, 8192)


def bucket_for(depth: int) -> int:
    for b in DEPTH_BUCKETS:
        if depth <= b:
            return b
    return int(depth)


class PairedBatch(NamedTuple):
    """One dense batch of intersected tumor/normal columns.

    When built with ``packed16`` (the device fast path), ``tumor``/
    ``normal`` are compact u16 slot arrays holding only non-deleted
    entries (effq | base2<<8 | strand<<10) and the per-column keep
    counts / RMS-mapQ sums ride along — half the transfer bytes of the
    u32 encoding, which matters on hosts where the accelerator link is
    the bottleneck.
    """

    keys: np.ndarray         # [B] int64 column keys
    ref16: np.ndarray        # [B] int32 (filled by caller)
    tumor: np.ndarray        # [B, D] packed u32 (or u16) slots
    normal: np.ndarray       # [B, D] packed u32 (or u16) slots
    n_tumor: np.ndarray      # [B] total entry counts (incl. is_del)
    n_normal: np.ndarray
    nk_tumor: np.ndarray | None = None   # [B] non-deleted counts (u16 mode)
    nk_normal: np.ndarray | None = None
    rms_tumor: np.ndarray | None = None  # [B] sum min(mapq&0x7F,cap)^2
    rms_normal: np.ndarray | None = None

    @property
    def packed16(self) -> bool:
        return self.nk_tumor is not None


def _pad_columns(pu: ColumnarPileup, col_idx: np.ndarray, D: int) -> np.ndarray:
    """Scatter the selected columns' packed u32 slots into a [B, D] array."""
    if pu.owner is not None and hasattr(pu.owner, "pad"):
        return pu.owner.pad(col_idx, D)
    counts = pu.depths[col_idx]
    starts = pu.offsets[col_idx]
    B = len(col_idx)
    rows = np.repeat(np.arange(B, dtype=np.int64), counts)
    cols = _ragged_arange(counts)
    src = np.repeat(starts, counts) + cols
    slots = np.zeros((B, D), np.uint32)
    slots[rows, cols] = pu.slots[src]
    return slots


def _pad_columns16(
    pu: ColumnarPileup, col_idx: np.ndarray, ref16: np.ndarray, D: int,
    cap_mapq: int,
):
    """(slots u16[B,D], n_keep i32[B], rms i32[B]) — compact fast-path
    padding; numpy fallback value-identical to native pileup_pad16."""
    if pu.owner is not None and hasattr(pu.owner, "pad16"):
        return pu.owner.pad16(col_idx, ref16, D, cap_mapq)
    counts = pu.depths[col_idx]
    starts = pu.offsets[col_idx]
    B = len(col_idx)
    rows = np.repeat(np.arange(B, dtype=np.int64), counts)
    src = np.repeat(starts, counts) + _ragged_arange(counts)
    s = pu.slots[src].astype(np.uint32)
    keep = ((s >> 21) & 1) == 0
    mq = (s & 0xFF).astype(np.int32)
    q = ((s >> 8) & 0xFF).astype(np.int32)
    b16 = (s >> 16) & 0xF
    strand = (s >> 20) & 1
    code = np.where(b16 != 0, b16, ref16[rows].astype(np.uint32))
    base2 = np.zeros(len(s), np.uint32)
    for c16, c4 in ((2, 1), (4, 2), (8, 3)):
        base2 = np.where(code == c16, c4, base2)
    eff = np.minimum(q, mq)
    eff = np.where((eff < 4) & ((q & 0x3F) != 0), 4, eff)
    val16 = (eff.astype(np.uint32) | (base2 << 8) | (strand << 10))

    # within-column position among keep entries
    cs = np.cumsum(keep)
    col_start_idx = np.cumsum(counts) - counts
    start = np.zeros(B, np.int64)
    nz = counts > 0
    first = col_start_idx[nz]
    start[nz] = cs[first] - keep[first]
    kpos = (cs - keep) - start[rows]

    out = np.zeros((B, D), np.uint16)
    m = keep & (kpos < D)
    out[rows[m], kpos[m]] = val16[m].astype(np.uint16)
    nk = np.bincount(rows[keep], minlength=B).astype(np.int32)
    m7 = np.minimum(mq & 0x7F, cap_mapq)
    rms = np.bincount(
        rows[keep], weights=(m7 * m7)[keep].astype(np.float64), minlength=B
    ).astype(np.int32)
    return out, nk, rms


def paired_batches(
    tumor: ColumnarPileup,
    normal: ColumnarPileup,
    max_batch: int = 65536,
    drop_tumor: np.ndarray | None = None,
    drop_normal: np.ndarray | None = None,
    packed16: bool = False,
    ref16_fn=None,
    cap_mapq: int = 60,
) -> Iterator[PairedBatch]:
    """Intersect non-empty columns of both samples and yield dense batches
    bucketed by depth (keeps XLA shape variety bounded).

    ``drop_tumor``/``drop_normal``: optional uint8 flags aligned with each
    sample's ``ukeys`` (see pileup.prefilter); a shared column is skipped
    when both samples flag it as provably non-emittable.

    ``packed16``: build compact u16 fast-path batches (requires
    ``ref16_fn``, a ``keys -> int32[B]`` reference-code lookup used both
    for '='-base resolution and the batch's ref16 field).
    """
    shared, ti, ni = np.intersect1d(
        tumor.ukeys, normal.ukeys, assume_unique=True, return_indices=True
    )
    if drop_tumor is not None and drop_normal is not None and len(shared):
        keep = ~((drop_tumor[ti] != 0) & (drop_normal[ni] != 0))
        shared, ti, ni = shared[keep], ti[keep], ni[keep]
    if len(shared) == 0:
        return
    d_t = tumor.depths[ti]
    d_n = normal.depths[ni]
    dmax = np.maximum(d_t, d_n)
    bucket_of = np.searchsorted(np.array(DEPTH_BUCKETS), dmax)
    bucket_of = np.minimum(bucket_of, len(DEPTH_BUCKETS) - 1)
    oversize = dmax > DEPTH_BUCKETS[-1]

    def _make(sub, D):
        keys = shared[sub]
        ref16 = (
            ref16_fn(keys).astype(np.int32) if ref16_fn is not None
            else np.zeros(len(sub), np.int32)
        )
        kw = {}
        if packed16:
            t16, nk_t, rms_t = _pad_columns16(
                tumor, ti[sub], ref16, D, cap_mapq
            )
            n16, nk_n, rms_n = _pad_columns16(
                normal, ni[sub], ref16, D, cap_mapq
            )
            kw = dict(nk_tumor=nk_t, nk_normal=nk_n,
                      rms_tumor=rms_t, rms_normal=rms_n)
            pt, pn = t16, n16
        else:
            pt = _pad_columns(tumor, ti[sub], D)
            pn = _pad_columns(normal, ni[sub], D)
        return PairedBatch(
            keys=keys,
            ref16=ref16,
            tumor=pt,
            normal=pn,
            n_tumor=d_t[sub].astype(np.int32),
            n_normal=d_n[sub].astype(np.int32),
            **kw,
        )

    for bi in range(len(DEPTH_BUCKETS)):
        mask = (bucket_of == bi) & ~oversize
        idx = np.nonzero(mask)[0]
        D = DEPTH_BUCKETS[bi]
        for s in range(0, len(idx), max_batch):
            yield _make(idx[s : s + max_batch], D)
    # oversize columns: one batch each at their own depth
    for i in np.nonzero(oversize)[0]:
        yield _make(np.array([i]), int(dmax[i]))
