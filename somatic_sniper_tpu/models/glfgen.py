"""Batched MAQ genotype-likelihood generation (glfgen) in JAX.

Re-implements the per-column likelihood model of the reference
(``sniper_maqcns_glfgen``, reference sniper_maqcns.c:127-248) as a dense
batched computation over ``[B, D]`` pileup-column tensors.

Two precision modes share the same structure:

* ``exact``  — bit-for-bit replication of the C code's mixed float/double
  arithmetic (float32 accumulators updated through float64 ops, float64
  table lookups, C rounding/truncation semantics).  Requires an x64-enabled
  JAX backend (CPU).  Used for golden-output parity and as the oracle for
  the fast path.
* ``fast``   — float32 throughout, fully vectorized (no sequential scan),
  with every table lookup a gather.  Produces u8 likelihoods that match the
  exact path except when a value lands within float rounding distance of a
  0.5 quantization boundary (measured < 1e-4 of columns).

Column slot encoding (host-side pileup produces these arrays):
    base16  [B, D] int32   4-bit IUB base code at this column
    baseq   [B, D] int32   base quality (u8)
    mapq    [B, D] int32   mapping quality (u8)
    strand  [B, D] int32   0 fwd / 1 rev
    is_del  [B, D] bool    position falls in a deletion of this read
    valid   [B, D] bool    slot occupied (depth padding mask)
    ref16   [B]    int32   4-bit IUB code of the reference base
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


F32 = jnp.float32
F64 = jnp.float64
I32 = jnp.int32


class GlfResult(NamedTuple):
    """Mirror of glf1_t (vendor glf.h:4-9) plus the aux read count."""

    lk: jax.Array        # [B, 10] int32 (u8 range), genotype likelihoods
    min_lk: jax.Array    # [B] int32
    depth: jax.Array     # [B] int32, non-deleted read count
    rms_mapq: jax.Array  # [B] int32 (u8 range)


class ColumnBatch(NamedTuple):
    """Dense pileup-column batch in packed-slot form.

    Default (u32) encoding — one entry per (column, read):
    ``mapQ | baseQ<<8 | base16<<16 | strand<<20 | is_del<<21``, with the
    first ``depth[b]`` slots of row b occupied (host packs contiguously).
    This single-word layout is what the host pileup emits and what is
    uploaded to the device — 1/6th the bytes of a struct-of-arrays batch.

    Raw kept-only (u32 + ``n_keep``) fast-path encoding — the
    production slab layout: full slot words but with the deletion
    entries already filtered out by the host fill (first ``n_keep[b]``
    lanes of row b occupied, is_del bit never set).  ``depth`` still
    carries the raw column depth (incl. deletions) for the consensus
    model; rms is computed on device from the lanes.  Raw base codes
    and qualities make the on-device dqstats computation possible
    (models.somatic._device_dqstats).

    Compact (u16) fast-path encoding — when ``n_keep`` is present and
    ``slots`` is uint16: ``effq | base2<<8 | strand<<10`` holding only
    the non-deleted entries, with the per-column RMS-mapQ sums riding
    in ``rms_sum``.  Reads of equal (class, effq) are interchangeable
    under the MAQ rank weighting, so this halved encoding loses nothing
    the f32 path can observe; the exact (f64) path requires the full
    u32 form.
    """

    slots: jax.Array   # [B, D] uint32 (or uint16, see above)
    depth: jax.Array   # [B] int32 occupied slot count (incl. deletions)
    ref16: jax.Array   # [B] int32
    n_keep: jax.Array | None = None   # [B] int32 non-deleted entry count
    rms_sum: jax.Array | None = None  # [B] int32 sum min(mapq&0x7F,cap)^2


SLOT_MAPQ_SHIFT = 0
SLOT_BASEQ_SHIFT = 8
SLOT_BASE16_SHIFT = 16
SLOT_STRAND_SHIFT = 20
SLOT_ISDEL_SHIFT = 21


def pack_slots_np(base16, baseq, mapq, strand, is_del):
    """Host-side slot packing (numpy)."""
    return (
        np.asarray(mapq, np.uint32)
        | (np.asarray(baseq, np.uint32) << SLOT_BASEQ_SHIFT)
        | (np.asarray(base16, np.uint32) << SLOT_BASE16_SHIFT)
        | (np.asarray(strand, np.uint32) << SLOT_STRAND_SHIFT)
        | (np.asarray(is_del, np.uint32) << SLOT_ISDEL_SHIFT)
    )


def pack_info(cols: ColumnBatch) -> tuple[jax.Array, jax.Array]:
    """Build the per-read sort keys of the reference's aux array.

    reference sniper_maqcns.c:144-156: for each non-deleted read,
    ``x = effQ<<24 | valid<<21 | strand<<18 | base2<<16 | baseQ<<8 | mapQ``
    with ``effQ = min(baseQ, mapQ)`` and ``base2`` the 2-bit base (only when
    the base is unambiguous; '=' resolves to the reference base).

    Returns (info [B, D] uint32 sort keys with invalid slots set to
    0xFFFFFFFF — unreachable for real reads since bits 19-20/22-23 of the
    packing are never set — and n [B] count of participating reads).
    """
    s = cols.slots
    B, D = s.shape
    j_idx = jax.lax.broadcasted_iota(I32, (B, D), 1)
    occupied = j_idx < cols.depth[:, None]
    is_del = ((s >> SLOT_ISDEL_SHIFT) & 1).astype(jnp.bool_)
    keep = occupied & ~is_del

    mapq = (s & 0xFF).astype(I32)
    q = ((s >> SLOT_BASEQ_SHIFT) & 0xFF).astype(I32)
    strand = ((s >> SLOT_STRAND_SHIFT) & 1).astype(I32)
    qq = ((s >> SLOT_BASE16_SHIFT) & 0xF).astype(I32)

    x = (strand << 18) | (q << 8) | mapq
    eff = jnp.minimum(q, mapq)
    x = x | (eff << 24)
    # nt16 -> nt4 via selects (no gather): A=1->0, C=2->1, G=4->2, T=8->3
    code = jnp.where(qq != 0, qq, cols.ref16[:, None])
    base2 = jnp.full_like(code, 4)
    for c16, c4 in ((1, 0), (2, 1), (4, 2), (8, 3)):
        base2 = jnp.where(code == c16, c4, base2)
    has_base = base2 < 4
    x = jnp.where(has_base, x | (1 << 21) | (base2 << 16), x)

    key = jnp.where(
        keep, x.astype(jnp.uint32), jnp.uint32(0xFFFFFFFF)
    )
    n = keep.sum(axis=1).astype(I32)
    return key, n


def _exact_accumulate(info_sorted, n, fk64, cap_mapq, max_w=255):
    """Sequential descending scan replicating sniper_maqcns.c:160-176.

    Returns (esum f32[B,4], fsum f32[B,4], c i32[B,4], rms i64[B]).
    The scan runs from the highest sort position downward so that the
    highest-quality read of each (base, strand) class receives fk[0].
    """
    B, D = info_sorted.shape
    fk = jnp.asarray(fk64, dtype=F64)

    def step(carry, j):
        esum, fsum, c, w, rms = carry
        info = info_sorted[:, j]
        alive = j < n  # [B]

        effq = (info >> 24).astype(I32)
        low6 = ((info >> 8) & 0x3F).astype(I32)
        # effective-quality floor (reference sniper_maqcns.c:165)
        effq = jnp.where((effq < 4) & (low6 != 0), 4, effq)
        k8 = ((info >> 16) & 7).astype(I32)       # (base | strand<<2) class
        k4 = k8 & 3

        upd = alive & (effq > 0)
        oh8 = (jax.nn.one_hot(k8, 8, dtype=I32) * upd[:, None].astype(I32))
        oh4 = (jax.nn.one_hot(k4, 4, dtype=I32) * upd[:, None].astype(I32))

        w_k = jnp.take_along_axis(w, k8[:, None], axis=1)[:, 0]
        fkw = fk[jnp.clip(w_k, 0, max_w)]          # f64 [B]

        # float32 accumulators updated via float64 ops (C: float += double)
        d_esum = oh4.astype(F64) * (fkw * effq.astype(F64))[:, None]
        d_fsum = oh4.astype(F64) * fkw[:, None]
        esum = (esum.astype(F64) + d_esum).astype(F32)
        fsum = (fsum.astype(F64) + d_fsum).astype(F32)
        c = c + oh4
        w = w + oh8 * (w < max_w).astype(I32)

        tmp = jnp.minimum((info & 0x7F).astype(I32), cap_mapq)
        rms = rms + jnp.where(alive, (tmp * tmp).astype(jnp.int64), 0)
        return (esum, fsum, c, w, rms), None

    init = (
        jnp.zeros((B, 4), F32),
        jnp.zeros((B, 4), F32),
        jnp.zeros((B, 4), I32),
        jnp.zeros((B, 8), I32),
        jnp.zeros((B,), jnp.int64),
    )
    (esum, fsum, c, w, rms), _ = jax.lax.scan(
        step, init, jnp.arange(D - 1, -1, -1)
    )
    return esum, fsum, c, rms


def _fast_accumulate(info, n, theta, eta, cap_mapq, max_w=255):
    """Vectorized float32 version of the descending-rank accumulation.

    The fk weight of a read equals fk[r] where r is the number of
    higher-key reads of the same (base, strand) class whose (floored)
    effQ is > 0 (the reference's ``w[k]`` counter only increments for
    those; sniper_maqcns.c:162-175).  Instead of materializing [B, D, 8]
    one-hot tensors, entries are re-sorted class-major / key-descending:
    within a class the global key order reduces to the 25-bit
    (effQ, valid, baseQ, mapQ) sub-key, so ``class<<26 | ~subkey`` is a
    single uint32 sort after which ranks fall out of one [B, D] cumsum.

    ``info`` is the *unsorted* packed key array (pads = 0xFFFFFFFF).
    """
    B, D = info.shape
    j_idx = jax.lax.broadcasted_iota(I32, (B, D), 1)

    # order-independent pieces straight from the unsorted keys
    alive0 = info != jnp.uint32(0xFFFFFFFF)
    mq0 = jnp.minimum((info & 0x7F).astype(I32), cap_mapq)
    rms = jnp.where(alive0, mq0 * mq0, 0).sum(axis=1)

    # class-major, key-descending composite sort key (29 bits)
    effq0 = (info >> 24).astype(I32)
    valid0 = ((info >> 21) & 1).astype(I32)
    baseq0 = ((info >> 8) & 0xFF).astype(I32)
    mapq0 = (info & 0xFF).astype(I32)
    k8_0 = ((info >> 16) & 7).astype(I32)
    ck = (effq0 << 17) | (valid0 << 16) | (baseq0 << 8) | mapq0
    key2 = (k8_0.astype(jnp.uint32) << 26) | (
        jnp.uint32((1 << 25) - 1) - ck.astype(jnp.uint32)
    )
    key2 = jnp.where(alive0, key2, jnp.uint32(0xFFFFFFFF))
    key2 = jnp.sort(key2, axis=1)

    alive = j_idx < n[:, None]
    k8 = (key2 >> 26).astype(I32) & 7
    inv = (key2 & ((1 << 26) - 1)).astype(I32)
    ck_s = ((1 << 25) - 1) - inv
    effq = ck_s >> 17
    low6 = (ck_s >> 8) & 0x3F
    effq = jnp.where((effq < 4) & (low6 != 0), 4, effq)
    k4 = k8 & 3
    upd = alive & (effq > 0)

    # within-class rank among upd entries = the reference's w[k] at visit
    cs_excl = jnp.cumsum(upd.astype(I32), axis=1) - upd.astype(I32)
    class_cnt = jnp.stack(
        [((k8 == k) & alive).sum(axis=1) for k in range(8)], axis=1
    )  # [B, 8] per-class totals (alive, incl. non-upd)
    seg_start = jnp.cumsum(class_cnt, axis=1) - class_cnt
    # cs_excl at each class's segment start, spread back to its entries
    cs_at_start = _take_rows(cs_excl, jnp.minimum(seg_start, D - 1))
    rank = cs_excl - _take_rows(cs_at_start, k8)

    # fk[r] = theta^r*(1-eta)+eta computed in-register (fast path only;
    # ~1 ulp from the f64 table, same order as the path's f32 noise)
    theta32 = np.float32(theta)
    eta32 = np.float32(eta)
    r = jnp.clip(rank, 0, max_w).astype(F32)
    log_theta = np.float32(np.log(np.float64(theta32))) if theta32 > 0 else \
        np.float32(-1e30)
    fkw = (
        jnp.exp(r * log_theta) * (np.float32(1.0) - eta32) + eta32
    ) * upd.astype(F32)
    eterm = fkw * effq.astype(F32)
    esum = jnp.stack(
        [jnp.where(k4 == b, eterm, 0.0).sum(axis=1) for b in range(4)],
        axis=1,
    )
    fsum = jnp.stack(
        [jnp.where(k4 == b, fkw, 0.0).sum(axis=1) for b in range(4)],
        axis=1,
    )
    c = jnp.stack(
        [(upd & (k4 == b)).sum(axis=1) for b in range(4)], axis=1
    ).astype(I32)
    return esum, fsum, c, rms


def _fast_accumulate16(slots16, n_keep, theta, eta, max_w=255):
    """XLA fast-path accumulation over the compact u16 encoding.

    Only (class, effq) survive in the u16 slots; within a class, equal
    effq makes reads interchangeable, so a class-major / effq-descending
    sort reproduces the reference's fk rank weighting exactly (see
    _fast_accumulate for the u32 derivation).  rms/n are host-computed
    and live in ColumnBatch, so only esum/fsum/c come from here.
    """
    B, D = slots16.shape
    s = slots16.astype(I32)
    j_idx = jax.lax.broadcasted_iota(I32, (B, D), 1)
    occupied = j_idx < n_keep[:, None]
    eff0 = s & 0xFF
    base2 = (s >> 8) & 3
    strand = (s >> 10) & 1
    k8_0 = strand * 4 + base2
    upd0 = occupied & (eff0 > 0)

    # class-major, effq-descending composite key; non-upd entries pad
    key = (k8_0 << 9) | (255 - eff0)
    key = jnp.where(upd0, key, (1 << 14) - 1)
    key = jnp.sort(key, axis=1)
    valid = key != (1 << 14) - 1
    k8 = jnp.where(valid, key >> 9, 7)
    eff = jnp.where(valid, 255 - (key & 0x1FF), 0)
    k4 = k8 & 3

    # rank within class = position - class segment start
    cs_excl = jnp.cumsum(valid.astype(I32), axis=1) - valid.astype(I32)
    class_cnt = jnp.stack(
        [((k8 == k) & valid).sum(axis=1) for k in range(8)], axis=1
    )
    seg_start = jnp.cumsum(class_cnt, axis=1) - class_cnt
    rank = cs_excl - _take_rows(seg_start, k8)

    theta32 = np.float32(theta)
    eta32 = np.float32(eta)
    log_theta = np.float32(np.log(np.float64(theta32))) if theta32 > 0 \
        else np.float32(-1e30)
    r = jnp.clip(rank, 0, max_w).astype(F32)
    fkw = (
        jnp.exp(r * log_theta) * (np.float32(1.0) - eta32) + eta32
    ) * valid.astype(F32)
    eterm = fkw * eff.astype(F32)
    esum = jnp.stack(
        [jnp.where(k4 == b, eterm, 0.0).sum(axis=1) for b in range(4)],
        axis=1,
    )
    fsum = jnp.stack(
        [jnp.where(k4 == b, fkw, 0.0).sum(axis=1) for b in range(4)],
        axis=1,
    )
    c = jnp.stack(
        [(valid & (k4 == b)).sum(axis=1) for b in range(4)], axis=1
    ).astype(I32)
    return esum, fsum, c


def _c_trunc_half(x64):
    """C ``(int)(x + 0.5)`` on a nonnegative double: truncate toward zero."""
    return jnp.floor(x64 + 0.5).astype(I32)


def _take_rows(table, idx):
    """``table[b, idx[b, j]]`` for a [B, K] table and [B, J] indices."""
    return jnp.take_along_axis(table, idx, axis=1)


def _coef_at(coef, bar_e, c_tot, tmp2):
    """``coef[bar_e, c_tot, tmp2]`` per term: [B, T] indices, [B] c_tot."""
    return coef[bar_e, c_tot[:, None], tmp2]


def _lhet_at(lhet, cj, ck):
    """``lhet[cj, ck]`` per term: [B, T] indices."""
    return lhet[cj, ck]


@partial(
    jax.jit,
    static_argnames=("precision", "cap_mapq", "theta", "eta"),
)
def glfgen_batch(
    cols: ColumnBatch,
    fk64,
    coef64,
    lhet64,
    precision: str = "exact",
    cap_mapq: int = 60,
    theta: float = 0.85,
    eta: float = 0.03,
) -> GlfResult:
    """Batched sniper_maqcns_glfgen (reference sniper_maqcns.c:127-248).

    ``theta``/``eta`` are only used by the fast path's in-register fk
    computation; the exact path reads the float64 ``fk64`` table.  Every
    table lookup is a gather, so no matmul (and no TF32 rounding) can
    touch the result.
    """
    acc_f = F64 if precision == "exact" else F32

    if precision == "exact":
        if cols.n_keep is not None:
            raise ValueError(
                "the exact path needs the u32 slot encoding "
                "(u16 batches are fast-path only)"
            )
        info, n = pack_info(cols)
        info_sorted = jnp.sort(info, axis=1)
        esum, fsum, c, rms = _exact_accumulate(info_sorted, n, fk64, cap_mapq)
        coef = jnp.asarray(coef64, dtype=F64)
        lhet = jnp.asarray(lhet64, dtype=F64)
    else:
        if cols.n_keep is not None and cols.slots.dtype == jnp.uint32:
            # raw kept-only u32 lanes (the production slab encoding):
            # each lane is a slot word with the deletion entries already
            # filtered by the host fill, so the occupancy bound is
            # n_keep and rms comes from the lanes
            view = ColumnBatch(slots=cols.slots, depth=cols.n_keep,
                               ref16=cols.ref16)
            info, _n = pack_info(view)
            esum, fsum, c, rms = _fast_accumulate(
                info, cols.n_keep, theta, eta, cap_mapq
            )
            n = cols.n_keep
        elif cols.n_keep is not None:  # compact u16 encoding
            esum, fsum, c = _fast_accumulate16(
                cols.slots, cols.n_keep, theta, eta
            )
            rms = cols.rms_sum
            n = cols.n_keep
        else:
            info, n = pack_info(cols)
            esum, fsum, c, rms = _fast_accumulate(
                info, n, theta, eta, cap_mapq
            )
        coef = jnp.asarray(coef64, dtype=F32)
        lhet = jnp.asarray(lhet64, dtype=F32)

    B = esum.shape[0]
    nz = n > 0
    n_safe = jnp.maximum(n, 1)

    # rms mapQ (reference sniper_maqcns.c:176)
    rms_mapq = jnp.floor(
        jnp.sqrt(rms.astype(acc_f) / n_safe.astype(acc_f)) + acc_f(0.499)
    ).astype(I32)
    rms_mapq = jnp.where(nz, rms_mapq, 0)

    # depth rescale of c[] (reference sniper_maqcns.c:178-182)
    c_tot = c.sum(axis=1)
    scale_needed = c_tot > 255
    c_scaled = _c_trunc_half(
        acc_f(254.0) * c.astype(acc_f) / jnp.maximum(c_tot, 1)[:, None].astype(acc_f)
    )
    c = jnp.where(scale_needed[:, None], c_scaled, c)
    c_tot = jnp.where(scale_needed, c.sum(axis=1), c_tot)

    # likelihood assembly (reference sniper_maqcns.c:184-214)
    # p is a [B, 4, 4] symmetric matrix in float32.
    p = jnp.zeros((B, 4, 4), F32)

    def others_sum(vals, excl):
        """f32 left-to-right sum over k not in excl, ascending k (C order)."""
        t = jnp.zeros((B,), vals.dtype)
        for k in range(4):
            if k in excl:
                continue
            t = t + vals[:, k]
        return t

    def others_sum_i(vals, excl):
        t = jnp.zeros((B,), I32)
        for k in range(4):
            if k in excl:
                continue
            t = t + vals[:, k]
        return t

    def bar_e_of(tmp1, tmp3, tmp2):
        ratio = jnp.where(tmp2 > 0, tmp1 / jnp.where(tmp3 == 0, 1, tmp3), 0)
        be = _c_trunc_half(ratio.astype(acc_f))
        return jnp.clip(be, 4, 63)

    triu_jk = [(j, k) for j in range(4) for k in range(j, 4)]
    tmp1a = jnp.stack(
        [others_sum(esum, (j,) if j == k else (j, k)) for j, k in triu_jk],
        axis=1,
    )
    tmp3a = jnp.stack(
        [others_sum(fsum, (j,) if j == k else (j, k)) for j, k in triu_jk],
        axis=1,
    )
    tmp2a = jnp.stack(
        [others_sum_i(c, (j,) if j == k else (j, k)) for j, k in triu_jk],
        axis=1,
    )
    bar_ea = bar_e_of(tmp1a, tmp3a, tmp2a)
    # all ten genotype terms in one batched lookup (term axis t)
    coefa = _coef_at(coef, bar_ea, c_tot, tmp2a)  # [B, 10]
    het_jk = [(j, k) for j, k in triu_jk if j != k]
    lheta = _lhet_at(
        lhet,
        jnp.stack([c[:, j] for j, _ in het_jk], axis=1),
        jnp.stack([c[:, k] for _, k in het_jk], axis=1),
    )  # [B, 6]

    hi_t = 0
    for t, (j, k) in enumerate(triu_jk):
        tmp1 = tmp1a[:, t]
        tmp2 = tmp2a[:, t]
        cf = coefa[:, t]
        if j == k:
            hom = (tmp1.astype(acc_f) + cf).astype(F32)
            hom = jnp.where(tmp2 > 0, hom, F32(0.0))
            p = p.at[:, j, j].set(hom)
        else:
            lh = acc_f(-4.343) * lheta[:, hi_t]
            hi_t += 1
            het_full = ((lh + tmp1.astype(acc_f)) + cf).astype(F32)
            het_empty = lh.astype(F32)
            het = jnp.where(tmp2 > 0, het_full, het_empty)
            p = p.at[:, j, k].set(het)
            p = p.at[:, k, j].set(het)

    # negative clamp (reference sniper_maqcns.c:212-213; every entry is
    # written before its row's clamp runs, so a single global clamp at the
    # end is equivalent)
    p = jnp.maximum(p, F32(0.0))

    # "fix p[k,k]" best-base adjustment (reference sniper_maqcns.c:216-233),
    # with the C scan's exact tie semantics (strict >/<, first index wins).
    max1 = jnp.full((B,), -1.0, F32)
    max2 = jnp.full((B,), -1.0, F32)
    max_k = jnp.full((B,), -1, I32)
    for k in range(4):
        e_k = esum[:, k]
        gt1 = e_k > max1
        gt2 = (~gt1) & (e_k > max2)
        max2 = jnp.where(gt1, max1, jnp.where(gt2, e_k, max2))
        max1 = jnp.where(gt1, e_k, max1)
        max_k = jnp.where(gt1, k, max_k)
    min1 = jnp.full((B,), 1e30, F32)
    min2 = jnp.full((B,), 1e30, F32)
    min_k = jnp.full((B,), -1, I32)
    for k in range(4):
        d_k = p[:, k, k]
        lt1 = d_k < min1
        lt2 = (~lt1) & (d_k < min2)
        min2 = jnp.where(lt1, min1, jnp.where(lt2, d_k, min2))
        min1 = jnp.where(lt1, d_k, min1)
        min_k = jnp.where(lt1, k, min_k)
    fix = (max1 > max2) & (
        (min_k != max_k) | (min1.astype(acc_f) + 1.0 > min2.astype(acc_f))
    )
    fixed_val = jnp.where(
        min1.astype(acc_f) > 1.0, (min1.astype(acc_f) - 1.0).astype(F32), F32(0.0)
    )
    diag = jnp.arange(4)
    onehot_mk = max_k[:, None] == diag[None, :]
    new_diag = jnp.where(fix[:, None] & onehot_mk, fixed_val[:, None],
                         p[:, diag, diag])
    p = p.at[:, diag, diag].set(new_diag)

    # quantization to glf1_t (reference sniper_maqcns.c:236-244)
    triu = [(j, k) for j in range(4) for k in range(j, 4)]
    p10 = jnp.stack([p[:, j, k] for j, k in triu], axis=1)  # [B, 10]
    min_p = jnp.min(
        jnp.where(jnp.isnan(p10), jnp.inf, p10), axis=1
    )  # C scan with < comparisons; NaN cannot occur but guard pads
    min_lk = jnp.where(
        min_p.astype(acc_f) > 255.0, 255, _c_trunc_half(min_p.astype(acc_f))
    )
    dlk = p10 - min_p[:, None]  # f32 subtraction as in C
    lk = jnp.where(
        dlk.astype(acc_f) > 255.0, 255, _c_trunc_half(dlk.astype(acc_f))
    )

    # empty columns: calloc'd glf (reference sniper_maqcns.c:131-136)
    lk = jnp.where(nz[:, None], lk, 0)
    min_lk = jnp.where(nz, min_lk, 0)
    depth = jnp.minimum(n, 16777215)

    return GlfResult(lk=lk, min_lk=min_lk, depth=depth, rms_mapq=rms_mapq)
