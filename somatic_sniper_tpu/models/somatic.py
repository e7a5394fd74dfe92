"""End-to-end batched somatic calling over pileup-column tensors.

Fuses glfgen + consensus + somatic scoring + emission gating into one
jittable function over ``[B, D]`` column batches — the batched
re-design of the reference's per-column callback ``glf_somatic``
(reference somatic_sniper.c:109-273).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import GERMLINE, LOH, SOMATIC, UNKNOWN, WILDTYPE
from .allele_util import (
    genotype_is_proper_subset,
    should_filter_as_gor,
    should_filter_as_loh,
)
from .consensus import (
    glf2cns_batch,
    make_qadd,
    somatic_score_batch,
)
from .glfgen import ColumnBatch, glfgen_batch
from .tables import ModelTables

I32 = jnp.int32
F32 = jnp.float32


class CallResult(NamedTuple):
    """Per-column call record (device output, host formats the text)."""

    emit: jax.Array            # [B] bool — site passes all gates
    tumor_gt: jax.Array        # [B] tumor consensus genotype (4-bit set)
    normal_gt: jax.Array       # [B] normal consensus genotype
    tumor_cnsq: jax.Array      # [B] tumor consensus quality (GQ)
    normal_cnsq: jax.Array     # [B]
    tumor_vaq: jax.Array       # [B] tumor variant allele quality
    normal_vaq: jax.Array      # [B]
    somatic_score: jax.Array   # [B] phred P(gt_T != gt_N)
    joint_tumor_gt: jax.Array  # [B] joint-mode genotype (0 if solo mode)
    joint_normal_gt: jax.Array
    joint_cnsq: jax.Array      # [B]
    tumor_status: jax.Array    # [B] variant_status_t
    normal_status: jax.Array   # [B]
    tumor_eff_gt: jax.Array    # [B] joint-aware genotype (wanted-base calc)
    normal_eff_gt: jax.Array
    tumor_depth: jax.Array     # [B] glf depth (non-del reads)
    normal_depth: jax.Array
    # [B, 18] i32 per-sample dqstats rows (output.dqstats layout), only
    # when the batch carries raw u32 lanes (the slab path); None keeps
    # the legacy encodings' trace unchanged
    tumor_dq: jax.Array | None = None
    normal_dq: jax.Array | None = None


def _mean_499(s, o):
    """Exact integer ``(int)(sum/occ + 0.499)`` (reference dqstats.c)
    without trusting f32 division at the boundary: the result is the
    largest k with ``(1000k - 499) * occ <= 1000 * sum``, and the f32
    estimate is within +/-1 of it (sums <= 255*255 here), so one
    integer-predicate fixup each way restores bit-exactness."""
    o1 = jnp.maximum(o, 1)
    k0 = (s.astype(F32) / o1.astype(F32) + F32(0.499)).astype(I32)

    def ok(k):
        return (1000 * k - 499) * o1 <= 1000 * s

    k = jnp.where(ok(k0 + 1), k0 + 1, jnp.where(ok(k0), k0, k0 - 1))
    return jnp.where(o > 0, k, 0)


def _device_dqstats(slots, n_keep, rb4, wanted):
    """[B, 18] i32 dqstats rows over raw kept-only u32 lanes.

    Bit-exact replication of output.dqstats.get_dqstats_rows (itself the
    replication of reference dqstats.c:6-53) for device-scored columns:
    every sum is exact i32 arithmetic over <= D <= 255 lanes, and the
    +0.499 means use the integer-predicate rounding of :func:`_mean_499`.
    Quirks preserved: raw base codes (no reference substitution — a '='
    base is 0, never reference-equal, and its ``(b & v) == b`` test
    increments all four base_occ counters); mean fields are zeroed for
    un-wanted bases by zeroing their sums."""
    B, D = slots.shape
    s = slots.astype(I32)  # packed bits < 2^21
    j_idx = jax.lax.broadcasted_iota(I32, (B, D), 1)
    valid = j_idx < n_keep[:, None]
    mq = jnp.where(valid, s & 0xFF, 0)
    bq = jnp.where(valid, (s >> 8) & 0xFF, 0)
    b = (s >> 16) & 0xF
    st = (s >> 20) & 1

    depth = n_keep.astype(I32)
    tot_mq = mq.sum(axis=1)
    is_ref = valid & (b == rb4[:, None])
    not_ref = valid & (b != rb4[:, None])
    zeros = jnp.zeros((B, D), I32)
    ones = jnp.ones((B, D), I32)
    dp4 = [
        jnp.where(is_ref & (st == 0), ones, zeros).sum(axis=1),
        jnp.where(is_ref & (st == 1), ones, zeros).sum(axis=1),
        jnp.where(not_ref & (st == 0), ones, zeros).sum(axis=1),
        jnp.where(not_ref & (st == 1), ones, zeros).sum(axis=1),
    ]
    occ, mean_bq, mean_mq = [], [], []
    for j in range(4):
        v = 1 << j
        m = valid & ((b & v) == b)
        o = jnp.where(m, ones, zeros).sum(axis=1)
        w = ((wanted & v) != 0).astype(I32)
        sb = jnp.where(m, bq, zeros).sum(axis=1) * w
        sm = jnp.where(m, mq, zeros).sum(axis=1) * w
        occ.append(o)
        mean_bq.append(_mean_499(sb, o))
        mean_mq.append(_mean_499(sm, o))
    tot_mean = _mean_499(tot_mq, depth)
    return jnp.stack(
        mean_bq + mean_mq + occ + dp4 + [depth, tot_mean], axis=1
    )


_proper_subset = genotype_is_proper_subset


@partial(
    jax.jit,
    static_argnames=(
        "precision", "use_joint", "cap_mapq", "theta", "eta", "dq",
    ),
)
def call_batch(
    tumor: ColumnBatch,
    normal: ColumnBatch,
    fk64,
    coef64,
    lhet64,
    solo_prior,
    joint_prior,
    qadd_table,
    q_r_int: int,
    precision: str = "exact",
    use_joint: bool = False,
    min_somatic_qual: int = 15,
    include_loh: bool = True,
    include_gor: bool = True,
    cap_mapq: int = 60,
    theta: float = 0.85,
    eta: float = 0.03,
    dq: bool = False,
) -> CallResult:
    """Batched glf_somatic (reference somatic_sniper.c:109-273).

    ``tumor.depth``/``normal.depth`` are the raw column depths including
    deleted bases (the ``n1``/``n2`` arguments of the reference callback).

    Note the reference's outer ``rb != 'N'`` character gate (line 127) is
    subsumed by the ``rb4 != 15`` code gate below: every character whose
    4-bit code is 15 (including 'N'/'n') fails the code gate, and nothing
    inside the outer block emits without passing it.
    """
    g_t = glfgen_batch(tumor, fk64, coef64, lhet64, precision=precision,
                       cap_mapq=cap_mapq, theta=theta, eta=eta)
    g_n = glfgen_batch(normal, fk64, coef64, lhet64, precision=precision,
                       cap_mapq=cap_mapq, theta=theta, eta=eta)

    cns_t = glf2cns_batch(g_t.lk, tumor.depth, q_r_int)
    cns_n = glf2cns_batch(g_n.lk, normal.depth, q_r_int)
    ref16 = tumor.ref16

    t_b1, t_b2, t_s1, t_s2 = cns_t
    n_b1, n_b2, n_s1, n_s2 = cns_n

    rb4 = ref16

    # outer gate (reference somatic_sniper.c:127) + SNP gate (:156)
    is_snp = (
        (g_t.depth > 0)
        & (g_n.depth > 0)
        & (rb4 != 15)
        & (t_b1 != 15)
        & (n_b1 != 15)
        & (t_b1 != n_b1)
    )

    tumor_snp_q = jnp.minimum(
        jnp.where(t_b2 == rb4, t_s1, t_s1 + t_s2), 255
    )
    normal_snp_q = jnp.where(
        (n_b1 != 15) & (n_b1 != rb4),
        jnp.minimum(jnp.where(n_b2 == rb4, n_s1, n_s1 + n_s2), 255),
        0,
    )

    qadd = make_qadd(qadd_table)
    score = somatic_score_batch(
        g_t.lk, g_n.lk, rb4, solo_prior, joint_prior, qadd, use_joint
    )
    qps = score.q_posterior_sum

    # joint-aware effective genotypes (reference somatic_sniper.c:216-223;
    # the truthiness test on the glfBase value means joint mode always
    # overrides, solo mode never does)
    tumor_eff = jnp.where(score.joint_tumor_gt != 0, score.joint_tumor_gt, t_b1)
    normal_eff = jnp.where(
        score.joint_normal_gt != 0, score.joint_normal_gt, n_b1
    )

    loh_filter = should_filter_as_loh(rb4, tumor_eff, normal_eff)
    gor_filter = should_filter_as_gor(rb4, tumor_eff, normal_eff)
    emit = (
        is_snp
        & (min_somatic_qual <= qps)
        & (include_loh | ~loh_filter)
        & (include_gor | ~gor_filter)
    )

    # statuses (reference somatic_sniper.c:241-261)
    t_status = jnp.where(
        tumor_eff == normal_eff,
        GERMLINE,
        jnp.where(
            _proper_subset(tumor_eff, normal_eff),
            LOH,
            jnp.where(qps > 0, SOMATIC, UNKNOWN),
        ),
    ).astype(I32)
    n_status = jnp.where(n_b1 == rb4, WILDTYPE, GERMLINE).astype(I32)

    dq_t = dq_n = None
    if dq:
        # dqstats on-device: with raw u32 lanes in the slab the device
        # computes these 18 fields bit-exactly and they ride home in the
        # compact rows — no host pileup walk for device-scored columns
        assert tumor.n_keep is not None and \
            tumor.slots.dtype == jnp.uint32, (
                "dq=True requires raw u32 kept-only lanes"
            )
        wanted = rb4 | tumor_eff | normal_eff
        dq_t = _device_dqstats(tumor.slots, tumor.n_keep, rb4, wanted)
        dq_n = _device_dqstats(normal.slots, normal.n_keep, rb4, wanted)

    return CallResult(
        emit=emit,
        tumor_gt=t_b1,
        normal_gt=n_b1,
        tumor_cnsq=t_s1,
        normal_cnsq=n_s1,
        tumor_vaq=tumor_snp_q,
        normal_vaq=normal_snp_q,
        somatic_score=qps,
        joint_tumor_gt=score.joint_tumor_gt,
        joint_normal_gt=score.joint_normal_gt,
        joint_cnsq=score.joint_consensus_quality,
        tumor_status=t_status,
        normal_status=n_status,
        tumor_eff_gt=tumor_eff,
        normal_eff_gt=normal_eff,
        tumor_depth=g_t.depth,
        normal_depth=g_n.depth,
        tumor_dq=dq_t,
        normal_dq=dq_n,
    )


# host-side field order of the compacted row matrix; leading column is the
# original batch index of each emitted site
COMPACT_FIELDS = (
    "tumor_gt", "normal_gt", "tumor_cnsq", "normal_cnsq",
    "tumor_vaq", "normal_vaq", "somatic_score",
    "joint_tumor_gt", "joint_normal_gt", "joint_cnsq",
    "tumor_status", "normal_status", "tumor_eff_gt", "normal_eff_gt",
    "tumor_depth", "normal_depth",
)


class CompactResult(NamedTuple):
    """Emitted-rows-only call result.

    Emitted sites are a small fraction of columns, so gathering them on
    device shrinks the result transfer by 10-100x.

    With ``row_dtype="u8"`` (the slab path), ``rows`` is
    ``[K, 2 + len(COMPACT_FIELDS)] uint8`` — batch index split into
    lo/hi bytes in columns 0/1, every field byte-narrow (all call fields
    are <= 255 whenever the padded depth is <= 255) — a further ~3.8x
    cut of the result-fetch bytes.
    """

    count: jax.Array  # [] int32 — number of emitted sites (may exceed K)
    rows: jax.Array   # [K, 1 + NF] int32, or [K, 2 + NF] uint8


@partial(
    jax.jit,
    static_argnames=(
        "precision", "use_joint", "cap_mapq", "theta", "eta", "max_emit",
        "row_dtype", "dq",
    ),
)
def call_batch_compact(
    tumor: ColumnBatch,
    normal: ColumnBatch,
    fk64,
    coef64,
    lhet64,
    solo_prior,
    joint_prior,
    qadd_table,
    q_r_int: int,
    precision: str = "exact",
    use_joint: bool = False,
    min_somatic_qual: int = 15,
    include_loh: bool = True,
    include_gor: bool = True,
    cap_mapq: int = 60,
    theta: float = 0.85,
    eta: float = 0.03,
    max_emit: int = 16384,
    row_dtype: str = "i32",
    dq: bool = False,
) -> CompactResult:
    """call_batch + on-device compaction of the emitted rows.

    ``count`` can exceed ``max_emit``; callers must fall back to the full
    call_batch in that (pathological) case.  ``row_dtype="u8"`` selects
    the byte-narrow row layout (see CompactResult); only valid when the
    padded depth is <= 255 and max_emit <= 65536.  With ``dq`` the rows
    additionally carry the 36 per-sample dqstats fields (tumor 18 then
    normal 18) — byte-safe on device columns since every field is
    bounded by the padded depth or 255.
    """
    res = call_batch(
        tumor, normal, fk64, coef64, lhet64, solo_prior, joint_prior,
        qadd_table, q_r_int, precision=precision, use_joint=use_joint,
        min_somatic_qual=min_somatic_qual, include_loh=include_loh,
        include_gor=include_gor, cap_mapq=cap_mapq, theta=theta, eta=eta,
        dq=dq,
    )
    K = min(max_emit, res.emit.shape[0])
    idx = jnp.nonzero(res.emit, size=K, fill_value=0)[0].astype(I32)
    dq_cols = []
    if dq:
        dq_cols = [
            jnp.take(res.tumor_dq, idx, axis=0),
            jnp.take(res.normal_dq, idx, axis=0),
        ]  # two [K, 18] blocks
    if row_dtype == "u8":
        # the lo/hi byte index split caps the batch axis at 2^16; a
        # larger B would silently attribute emitted rows to the wrong
        # columns (shapes are static, so this is a trace-time check)
        assert res.emit.shape[0] <= 65536, (
            f"row_dtype='u8' requires B <= 65536, got {res.emit.shape[0]}"
        )
        u8 = jnp.uint8
        cols = [
            (idx & 0xFF).astype(u8)[:, None], (idx >> 8).astype(u8)[:, None],
        ] + [
            jnp.take(getattr(res, f), idx, axis=0).astype(u8)[:, None]
            for f in COMPACT_FIELDS
        ] + [d.astype(u8) for d in dq_cols]
        rows = jnp.concatenate(cols, axis=1)
    else:
        cols = [idx[:, None]] + [
            jnp.take(getattr(res, f), idx, axis=0).astype(I32)[:, None]
            for f in COMPACT_FIELDS
        ] + [d.astype(I32) for d in dq_cols]
        rows = jnp.concatenate(cols, axis=1)
    return CompactResult(count=res.emit.sum().astype(I32), rows=rows)


@partial(
    jax.jit,
    static_argnames=(
        "use_joint", "cap_mapq", "theta", "eta", "max_emit", "row_dtype",
    ),
)
def call_batch_packed(
    stacked,
    meta,
    fk64,
    coef64,
    lhet64,
    solo_prior,
    joint_prior,
    qadd_table,
    q_r_int: int,
    use_joint: bool = False,
    min_somatic_qual: int = 15,
    include_loh: bool = True,
    include_gor: bool = True,
    cap_mapq: int = 60,
    theta: float = 0.85,
    eta: float = 0.03,
    max_emit: int = 16384,
    row_dtype: str = "i32",
) -> CompactResult:
    """Fast-path entry over bit-packed inputs (D <= 255 depth buckets).

    Two slab lane encodings, discriminated by ``stacked.dtype``:

    * **u32 raw (production)** — each lane is the raw slot word of a
      KEPT (non-deleted) read, ``mapQ | baseQ<<8 | base16<<16 |
      strand<<20`` (base16 unsubstituted: '=' stays 0).  The kernel
      derives eff-quality/classes itself, computes rms on-device, and
      emits the 36 dqstats fields in the rows (``dq``) — the host-side
      slab fill is a pure filtered copy of pileup slots.
      ``meta[0] = ref16 << 24``, ``meta[1]`` unused.
    * **u16 compact (legacy/tests)** — ``effq | base2<<8 | strand<<10``
      with host-computed rms riding in the metadata:
      ``meta[0] = rms_sum_tumor | ref16 << 24`` (rms < 255*255^2 < 2^24
      whenever D <= 255), ``meta[1] = rms_sum_normal``.

    Always: ``meta[2] = d_t | d_n << 8 | nk_t << 16 | nk_n << 24`` (all
    <= D).  12 B/column of metadata instead of the 28 B of the
    row-per-field layout.
    Unpacking happens inside the jit (free fusion); ``meta[2] >> 24``
    is an arithmetic shift but the ``& 0xFF`` mask recovers the
    unsigned byte.
    """
    # the packed metadata layout dies above D = 255 (byte depth/count
    # fields, 24-bit rms) — checked here at trace time so an out-of-
    # bounds SNIPER_SLAB_D override fails loudly instead of corrupting
    assert stacked.shape[2] <= 255, (
        f"packed metadata requires D <= 255, got {stacked.shape[2]}"
    )
    raw32 = stacked.dtype == jnp.uint32
    ref16 = (meta[0] >> 24) & 0xF
    d_t = meta[2] & 0xFF
    d_n = (meta[2] >> 8) & 0xFF
    nk_t = (meta[2] >> 16) & 0xFF
    nk_n = (meta[2] >> 24) & 0xFF
    if raw32:
        cb_t = ColumnBatch(slots=stacked[0], depth=d_t, ref16=ref16,
                           n_keep=nk_t)
        cb_n = ColumnBatch(slots=stacked[1], depth=d_n, ref16=ref16,
                           n_keep=nk_n)
    else:
        rms_t = meta[0] & 0xFFFFFF
        rms_n = meta[1]
        cb_t = ColumnBatch(slots=stacked[0], depth=d_t, ref16=ref16,
                           n_keep=nk_t, rms_sum=rms_t)
        cb_n = ColumnBatch(slots=stacked[1], depth=d_n, ref16=ref16,
                           n_keep=nk_n, rms_sum=rms_n)
    return call_batch_compact(
        cb_t, cb_n, fk64, coef64, lhet64, solo_prior, joint_prior,
        qadd_table, q_r_int, precision="fast", use_joint=use_joint,
        min_somatic_qual=min_somatic_qual, include_loh=include_loh,
        include_gor=include_gor, cap_mapq=cap_mapq, theta=theta, eta=eta,
        max_emit=max_emit, row_dtype=row_dtype, dq=raw32,
    )


@partial(
    jax.jit,
    static_argnames=(
        "precision", "use_joint", "cap_mapq", "theta", "eta", "max_emit",
        "packed16", "compact",
    ),
)
def call_batch_stacked(
    stacked,
    meta,
    fk64,
    coef64,
    lhet64,
    solo_prior,
    joint_prior,
    qadd_table,
    q_r_int: int,
    precision: str = "exact",
    use_joint: bool = False,
    min_somatic_qual: int = 15,
    include_loh: bool = True,
    include_gor: bool = True,
    cap_mapq: int = 60,
    theta: float = 0.85,
    eta: float = 0.03,
    max_emit: int = 16384,
    packed16: bool = False,
    compact: bool = True,
):
    """call_batch(_compact) over the stacked upload layout.

    ``stacked`` is [2, B, D] (tumor, normal slots); ``meta`` is the
    row-per-field metadata block ([7, B] for packed16 batches, [3, B]
    otherwise).  Unpacking happens inside the jit: indexing sharded
    device arrays eagerly compiles one tiny gather per row and runs it
    on the mesh outside any jit — wasteful, and the only crash site the
    CPU-backend suite ever produced.  Here XLA fuses the unpack into
    the kernel for free.
    """
    if packed16:
        cb_t = ColumnBatch(slots=stacked[0], depth=meta[0], ref16=meta[2],
                           n_keep=meta[3], rms_sum=meta[5])
        cb_n = ColumnBatch(slots=stacked[1], depth=meta[1], ref16=meta[2],
                           n_keep=meta[4], rms_sum=meta[6])
    else:
        cb_t = ColumnBatch(slots=stacked[0], depth=meta[0], ref16=meta[2])
        cb_n = ColumnBatch(slots=stacked[1], depth=meta[1], ref16=meta[2])
    common = dict(
        precision=precision, use_joint=use_joint,
        min_somatic_qual=min_somatic_qual, include_loh=include_loh,
        include_gor=include_gor, cap_mapq=cap_mapq, theta=theta, eta=eta,
    )
    if compact:
        return call_batch_compact(
            cb_t, cb_n, fk64, coef64, lhet64, solo_prior, joint_prior,
            qadd_table, q_r_int, max_emit=max_emit, **common,
        )
    return call_batch(
        cb_t, cb_n, fk64, coef64, lhet64, solo_prior, joint_prior,
        qadd_table, q_r_int, **common,
    )
