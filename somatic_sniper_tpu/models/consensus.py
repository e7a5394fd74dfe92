"""Consensus calling and somatic scoring — exact integer phred arithmetic.

Everything downstream of glfgen in the reference is integer math:

* ``sniper_glf2cns``       (reference sniper_maqcns.c:250-273)
* ``calculatePosteriors``  (reference somatic_sniper.c:79-99)
* solo / joint somatic score (reference somatic_sniper.c:109-273)

These are replicated here as batched int32 JAX ops, including the
reference's exact tie-breaking scan orders and its stale-``i`` quirk in the
joint-mode consensus-quality loop (somatic_sniper.c:193-199, where ``i`` is
always 10 after the marginal loop so the guard reduces to
``j != max_jointlk_tumor_index``).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GLF_BASE

I32 = jnp.int32


class ConsensusCall(NamedTuple):
    """Unpacked fields of the reference's packed consensus word
    (cns<<28 | cns2<<24 | mapQ<<16 | cnsQ<<8 | cnsQ2,
    reference sniper_maqcns.h:28)."""

    base1: jax.Array   # [B] best genotype, 4-bit allele set
    base2: jax.Array   # [B] second-best genotype
    score1: jax.Array  # [B] consensus quality (min2 - min)
    score2: jax.Array  # [B] second consensus quality (min3 - min2)


def glf2cns_batch(lk, n_total, q_r_int) -> ConsensusCall:
    """Batched sniper_glf2cns + the n==0 guard of sniper_maqcns_call.

    lk: [B, 10] int32, n_total: [B] total pileup depth (including deleted
    bases; reference passes the raw column count n).  Returns unpacked
    int32 fields — the reference's u32 bit-packing is a C artifact, not
    part of the model.
    """
    # The reference scans the 10 valid entries of tmp[16] in linear-index
    # order, keeping the 3 smallest with strict-< comparisons (first index
    # wins; sniper_maqcns.c:252-266).  Linear order over the upper triangle
    # is exactly the lk order, so the scan is equivalent to three masked
    # argmins over [B, 10]: argmin returns the first minimum, and masking
    # prior winners reproduces the scan's tie behaviour for min2/min3.
    qr_vec = np.full(10, 1, np.int32)
    qr_vec[[0, 4, 7, 9]] = 0  # homozygous slots get no het penalty
    t = lk + jnp.asarray(qr_vec) * q_r_int  # [B, 10]

    BIG = jnp.int32(1 << 20)
    i1 = jnp.argmin(t, axis=1).astype(I32)
    m1 = jnp.min(t, axis=1)
    t2 = t + jax.nn.one_hot(i1, 10, dtype=I32) * BIG
    i2 = jnp.argmin(t2, axis=1).astype(I32)
    m2 = jnp.min(t2, axis=1)
    t3 = t2 + jax.nn.one_hot(i2, 10, dtype=I32) * BIG
    m3 = jnp.min(t3, axis=1)

    # the genotype bit-set of slot c is glfBase[c] by construction
    cns1 = _select_scalar(GLF_BASE, i1)
    cns2 = _select_scalar(GLF_BASE, i2)
    q1 = jnp.minimum(m2 - m1, 255)
    q2 = jnp.minimum(m3 - m2, 255)

    # reference sniper_maqcns.c:275-282: n == 0 -> 0xf<<28 | 0xf<<24
    nz = n_total > 0
    return ConsensusCall(
        base1=jnp.where(nz, cns1, 0xF).astype(I32),
        base2=jnp.where(nz, cns2, 0xF).astype(I32),
        score1=jnp.where(nz, q1, 0).astype(I32),
        score2=jnp.where(nz, q2, 0).astype(I32),
    )


def make_qadd(qadd_table=None):
    """Return the batched qAdd op (reference somatic_sniper.c:13-18).

    qAdd(x, y) = x + qAddTable[512 + y - x].  The 1024-entry table has a
    closed integer form (verified bit-exact against the generated table in
    tests): with d = clip(y - x, -512, 511),

        qAdd(x, y) = x + min(d, 0) - (|d|<2) - (|d|<4) - (|d|<10)

    because qAddTable[512+d] = S(|d|) + min(d, 0) where S steps through
    -3/-2/-1/0 at |d| = 2, 4, 10 (phred-space logsumexp correction), and
    the zero entries at indices >= 1000 coincide with S = 0.  This keeps
    the score pipeline elementwise, so XLA fuses it into a few kernels.
    The clip mirrors the bounds-guard of the table variant (the reference
    would read out of bounds there; unreachable for well-formed inputs).
    """

    def qadd(x, y):
        d = jnp.clip(y - x, -512, 511)
        a = jnp.abs(d)
        corr = (
            (a < 2).astype(I32) + (a < 4).astype(I32) + (a < 10).astype(I32)
        )
        return x + jnp.minimum(d, 0) - corr

    return qadd


def posteriors_batch(lk, ref16, solo_prior, qadd):
    """Batched calculatePosteriors (reference somatic_sniper.c:79-99).

    lk: [B,10] i32, ref16: [B] i32.  Returns lkResult [B,10] i32.
    """
    prior = _row_select(solo_prior, ref16)  # [B,10]
    x = lk + prior
    qsum = jnp.full(x.shape[:1], 255, I32)
    for j in range(10):
        qsum = qadd(x[:, j], qsum)  # qAdd(x, qSum): note argument order
    res = jnp.minimum(x - qsum[:, None], 255)
    return res


def _row_select(table, idx):
    """``table[idx]``: one row of a small per-reference-base table per
    column (a gather; [B] indices -> [B, ...] rows)."""
    return jnp.asarray(table)[idx]


def _select_scalar(values, idx):
    """values[idx] for a tiny 1-D int table via unrolled selects."""
    v = np.asarray(values)
    out = jnp.zeros(idx.shape, I32)
    for k in range(len(v)):
        out = jnp.where(idx == k, int(v[k]), out)
    return out


class SomaticScore(NamedTuple):
    q_posterior_sum: jax.Array   # [B] somatic score
    joint_tumor_gt: jax.Array    # [B] 4-bit set, 0 unless joint mode
    joint_normal_gt: jax.Array   # [B]
    joint_consensus_quality: jax.Array  # [B]


def somatic_score_batch(
    lk_tumor,
    lk_normal,
    ref16,
    solo_prior,
    joint_prior,
    qadd,
    use_joint: bool,
):
    """The somatic-score core (reference somatic_sniper.c:166-214)."""
    B = lk_tumor.shape[0]
    if use_joint:
        jp = _row_select(joint_prior, ref16)                  # [B,10,10]
        joint_lk = jnp.minimum(
            lk_normal[:, :, None] + lk_tumor[:, None, :] + jp, 255
        )  # [B,10,10], i = normal, j = tumor
        flat = joint_lk.reshape(B, 100)

        # the reference's row-major strict-< argmin scan == jnp.argmin
        # (first minimum wins) over the row-major flattening
        best_idx = jnp.argmin(flat, axis=1).astype(I32)
        ni = best_idx // 10
        tj = best_idx % 10

        # marginal: sequential 100-step qAdd fold, unrolled (each step is
        # a handful of elementwise ops thanks to the arithmetic qAdd)
        marginal = jnp.full((B,), 255, I32)
        for t in range(100):
            marginal = qadd(marginal, flat[:, t])

        qps = jnp.full((B,), 255, I32)
        jcq = jnp.full((B,), 255, I32)
        for j in range(10):
            lkv = joint_lk[:, j, j] - marginal
            qps = qadd(qps, lkv)
            # stale-i quirk: guard is effectively only j != tumor argmin
            upd = j != tj
            jcq = jnp.where(upd, qadd(jcq, lkv), jcq)
        jcq = jnp.minimum(jcq, 255)
        return SomaticScore(
            q_posterior_sum=qps,
            joint_tumor_gt=_select_scalar(GLF_BASE, tj),
            joint_normal_gt=_select_scalar(GLF_BASE, ni),
            joint_consensus_quality=jcq,
        )
    else:
        lk_t_post = posteriors_batch(lk_tumor, ref16, solo_prior, qadd)
        lk_n_post = posteriors_batch(lk_normal, ref16, solo_prior, qadd)
        qps = jnp.full((B,), 255, I32)
        for j in range(10):
            qps = qadd(qps, lk_t_post[:, j] + lk_n_post[:, j])
        zero = jnp.zeros((B,), I32)
        return SomaticScore(
            q_posterior_sum=qps,
            joint_tumor_gt=zero,
            joint_normal_gt=zero,
            joint_consensus_quality=jnp.full((B,), 255, I32),
        )
