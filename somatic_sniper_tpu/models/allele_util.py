"""Genotype set algebra on 4-bit allele sets (A=1, C=2, G=4, T=8).

Array counterpart of the reference's allele_util module
(reference src/lib/sniper/allele_util.h:22-37, allele_util.c:6-29):
every predicate is an elementwise array expression, usable on numpy
and jax arrays alike (and inside jit), instead of per-site C macros.
"""

from __future__ import annotations


def genotype_intersection(a, b):
    """Alleles a and b share (reference allele_util.h:23)."""
    return a & b


def genotype_is_proper_subset(a, b):
    """a ⊊ b on allele sets (reference allele_util.h:26-27)."""
    return (b != a) & ((a & b) == a)


def genotype_set_difference(a, b):
    """a ∖ b (reference allele_util.h:30)."""
    return a & ~b


# Domain alias: loss of heterozygosity (reference allele_util.h:35).
is_loh = genotype_is_proper_subset


def count_alleles(a):
    """Population count of the 4-bit set (reference allele_util.c:6-8)."""
    return (a & 1) + ((a >> 1) & 1) + ((a >> 2) & 1) + ((a >> 3) & 1)


def should_filter_as_loh(ref_base, tumor_genotype, normal_genotype):
    """Tumor lost allele(s) present in the normal (reference
    allele_util.c:19-22).  ``ref_base`` is unused, kept for signature
    parity with the reference."""
    del ref_base
    return genotype_is_proper_subset(tumor_genotype, normal_genotype)


def should_filter_as_gor(ref_base, tumor_genotype, normal_genotype):
    """Gain-of-reference: the normal is homozygous variant and the
    tumor's novel alleles are exactly the reference allele (reference
    allele_util.c:25-29)."""
    not_subset = genotype_is_proper_subset(ref_base, normal_genotype) == False  # noqa: E712 — elementwise negation, works for scalars and arrays
    return not_subset & (
        genotype_set_difference(tumor_genotype, normal_genotype) == ref_base
    )
