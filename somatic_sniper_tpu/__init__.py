"""somatic_sniper_tpu — a tumor/normal somatic SNV caller on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
genome/somatic-sniper: the MAQ consensus genotype-likelihood model and the
joint diploid-genotype somatic score evaluated as dense batched kernels
over pileup-column tensors, fed by a streaming host-side BAM reader, with
genome-region sharding across device meshes.
"""

__version__ = "0.1.0"
