"""Retrieval routing. ``evaluate_retrieval`` comes with the inference slice.

Counterpart of ``art_sbir_tpu/retrieval/rank.py``."""

# Gallery rows from which the serving engine streams each batch through
# the fused kernel K1 instead of materializing a (B, N) distance matrix.
# This is the JAX package's rule, located on a TPU v5e (the fused kernel
# never lost there from 50k rows up), kept as is so that both packages
# take the same route. The H100 crossover is still to be measured.
FUSED_GALLERY_THRESHOLD = 50_000
