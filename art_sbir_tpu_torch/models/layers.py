"""Shared building-block constants with torch-parity semantics.

Counterpart of ``art_sbir_tpu/models/layers.py`` (the part the encoder
uses)."""

# BatchNorm running-stat momentum of the whole model zoo. torch's momentum
# is the weight of the NEW batch statistic; flax's ``BN_MOMENTUM = 0.9``
# is the weight of the OLD running value. The two describe the same update.
BN_MOMENTUM = 0.1
