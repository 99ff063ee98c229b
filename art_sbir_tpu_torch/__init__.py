"""PyTorch / CUDA port of art_sbir_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (``ops/``, ``models/``, ``retrieval/``,
``cli/``, ``core/``, ``data/``, ``train/``) so each module's counterpart
is found by path. Imports torch, numpy and the standard library only;
PIL is imported lazily inside the decode functions. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
