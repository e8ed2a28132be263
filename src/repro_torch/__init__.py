"""PyTorch/CUDA port of the TileLink reproduction (``src/repro`` is the JAX reference).

The package mirrors ``src/repro`` file for file where a module is ported.
It imports ``torch`` and never ``jax`` or the JAX package.  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""
